"""Coyote core of the port: the paper's three-layer shell on PyTorch.

Twin of ``repro.core``.  Static layer (never reconfigured) / dynamic
layer (reconfigurable services) / application layer (vFPGA slots +
cThreads), with credit-based fair sharing, run-time reconfiguration, and
a unified multi-stream interface, and live tenant migration and in-place
recovery (``core/migrate.py``).
"""
from repro_torch.core.cthread import Alloc, CThread
from repro_torch.core.faults import (FaultKind, FaultPlan, FaultSpec,
                                     InjectedFault)
from repro_torch.core.health import HealthMonitor, Watchdog
from repro_torch.core.interfaces import (AppInterface, Completion, Oper,
                                         SgEntry)
from repro_torch.core.migrate import (MigrationError, MigrationReport,
                                      RecoveryReport, migrate,
                                      recover_tenant_local)
from repro_torch.core.port import (Invocation, Port, PortCapabilities,
                                   PortError, PortFuture, PortState,
                                   ServicePort, VFpgaPort)
from repro_torch.core.scheduler import ShellScheduler, Tenant
from repro_torch.core.shell import BuildReport, Shell, ShellConfig
from repro_torch.core.static_layer import (StaticLayer, TensorSpec,
                                           TransferEngine)
from repro_torch.core.vfpga import AppArtifact, VFpga

__all__ = [
    "Alloc", "CThread", "AppInterface", "Completion", "Oper", "SgEntry",
    "Invocation", "Port", "PortCapabilities", "PortError", "PortFuture",
    "PortState", "ServicePort", "VFpgaPort",
    "FaultKind", "FaultPlan", "FaultSpec", "InjectedFault",
    "HealthMonitor", "Watchdog",
    "BuildReport", "Shell", "ShellConfig", "ShellScheduler", "StaticLayer",
    "TensorSpec", "Tenant", "TransferEngine", "AppArtifact", "VFpga",
    "MigrationError", "MigrationReport", "RecoveryReport", "migrate",
    "recover_tenant_local",
]
