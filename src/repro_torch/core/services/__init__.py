"""Dynamic-layer services of the port: reusable, reconfigurable shell
infrastructure (twin of ``repro.core.services``)."""
from repro_torch.core.services.base import (Service, ServiceRegistry,
                                            ServiceRequirement)
from repro_torch.core.services.collectives import (CollectiveConfig,
                                                   CollectiveService)
from repro_torch.core.services.compression import (CompressionConfig,
                                                   GradCompression)
from repro_torch.core.services.encryption import AESConfig, AESService
from repro_torch.core.services.mmu import MMU, MMUConfig, PageFaultError, TLB
from repro_torch.core.services.sniffer import SnifferConfig, TrafficSniffer

__all__ = [
    "Service", "ServiceRegistry", "ServiceRequirement",
    "CollectiveConfig", "CollectiveService",
    "CompressionConfig", "GradCompression",
    "AESConfig", "AESService",
    "MMU", "MMUConfig", "PageFaultError", "TLB",
    "SnifferConfig", "TrafficSniffer",
]
