"""Bitstream packaging + the two build flows (paper §4, §9.2, §9.3).

Twin of ``repro.core.reconfig``.  A "partial bitstream" here is a
serialized artifact blob in the safe npz+JSON container of
:mod:`repro_torch.core.bitstream` (magic ``CYBS``,
versioned header, no pickle): the shell config (for shell bitstreams) or
an app artifact with its weights (for app bitstreams).
``ReconfigController.load_bitstream`` streams them from disk through the
utility channel; :class:`repro_torch.core.shell.Shell` applies them —
``Shell.reconfigure(slot, path)`` performs the drain-aware hot-swap.

Weight trees may hold tensors (on any device) or numpy arrays.  numpy has
no bfloat16, so a bf16 tensor is stored as its int16 bits under a
``{"__bfloat16_bits__": ...}`` tag and comes back as a bf16 tensor on the
host; it is never upcast.
"""
from __future__ import annotations

import importlib
import time
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from repro_torch.core import bitstream as B
from repro_torch.core.bitstream import BitstreamError
from repro_torch.core.port import PortCapabilities
from repro_torch.core.services.base import ServiceRequirement
from repro_torch.core.shell import SERVICE_TYPES, Shell, ShellConfig
from repro_torch.core.vfpga import AppArtifact

BF16_TAG = "__bfloat16_bits__"


# ------------------------------------------------------- weight trees ----
def _to_host(x: Any) -> Any:
    """One leaf of a weight tree -> numpy (bf16 as tagged int16 bits)."""
    if x is None:
        return None
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        return {BF16_TAG: x.view(torch.int16).numpy()}
    return x.numpy()


def weights_to_host(tree: Any) -> Any:
    return pytree.tree_map(_to_host, tree)


def weights_from_host(tree: Any) -> Any:
    """Inverse of :func:`weights_to_host`: tagged bf16 bits become bf16
    tensors; every other leaf stays the numpy array it was stored as."""
    if isinstance(tree, dict):
        if set(tree) == {BF16_TAG}:
            return torch.from_numpy(np.asarray(tree[BF16_TAG])).view(
                torch.bfloat16)
        return {k: weights_from_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(weights_from_host(v) for v in tree)
    return tree


# ------------------------------------------------------- config codecs ----
def _encode_shell_config(config: ShellConfig) -> Dict[str, Any]:
    d = asdict(config)
    d["services"] = [{"name": name, "config": B.jsonable(asdict(cfg))
                      if hasattr(cfg, "__dataclass_fields__")
                      else B.jsonable(cfg)}
                     for name, cfg in config.services]
    return d


def _decode_shell_config(d: Dict[str, Any]) -> ShellConfig:
    services = {}
    for entry in d.get("services", ()):
        name = entry["name"]
        if name not in SERVICE_TYPES:
            raise BitstreamError(
                f"shell bitstream names unknown service {name!r} "
                f"(known: {sorted(SERVICE_TYPES)})")
        _cls, cfg_cls = SERVICE_TYPES[name]
        cfg = entry["config"]
        services[name] = (cfg_cls(**cfg) if isinstance(cfg, dict) else cfg)
    kw = {k: v for k, v in d.items() if k != "services"}
    kw["hbm_budget"] = int(kw.get("hbm_budget", 1 << 32))
    return ShellConfig.make(services=services, **kw)


# ----------------------------------------------------------- shell side ----
def save_shell_bitstream(path: str, config: ShellConfig,
                         weights: Any = None) -> int:
    """Write a shell 'partial bitstream' (config + optional weight arrays)
    in the safe versioned container."""
    arrays = None
    if weights is not None:
        arrays = weights_to_host(weights)
    blob = B.encode("shell", {"config": _encode_shell_config(config)},
                    arrays=arrays)
    Path(path).write_bytes(blob)
    return len(blob)


def load_shell_bitstream(path: str) -> Tuple[ShellConfig, Any]:
    """Parse a shell bitstream -> (ShellConfig, weight arrays or None).
    Unknown kind/container version raise :class:`BitstreamError`."""
    _, header, arrays = B.decode(Path(path).read_bytes(),
                                 expect_kind="shell")
    return _decode_shell_config(header["config"]), weights_from_host(arrays)


# ------------------------------------------------------------- app side ----
def save_app_bitstream(path: str, artifact: AppArtifact) -> int:
    """Write an app 'partial bitstream'.  The fn is stored by reference
    (module:qualname) — user logic is code, weights are data."""
    caps = artifact.capabilities
    header = {
        "name": artifact.name,
        "version": artifact.version,
        "fn_ref": f"{artifact.fn.__module__}:{artifact.fn.__qualname__}",
        "requires": [{"service": r.service,
                      "constraints": B.jsonable(r.constraints)}
                     for r in artifact.requires],
        "config_repr": B.jsonable(artifact.config_repr),
        "capabilities": caps.to_dict() if caps is not None else None,
    }
    arrays = (weights_to_host(artifact.weights)
              if artifact.weights is not None else None)
    blob = B.encode("app", header, arrays=arrays)
    Path(path).write_bytes(blob)
    return len(blob)


def load_app_bitstream(path: str) -> AppArtifact:
    _, header, arrays = B.decode(Path(path).read_bytes(), expect_kind="app")
    mod_name, qual = header["fn_ref"].split(":")
    fn = importlib.import_module(mod_name)
    for part in qual.split("."):
        fn = getattr(fn, part)
    caps = header.get("capabilities")
    return AppArtifact(
        name=header["name"], fn=fn,
        version=header.get("version", "0"),
        weights=weights_from_host(arrays),
        requires=[ServiceRequirement(r["service"], r["constraints"])
                  for r in header.get("requires", ())],
        config_repr=header.get("config_repr"),
        capabilities=PortCapabilities.from_dict(caps) if caps else None)


# --------------------------------------------------------- build flows ----
@dataclass
class FlowTiming:
    flow: str
    build_s: float
    components: Dict[str, Dict[str, float]]
    cache_hits: int


def shell_flow(config: ShellConfig, *, static=None, mesh=None
               ) -> Tuple[Shell, FlowTiming]:
    """Full flow: synthesize services AND slots from scratch."""
    shell = Shell(config, static=static, mesh=mesh)
    t0 = time.perf_counter()
    report = shell.build(flow="shell")
    dt = time.perf_counter() - t0
    return shell, FlowTiming("shell", dt, report.components,
                             report.cache_hits)


def app_flow(shell: Shell, slot: int, artifact: AppArtifact
             ) -> Tuple[Dict[str, float], FlowTiming]:
    """Nested flow: link ONE app against the already-routed shell.  The
    service artifacts hit the compile cache; only the app compiles."""
    t0 = time.perf_counter()
    stats = shell.load_app(slot, artifact)
    dt = time.perf_counter() - t0
    return stats, FlowTiming("app", dt, {artifact.name: stats},
                             int(stats.get("compile_cache_hit", 0)))
