"""Neural-network inference app (paper §9.7, Fig 12) + the hls4ml-style
Overlay API (Code 3: <10 lines of Python to deploy and predict).

Twin of ``repro.apps.nn_inference``.  Two datapaths are compared,
mirroring the paper exactly:

  * **CoyoteAccelerator path** — weights pre-migrated to the card, inputs
    STREAMED host->vFPGA through the static layer's pinned ring (batch
    i+1's upload is issued while batch i computes), one sync per
    completed batch;
  * **staged-copy baseline (PYNQ/Vitis analogue)** — every batch is first
    copied host->card buffer, synchronized, then copied again on the card
    and fed to a separately issued compute call with per-call Python
    control.

The model is the line-rate network-intrusion-detection MLP the paper
deploys (unsw-nb15-ish: 593->64->64->1, quantized-friendly sizes).  The
port draws its weights from a ``torch.Generator`` (the reference's
``jax.random`` stream is not reproduced); :func:`mlp_from_reference`
carries the reference's weights over.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch.core.interfaces import Oper
from repro_torch.core.port import Invocation, PortCapabilities
from repro_torch.core.services.base import ServiceRequirement
from repro_torch.core.vfpga import AppArtifact
from repro_torch.device import resolve_device


CSR_NN_BATCH = 0x20               # serving batch size for the stream loop


@dataclass(frozen=True)
class MLPConfig:
    d_in: int = 593
    hidden: Tuple[int, ...] = (64, 64)
    d_out: int = 1


def init_mlp(generator: torch.Generator, cfg: MLPConfig = MLPConfig(), *,
             device="cpu") -> List[Dict[str, torch.Tensor]]:
    """Layers ``{"w": (d_i, d_{i+1}), "b": (d_{i+1},)}`` in float32, w
    drawn N(0, 1/d_i) on the generator's device, then moved to
    ``device``."""
    dims = (cfg.d_in,) + cfg.hidden + (cfg.d_out,)
    params = []
    for i in range(len(dims) - 1):
        w = torch.randn((dims[i], dims[i + 1]), generator=generator,
                        device=generator.device) / np.sqrt(dims[i])
        params.append({"w": w.to(device),
                       "b": torch.zeros((dims[i + 1],), device=device)})
    return params


def mlp_from_reference(layers, *, device=None
                       ) -> List[Dict[str, torch.Tensor]]:
    """The reference's ``init_mlp`` layers (a list of ``{"w", "b"}``
    numpy arrays) as float32 tensors on ``device`` (None: the CUDA card,
    as ``models.params.from_reference``)."""
    device = resolve_device(device)
    return [{k: torch.tensor(np.asarray(v, np.float32), device=device)
             for k, v in layer.items()} for layer in layers]


def mlp_apply(params, x):
    for i, layer in enumerate(params):
        x = x @ layer["w"] + layer["b"]
        if i < len(params) - 1:
            x = torch.relu(x)
    return x


class CoyoteOverlay:
    """The <10-lines-of-Python deployment API (paper Code 3)."""

    def __init__(self, shell, slot: int = 0,
                 cfg: MLPConfig = MLPConfig(), seed: int = 0):
        self.shell = shell
        self.slot = slot
        self.cfg = cfg
        self.params = init_mlp(torch.Generator().manual_seed(seed), cfg)
        self._port = None

    def program_fpga(self, *, warm_batch: int = 256) -> Dict[str, float]:
        """Load the NN as a vFPGA app (partial reconfiguration: the
        weights migrate to the slot's device) and warm it at the serving
        batch size."""
        art = make_nn_artifact(self)
        stats = self.shell.load_app(self.slot, art)
        vf = self.shell.vfpgas[self.slot]
        warm = torch.zeros((warm_batch, self.cfg.d_in),
                           device=vf.static.device)
        mlp_apply(vf.device_weights, warm).cpu()
        self._port = self.shell.attach(self.slot)
        vf.iface.csr.set_csr(warm_batch, CSR_NN_BATCH)
        return stats

    def _predict_dev(self, x):
        vf = self.shell.vfpgas[self.slot]
        return mlp_apply(vf.device_weights, x)

    def _predict_stream(self, iface, X: np.ndarray) -> np.ndarray:
        """The user logic's stream loop: batch i+1's upload is issued
        while batch i computes, one sync per completed batch."""
        batch_size = max(iface.csr.get_csr(CSR_NN_BATCH, 256), 1)
        vf = self.shell.vfpgas[self.slot]
        outs = []
        pending = None
        for xb in vf.static.engine.stream_rows(X, batch_size):
            y = self._predict_dev(xb)                  # queued on the card
            if pending is not None:
                outs.append(pending.cpu().numpy())     # sync previous
            pending = y
            vf.checkpoint()        # stream-batch preemption checkpoint
        if pending is not None:
            outs.append(pending.cpu().numpy())
        return np.concatenate(outs, axis=0)

    def predict(self, X: np.ndarray, out_shape=(1,),
                batch_size: int = 256) -> np.ndarray:
        """One KERNEL invocation through the unified port per predict
        call; the pipelined stream loop runs inside the app logic (the
        batch size is a CSR, like any other slot control knob)."""
        from repro_torch.core.interfaces import SgEntry
        vf = self.shell.vfpgas[self.slot]
        vf.iface.csr.set_csr(batch_size, CSR_NN_BATCH)
        comp = self._port.submit(Invocation.from_sg(SgEntry(
            src=X, length=int(X.nbytes),
            opcode=Oper.KERNEL))).result(timeout=120.0)
        if not comp.ok:
            raise comp.result
        return np.asarray(comp.result)


def make_nn_artifact(overlay: "CoyoteOverlay") -> AppArtifact:
    def fn(iface, vf, x):
        x = np.asarray(x)
        if x.ndim == 2:                     # full stream: pipelined loop
            return overlay._predict_stream(iface, x)
        return overlay._predict_dev(
            torch.from_numpy(x).to(vf.static.device)).cpu().numpy()
    return AppArtifact(
        name="nn_inference", fn=fn,
        weights=overlay.params,
        requires=[ServiceRequirement("mmu", {})],
        config_repr=overlay.cfg,
        capabilities=PortCapabilities(
            name="nn_inference", kind="app", streams=1,
            csr_map={"batch_size": CSR_NN_BATCH},
            mem_model="device", ops=("kernel",)))


class StagedCopyBaseline:
    """PYNQ/Vitis-style path: host -> card buffer (sync) -> kernel -> host,
    a fresh issue chain per batch with no overlap."""

    def __init__(self, params, cfg: MLPConfig = MLPConfig(), *,
                 device=None):
        self.device = resolve_device(device)
        self.params = [{k: v.to(self.device) for k, v in layer.items()}
                       for layer in params]

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def predict(self, X: np.ndarray, batch_size: int = 256) -> np.ndarray:
        outs = []
        for i in range(0, X.shape[0], batch_size):
            # pynq.allocate-style: fresh DMA buffer + host copy per call
            buf = np.empty_like(X[i:i + batch_size])
            buf[:] = X[i:i + batch_size]
            xb = torch.from_numpy(buf).to(self.device)  # host -> card copy
            self._sync()                               # staged: full sync
            staged = xb + 0                            # card buffer write
            self._sync()
            y = mlp_apply(self.params, staged)
            outs.append(y.cpu().numpy())               # sync every batch
        return np.concatenate(outs, axis=0)
