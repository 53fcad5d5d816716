"""AES vFPGA apps: ECB (multi-tenant bench) and CBC (cThread bench).

Twin of ``repro.apps.aes``.  Wraps the encryption service's math
(``repro_torch.core.services.encryption``) as slot-loadable artifacts
that run on the slot's device.  The CBC app reads the key from CSR 0 like
the paper's Code 1 (``cthread.setCSR(KEY, 0)``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.port import PortCapabilities
from repro_torch.core.services import encryption as E
from repro_torch.core.services.base import ServiceRequirement
from repro_torch.core.vfpga import AppArtifact

CSR_KEY_LO = 0
CSR_KEY_HI = 1


def _round_keys_from_csr(iface, device):
    lo = iface.csr.get_csr(CSR_KEY_LO, 0x0706050403020100)
    hi = iface.csr.get_csr(CSR_KEY_HI, 0x0F0E0D0C0B0A0908)
    key = np.frombuffer(np.array([lo, hi], dtype="<u8").tobytes(),
                        dtype=np.uint8).copy()
    return torch.from_numpy(E.expand_key(key)).to(device)


def aes_ecb_app(iface, vfpga, data):
    """ECB over a byte buffer — embarrassingly parallel, memory-bound."""
    dev = vfpga.static.device
    rk = _round_keys_from_csr(iface, dev)
    blocks = torch.from_numpy(E.bytes_to_blocks(np.asarray(data))).to(dev)
    out = E.aes_ecb(blocks, rk)
    return out.cpu().numpy().reshape(-1)


def aes_cbc_app(iface, vfpga, data, n_streams: int = 1):
    """CBC; with n_streams > 1 the buffer is split into independent
    cThread streams carried through the chained pipeline together (Fig
    10b)."""
    dev = vfpga.static.device
    rk = _round_keys_from_csr(iface, dev)
    blocks = E.bytes_to_blocks(np.asarray(data))
    n = blocks.shape[0] // n_streams * n_streams
    blocks = torch.from_numpy(blocks[:n]).to(dev).reshape(n_streams, -1, 16)
    ivs = torch.zeros((n_streams, 16), dtype=torch.uint8, device=dev)
    out = E.aes_cbc_multistream(blocks, ivs, rk)
    return out.cpu().numpy().reshape(-1)


def make_aes_artifact(mode: str = "ecb") -> AppArtifact:
    fn = aes_ecb_app if mode == "ecb" else aes_cbc_app
    return AppArtifact(
        name=f"aes_{mode}", fn=fn,
        requires=[ServiceRequirement("encryption", {})],
        config_repr={"mode": mode},
        capabilities=PortCapabilities(
            name=f"aes_{mode}", kind="app", streams=1,
            csr_map={"key_lo": CSR_KEY_LO, "key_hi": CSR_KEY_HI},
            mem_model="host", ops=("local_transfer", "kernel")))
