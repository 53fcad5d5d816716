"""AES-128 encryption service on tensors (paper §9.4/9.5 workloads).

Twin of ``repro.core.services.encryption``.  The paper uses AES two ways:
as a shell *service* (encryption cores for the RDMA stack) and as the
multi-tenant / multi-threaded macro-benchmark.  This module is the core
math; ``repro_torch.apps.aes`` wraps it as a vFPGA app.

Implementation notes:
  * the state is uint8 (..., 16), column-major like FIPS-197; uint8
    shifts and products wrap modulo 256 in PyTorch, which is GF(2^8)'s
    xtime without a cast;
  * SubBytes is a 256-entry table gather, ShiftRows a gather over the
    last axis, MixColumns xtime shifts/xors — all on the state's device;
  * ECB runs every block at once (embarrassingly parallel);
  * CBC chains blocks in a Python loop over :func:`cbc_step` — the
    sequential-dependence pipeline the paper fills with cThreads (Fig
    9/10): ``aes_cbc_multistream`` carries T independent streams through
    each step as one (T, 16) tensor, which is the multi-threading claim.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.services.base import Service

# ----------------------------------------------------------- tables -------
_SBOX_NP = np.array([
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b,
    0xfe, 0xd7, 0xab, 0x76, 0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0,
    0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0, 0xb7, 0xfd, 0x93, 0x26,
    0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2,
    0xeb, 0x27, 0xb2, 0x75, 0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0,
    0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84, 0x53, 0xd1, 0x00, 0xed,
    0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f,
    0x50, 0x3c, 0x9f, 0xa8, 0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5,
    0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2, 0xcd, 0x0c, 0x13, 0xec,
    0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14,
    0xde, 0x5e, 0x0b, 0xdb, 0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c,
    0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79, 0xe7, 0xc8, 0x37, 0x6d,
    0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f,
    0x4b, 0xbd, 0x8b, 0x8a, 0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e,
    0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e, 0xe1, 0xf8, 0x98, 0x11,
    0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f,
    0xb0, 0x54, 0xbb, 0x16], dtype=np.uint8)

_RCON = np.array([0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1b,
                  0x36], dtype=np.uint8)

# ShiftRows permutation for flat column-major state: new[r+4c]=old[r+4((c+r)%4)]
_SHIFT_IDX = np.array([(r + 4 * ((c + r) % 4)) for c in range(4)
                       for r in range(4)], dtype=np.int32)
# flat index helper: position p = r + 4c -> r = p % 4, c = p // 4
_SHIFT_IDX = np.array([(p % 4) + 4 * (((p // 4) + (p % 4)) % 4)
                       for p in range(16)], dtype=np.int32)



def expand_key(key: np.ndarray) -> np.ndarray:
    """key (16,) uint8 -> round keys (11, 16) uint8 (host-side, numpy)."""
    assert key.shape == (16,) and key.dtype == np.uint8
    w = [key[4 * i:4 * i + 4].copy() for i in range(4)]
    for i in range(4, 44):
        t = w[i - 1].copy()
        if i % 4 == 0:
            t = np.roll(t, -1)
            t = _SBOX_NP[t]
            t[0] ^= _RCON[i // 4 - 1]
        w.append(w[i - 4] ^ t)
    return np.concatenate(w).reshape(11, 16)


_TABLES: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}


def _tables(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The S-box and the ShiftRows permutation on ``device`` (cached)."""
    t = _TABLES.get(device)
    if t is None:
        t = (torch.from_numpy(_SBOX_NP).to(device),
             torch.from_numpy(_SHIFT_IDX).to(device))
        if device.type != "meta":
            _TABLES[device] = t
    return t


def _xtime(a):
    return (a << 1) ^ ((a >> 7) * 0x1B)


def _mix_columns(s):
    """s (..., 16) flat column-major."""
    cols = s.reshape(s.shape[:-1] + (4, 4))           # (..., col, row)
    a0, a1, a2, a3 = (cols[..., 0], cols[..., 1], cols[..., 2], cols[..., 3])
    x0, x1, x2, x3 = _xtime(a0), _xtime(a1), _xtime(a2), _xtime(a3)
    b0 = x0 ^ (x1 ^ a1) ^ a2 ^ a3
    b1 = a0 ^ x1 ^ (x2 ^ a2) ^ a3
    b2 = a0 ^ a1 ^ x2 ^ (x3 ^ a3)
    b3 = (x0 ^ a0) ^ a1 ^ a2 ^ x3
    return torch.stack([b0, b1, b2, b3], dim=-1).reshape(s.shape)


def encrypt_block(state, round_keys):
    """AES-128 on uint8 state (..., 16); round_keys (11, 16) uint8."""
    sbox, shift = _tables(state.device)
    s = state ^ round_keys[0]
    for rnd in range(1, 10):
        s = sbox[s.int()]                                 # SubBytes
        s = s[..., shift]                                 # ShiftRows
        s = _mix_columns(s)                               # MixColumns
        s = s ^ round_keys[rnd]
    s = sbox[s.int()]
    s = s[..., shift]
    return s ^ round_keys[10]


def aes_ecb(blocks, round_keys):
    """ECB: blocks (N, 16) uint8 — embarrassingly parallel."""
    return encrypt_block(blocks, round_keys)


def cbc_step(prev_ct, pt, round_keys):
    """One link of the CBC chain: ``E(pt ^ prev_ct)`` for every stream at
    once (``prev_ct`` and ``pt`` (..., 16))."""
    return encrypt_block(pt ^ prev_ct, round_keys)


def _cbc_chain(blocks, iv, round_keys):
    """blocks (..., N, 16), iv (..., 16): the chain over the N axis."""
    out = torch.empty_like(blocks)
    prev = iv
    for i in range(blocks.shape[-2]):
        prev = cbc_step(prev, blocks[..., i, :], round_keys)
        out[..., i, :] = prev
    return out


def aes_cbc(blocks, iv, round_keys):
    """CBC over one stream: blocks (N, 16); iv (16,).  Sequential chain —
    the pipeline-stall workload of paper Fig 9."""
    return _cbc_chain(blocks, iv, round_keys)


def aes_cbc_multistream(blocks, ivs, round_keys):
    """CBC over T independent streams: blocks (T, N, 16); ivs (T, 16).

    Each step carries T blocks through the 10-round pipeline as one
    (T, 16) tensor instead of one block — the cThread multithreading of
    Fig 10b, which removes the data-dependence bubbles."""
    return _cbc_chain(blocks, ivs, round_keys)


def bytes_to_blocks(data: np.ndarray) -> np.ndarray:
    flat = np.ascontiguousarray(data).reshape(-1).view(np.uint8).copy()
    pad = (-flat.size) % 16
    if pad:
        flat = np.concatenate([flat, np.zeros(pad, np.uint8)])
    return flat.reshape(-1, 16)


@dataclass(frozen=True)
class AESConfig:
    key_hex: str = "000102030405060708090a0b0c0d0e0f"
    mode: str = "ecb"             # ecb | cbc


class AESService(Service):
    """Encryption as a reusable shell service (e.g. on the RDMA datapath).
    The round keys live on the host; each call runs on the device of the
    blocks it is given."""

    NAME = "encryption"
    PORT_METHODS = ("encrypt", "status", "configure")
    PORT_MEM_MODEL = "host"

    def __init__(self, config: Optional[AESConfig] = None):
        if config is None:
            config = AESConfig()
        super().__init__(config)
        self._set_key(config.key_hex)

    def _set_key(self, key_hex: str) -> None:
        key = np.frombuffer(bytes.fromhex(key_hex), dtype=np.uint8).copy()
        self.round_keys = torch.from_numpy(expand_key(key))

    def configure(self, config: AESConfig) -> None:
        super().configure(config)
        self._set_key(config.key_hex)

    def encrypt(self, blocks, iv=None):
        blocks = torch.as_tensor(blocks)
        rk = self.round_keys.to(blocks.device)
        if self.config.mode == "ecb":
            return aes_ecb(blocks, rk)
        if iv is None:
            iv = torch.zeros((16,), dtype=torch.uint8, device=blocks.device)
        if blocks.ndim == 3:
            return aes_cbc_multistream(blocks, iv, rk)
        return aes_cbc(blocks, iv, rk)
