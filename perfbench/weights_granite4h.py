"""Seeded weights of a per-layer Mamba-2 / attention hybrid with a mixture
of experts after every mixer (granite-4.0-h-small), made on the device and
handed to both the program and the plain reference.

The tree has the port's layout (``repro_torch.models.transformer``'s
``mamba_layers`` and ``attn_layers``, each kind's layers stacked on a
leading axis, each with ``norm1``, its mixer, ``norm2`` and ``ffn``) and
the init scales of ``weights.py``: dense weights N(0, 1/fan_in), the
embedding N(0, 0.02^2), norm scales one, the Mamba-2 mixer's as
``weights.mamba2_params`` makes them.  The FFN holds the router over all
``n_experts`` (float32, as the port keeps it), the held experts'
SwiGLU weights and the shared expert's.  Each stacked leaf is one draw on
a ``torch.Generator`` of the device, so a seed gives the same tensors on
every call.
"""
from __future__ import annotations

import math

from perfbench import flops, weights


def held(cfg) -> int:
    e = cfg["moe"]
    return e.get("experts_held") or e["n_experts"]


def granite4h_params(cfg, gen, dtype, device):
    import torch
    d, hd = cfg["d_model"], cfg["head_dim"]
    h, k = cfg["n_heads"], cfg["n_kv_heads"]
    e = cfg["moe"]
    f, fs, n_e = e["d_ff_expert"], e["d_ff_shared"], held(cfg)
    pat = cfg["block_pattern"]
    kinds = [pat[i % len(pat)] for i in range(cfg["n_layers"])]
    nm, na = kinds.count("mamba_ffn"), kinds.count("attn")

    def w(shape, fan_in, dt=dtype):
        return weights._normal(gen, shape, 1.0 / math.sqrt(fan_in), dt,
                               device)

    def norm(L):
        return {"scale": weights._ones((L, d), dtype, device)}

    def ffn(L):
        return {"router": w((L, d, e["n_experts"]), d, torch.float32),
                "w_gate": w((L, n_e, d, f), d), "w_up": w((L, n_e, d, f), d),
                "w_down": w((L, n_e, f, d), f),
                "shared": {"w_gate": w((L, d, fs), d),
                           "w_up": w((L, d, fs), d),
                           "w_down": w((L, fs, d), fs)}}

    table = weights._normal(gen, (flops.padded_vocab(cfg), d), 0.02, dtype,
                            device)
    mamba = weights.mamba2_params(dict(cfg, n_layers=nm), gen, dtype,
                                  device)["layers"]["mamba"]
    return {
        "embed": {"table": table},
        "final_norm": {"scale": weights._ones((d,), dtype, device)},
        "mamba_layers": {"norm1": norm(nm), "mamba": mamba, "norm2": norm(nm),
                         "ffn": ffn(nm)},
        "attn_layers": {
            "norm1": norm(na),
            "attn": {"wq": w((na, d, h * hd), d), "wk": w((na, d, k * hd), d),
                     "wv": w((na, d, k * hd), d),
                     "wo": w((na, h * hd, d), h * hd)},
            "norm2": norm(na), "ffn": ffn(na)},
    }


def make(cfg, seed: int, dtype, device):
    """The configuration's weights for ``seed``, on ``device``."""
    import torch
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return granite4h_params(cfg, gen, dtype, device)
