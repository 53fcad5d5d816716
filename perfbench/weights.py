"""Seeded weights, made by the benchmark on the device and handed to both
the program and the plain reference.

The trees have the port's layout (layers stacked on a leading axis, the
keys of ``repro_torch.models.transformer.init_params``) and its init
scales: dense weights N(0, 1/fan_in), the embedding N(0, 0.02^2), norm
scales one.  Each stacked leaf is one ``torch.randn`` call on a
``torch.Generator`` of the device, drawn in the type it is served in, so a
seed gives the same tensors on every call: the reference remakes them
rather than keeping a copy.
"""
from __future__ import annotations

import math

from perfbench import flops


def _normal(gen, shape, std, dtype, device):
    import torch
    t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return t.mul_(std)


def _ones(shape, dtype, device):
    import torch
    return torch.ones(shape, dtype=dtype, device=device)


def dense_params(cfg, gen, dtype, device):
    """A llama-style decoder (RMSNorm, GQA, SwiGLU, untied LM head)."""
    L, d, hd = cfg["n_layers"], cfg["d_model"], flops.head_dim(cfg)
    h, k, f = cfg["n_heads"], cfg["n_kv_heads"], cfg["d_ff"]
    vp = flops.padded_vocab(cfg)

    def w(shape, fan_in):
        return _normal(gen, shape, 1.0 / math.sqrt(fan_in), dtype, device)

    return {
        "embed": {"table": _normal(gen, (vp, d), 0.02, dtype, device)},
        "final_norm": {"scale": _ones((d,), dtype, device)},
        "lm_head": w((d, vp), d),
        "layers": {
            "norm1": {"scale": _ones((L, d), dtype, device)},
            "attn": {"wq": w((L, d, h * hd), d), "wk": w((L, d, k * hd), d),
                     "wv": w((L, d, k * hd), d),
                     "wo": w((L, h * hd, d), h * hd)},
            "norm2": {"scale": _ones((L, d), dtype, device)},
            "ffn": {"w_gate": w((L, d, f), d), "w_up": w((L, d, f), d),
                    "w_down": w((L, f, d), f)},
        },
    }


def mamba2_params(cfg, gen, dtype, device):
    """Mamba-2 blocks with a tied embedding; ``dt_bias``, ``A_log`` and
    ``D`` float32 whatever ``dtype`` is, as the port keeps them."""
    import torch
    L, d = cfg["n_layers"], cfg["d_model"]
    s = cfg["ssm"]
    di, nh, gn = flops.ssm_dims(cfg)
    conv_c = di + 2 * gn
    f32 = torch.float32

    def w(shape, fan_in):
        return _normal(gen, shape, 1.0 / math.sqrt(fan_in), dtype, device)

    # softplus(dt_bias) log-uniform over [1e-3, 1e-1], the mamba2 default
    u = torch.rand((L, nh), generator=gen, device=device, dtype=f32)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    a_log = torch.log(torch.arange(1, nh + 1, dtype=f32, device=device))
    return {
        "embed": {"table": _normal(gen, (flops.padded_vocab(cfg), d), 0.02,
                                   dtype, device)},
        "final_norm": {"scale": _ones((d,), dtype, device)},
        "layers": {
            "norm": {"scale": _ones((L, d), dtype, device)},
            "mamba": {
                "wz": w((L, d, di), d), "wx": w((L, d, di), d),
                "wB": w((L, d, gn), d), "wC": w((L, d, gn), d),
                "wdt": w((L, d, nh), d),
                "conv_w": w((L, s["d_conv"], conv_c), s["d_conv"]),
                "conv_b": torch.zeros((L, conv_c), dtype=dtype,
                                      device=device),
                "dt_bias": dt + torch.log(-torch.expm1(-dt)),
                "A_log": a_log.expand(L, nh).contiguous(),
                "D": _ones((L, nh), f32, device),
                "norm": {"scale": _ones((L, di), dtype, device)},
                "wo": w((L, di, d), di),
            },
        },
    }


MAKERS = {"dense": dense_params, "mamba2": mamba2_params}


def make(cfg, seed: int, dtype, device):
    """The configuration's weights for ``seed``, on ``device``."""
    import torch
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return MAKERS[cfg["weights"]](cfg, gen, dtype, device)
