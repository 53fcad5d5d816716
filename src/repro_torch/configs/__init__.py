"""Architecture config registry: ``get_config("qwen2-72b")`` etc."""
from __future__ import annotations

from repro_torch.configs.base import (ALL_SHAPES, DECODE_32K, LONG_500K, MoEConfig,
                                ModelConfig, PREFILL_32K, SHAPES_BY_NAME,
                                ShapeConfig, SSMConfig, TRAIN_4K,
                                shape_applicable)

from repro_torch.configs.smollm_135m import CONFIG as _smollm
from repro_torch.configs.h2o_danube_3_4b import CONFIG as _danube
from repro_torch.configs.qwen2_72b import CONFIG as _qwen2
from repro_torch.configs.phi3_medium_14b import CONFIG as _phi3
from repro_torch.configs.chameleon_34b import CONFIG as _chameleon
from repro_torch.configs.whisper_medium import CONFIG as _whisper
from repro_torch.configs.granite_moe_1b_a400m import CONFIG as _granite
from repro_torch.configs.llama4_scout_17b_a16e import CONFIG as _llama4
from repro_torch.configs.zamba2_2_7b import CONFIG as _zamba2
from repro_torch.configs.mamba2_1_3b import CONFIG as _mamba2
from repro_torch.configs.granite_4_0_h_small import CONFIG as _granite4h

ARCHS = {
    c.arch_id: c
    for c in (_smollm, _danube, _qwen2, _phi3, _chameleon, _whisper,
              _granite, _llama4, _zamba2, _mamba2)
}
# architectures the port runs beyond the JAX package's assignment table
# (ARCHS, which ``all_cells`` and the twin tests walk)
EXTRA_ARCHS = {c.arch_id: c for c in (_granite4h,)}


def get_config(arch_id: str) -> ModelConfig:
    known = {**ARCHS, **EXTRA_ARCHS}
    if arch_id not in known:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(known)}")
    return known[arch_id]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES_BY_NAME:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES_BY_NAME)}")
    return SHAPES_BY_NAME[name]


def all_cells():
    """Yield every (arch, shape, applicable, why) assignment cell."""
    for arch_id in sorted(ARCHS):
        cfg = ARCHS[arch_id]
        for shape in ALL_SHAPES:
            ok, why = shape_applicable(cfg, shape)
            yield cfg, shape, ok, why


__all__ = [
    "ARCHS", "EXTRA_ARCHS", "ALL_SHAPES", "ModelConfig", "MoEConfig",
    "SSMConfig", "ShapeConfig", "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
    "get_config", "get_shape", "all_cells", "shape_applicable",
]
