"""The hybrid training cell cut to a size a CPU test run can hold, as
``smallcells.py`` cuts the first two cells: the same runner, traffic
kind, reference and check; widths, depth, lengths and counts cut, float32
throughout.  Only the tests use it.
"""
from __future__ import annotations

import copy

from perfbench import harness

# one whole 10-layer period at d 128, 8 experts of which 2 are held
GRANITE_SMALL = dict(n_layers=10, d_model=128, n_heads=4, n_kv_heads=2,
                     head_dim=32, vocab_size=512, dtype="float32",
                     param_dtype="float32",
                     ssm={"d_state": 16, "d_conv": 4, "expand": 2,
                          "head_dim": 32, "n_groups": 1, "chunk_size": 32})
MOE_SMALL = dict(n_experts=8, top_k=2, d_ff_expert=64, d_ff_shared=128,
                 experts_held=2)


def granite_config(**moe):
    """The granite-4.0-h-small configuration at the CPU size."""
    config = dict(harness.load_config("granite-4.0-h-small"),
                  **GRANITE_SMALL)
    config["moe"] = dict(config["moe"], **dict(MOE_SMALL, **moe))
    return config


def train_cell(name: str = "granite4h-train"):
    """(cell, config) of the hybrid training cell at a CPU size."""
    cell = copy.deepcopy(harness.load_cell(name))
    cell["traffic"].update(batch=2, seq_len=64)
    cell["traffic"]["opt"] = dict(cell["traffic"]["opt"], warmup_steps=2)
    cell["limits"] = {"grad_gap": 1e-3, "change_gap": 1e-2}
    return cell, granite_config()

