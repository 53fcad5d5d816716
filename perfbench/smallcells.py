"""The benchmark's cells cut to a size a CPU test run can hold.

Same runners, traffic kinds, references and checks as the cells on the
card; widths, depth, lengths and counts cut (``reduced`` of the port's
configs), float32 throughout, so that a sound run of the program's CPU
path agrees with the reference to rounding.  Only the tests use them.
"""
from __future__ import annotations

import copy

from perfbench import harness

DENSE_SMALL = dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                   head_dim=32, d_ff=256, vocab_size=512, dtype="float32")
MAMBA_SMALL = dict(n_layers=2, d_model=128, vocab_size=512, dtype="float32",
                   param_dtype="float32",
                   ssm={"d_state": 16, "d_conv": 4, "expand": 2,
                        "head_dim": 32, "n_groups": 1, "chunk_size": 32})


def serve_cell(name: str = "danube-longdoc"):
    """(cell, config) of the serving cell at a CPU size."""
    cell = harness.load_cell(name)
    config = dict(harness.load_config(cell["config"]), **DENSE_SMALL)
    cell = copy.deepcopy(cell)
    cell["engine"] = {"max_batch": 4, "max_len": 256, "page_size": 8,
                      "prefill_chunk": 32, "n_pages": 128}
    cell["traffic"].update(
        clients=4, requests=96, stagger_steps=1, trace_steps=2,
        sample_tokens=24,
        prompt={"dist": "lognormal", "median": 64, "sigma": 0.35,
                "min": 40, "max": 120},
        output={"dist": "uniform", "min": 4, "max": 8})
    cell["limits"] = {"logit_gap": 1e-3}
    return cell, config


def train_cell(name: str = "mamba2-train"):
    """(cell, config) of the training cell at a CPU size."""
    cell = harness.load_cell(name)
    config = dict(harness.load_config(cell["config"]), **MAMBA_SMALL)
    cell = copy.deepcopy(cell)
    cell["traffic"].update(batch=2, seq_len=64)
    cell["traffic"]["opt"] = dict(cell["traffic"]["opt"], warmup_steps=2)
    cell["limits"] = {"grad_gap": 1e-3, "change_gap": 1e-2}
    return cell, config


def run(name, cell, config, seed=7, seconds=1.0):
    return harness.run_cell(name, seed, seconds, False, device="cpu",
                            cell=cell, config=config)
