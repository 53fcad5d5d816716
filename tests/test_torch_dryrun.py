"""The port's dry run (``python -m repro_torch.launch.dryrun``) against the
reference's sharding.

Run as a subprocess, as the reference's is (the module creates a fake
process group of 256 or 512 ranks in its own process): smollm-135m
``train_4k`` on the single-pod mesh with a ``long_500k`` cell that skips,
granite-moe-1b-a400m ``decode_32k`` and mamba2-1.3b ``train_4k`` (the SSD
scan on meta tensors) on the two-pod mesh.  Each cell's
status and skip reason equal the reference's ``shape_applicable``; the
per-rank parameter and AdamW bytes equal what the reference's
``param_specs`` imply at the mesh's sizes (the reference's
``MeshRules`` built from the sizes, its ``init_params`` shapes from
``jax.eval_shape``); the record carries FLOPs, the step's collectives and
the reference's fields that have no eager counterpart.  Each subprocess
finishes in under 60 s.  Then ``telemetry.report.table`` renders the
records.
"""
import functools
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec

from repro.configs import get_config as jget
from repro.configs import get_shape as jget_shape
from repro.configs import shape_applicable as jshape_applicable
from repro.models import transformer as JT
from repro.models.sharding import MeshRules as JMeshRules
from repro_torch.telemetry import report

SRC = str(Path(__file__).resolve().parents[1] / "src")
RUNS = [  # (mesh, arch, shapes): one subprocess each
    ("pod", "smollm-135m", ["train_4k", "long_500k"]),
    ("multipod", "granite-moe-1b-a400m", ["decode_32k"]),
    ("multipod", "mamba2-1.3b", ["train_4k"]),
]
SIZES = {"pod": {"data": 16, "model": 16},
         "multipod": {"pod": 2, "data": 16, "model": 16}}


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    recs, seconds = {}, {}
    for mesh, arch, shapes in RUNS:
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", ",".join(shapes), "--mesh", mesh, "--out",
             str(out)], env=env, capture_output=True, text=True,
            timeout=300)
        seconds[(mesh, arch)] = time.perf_counter() - t0
        assert proc.returncode == 0, proc.stdout + proc.stderr
        for s in shapes:
            recs[(mesh, arch, s)] = json.loads(
                (out / mesh / f"{arch}__{s}.json").read_text())
    return out, recs, seconds


def _reference_bytes(arch, mesh, dtype):
    """Per-rank parameter bytes under the reference's 2D ``param_specs``
    at the mesh's sizes."""
    names = tuple(SIZES[mesh])
    fsdp = tuple(a for a in names if a != "model")
    rules = JMeshRules(fsdp_axes=fsdp, tp_axis="model",
                       fsdp_size=math.prod(SIZES[mesh][a] for a in fsdp),
                       tp_size=SIZES[mesh]["model"])
    cfg = jget(arch)
    shapes = jax.eval_shape(functools.partial(JT.init_params, cfg=cfg,
                                              dtype=dtype),
                            jax.random.PRNGKey(0))
    specs = JT.param_specs(cfg, rules)
    total = 0
    for x, sp in zip(jax.tree.leaves(shapes), jax.tree.leaves(
            specs, is_leaf=lambda s: isinstance(s, PartitionSpec))):
        n = 1
        for i, d in enumerate(x.shape):
            e = sp[i] if i < len(sp) else None
            dims = () if e is None else (e,) if isinstance(e, str) else e
            n *= d // math.prod(SIZES[mesh][a] for a in dims)
        total += n * x.dtype.itemsize
    return total


@pytest.mark.parametrize("mesh,arch,shape", [(m, a, s) for m, a, ss in RUNS
                                             for s in ss])
def test_cell_status_and_bytes_follow_the_reference(records, mesh, arch,
                                                     shape):
    _, recs, seconds = records
    rec = recs[(mesh, arch, shape)]
    assert seconds[(mesh, arch)] < 60.0
    ok, why = jshape_applicable(jget(arch), jget_shape(shape))
    assert rec["status"] == ("ok" if ok else "skipped"), rec
    if not ok:
        assert rec["reason"] == why
        return
    assert rec["chips"] == math.prod(SIZES[mesh].values())
    kind = jget_shape(shape).kind
    dtype = jnp.float32 if kind == "train" else jnp.bfloat16
    pbytes = _reference_bytes(arch, mesh, dtype)
    got = rec["per_rank_bytes"]
    assert got["params"] == pbytes
    if kind == "train":
        # m and v (float32, like the parameters here) and the step count
        assert got["optimizer"] == 2 * pbytes + 4
    else:
        assert got["optimizer"] == 0 and got["cache"] > 0
    assert got["batch"] > 0
    roof = rec["roofline"]
    assert roof["flops_per_device"] > 0
    coll = roof["collectives"]
    assert coll["counts"].get("all-gather", 0) > 0
    if kind == "train":
        assert coll["counts"].get("all-reduce", 0) > 0
    assert set(rec["no_eager_counterpart"]) == {
        "compile_s", "memory_analysis", "cost_analysis", "discount_scope"}
    # the reference's record keys, those without a counterpart null
    for key in ("arch", "shape", "mesh", "tag", "status", "step",
                "bundle_kw", "chips", "lower_s", "roofline"):
        assert key in rec
    assert (rec["compile_s"], rec["memory_analysis"],
            rec["cost_analysis"]) == (None, None, None)


def test_report_renders_the_port_records(records, monkeypatch):
    out, _, _ = records
    monkeypatch.setattr(report, "DRYRUN", out)
    pod = report.table("pod")
    assert "| smollm-135m | train_4k | baseline | ok |" in pod
    assert "| smollm-135m | long_500k | baseline | skipped |" in pod
    assert "| granite-moe-1b-a400m | decode_32k | baseline | ok |" in \
        report.table("multipod")


def test_the_two_dry_runs_write_apart():
    assert report.DRYRUN.name == "dryrun_torch"
    src = (Path(SRC) / "repro_torch" / "launch" / "dryrun.py").read_text()
    assert '"dryrun_torch"' in src
