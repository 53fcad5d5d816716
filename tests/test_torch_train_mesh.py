"""``Trainer(mesh=...)`` and the mesh train step against the JAX Trainer.

Reduced smollm-135m, mamba2-1.3b and granite-moe-1b-a400m, float32, 3
steps of global batch 4 at sequence 32, from the JAX Trainer's initial
weights.  The port runs on gloo ranks on the CPU (``run_ranks``; the rank
bodies are ``tests/_torch_mesh_train_ranks.py``) on the meshes (data,
model) (1, 1), (2, 1), (1, 2), (2, 2), (2, 1) under the ``zero3`` scheme
(the bare ``make_train_bundle``), (2, 1) with ``microbatches=2`` and (2,
1) with int8 compression; the reference is the JAX ``Trainer`` on
``make_host_mesh(1, 1)`` (one CPU device) at the same ``microbatches``
and compression.  Losses atol 1e-4, gradient norms rtol 1e-4 and
learning rates rtol 1e-6: the single-device Trainer twins' tolerances
(the mesh sums the same terms in another order: the all-reduces over
ranks, the Megatron partial sums over the model split).  With a (1, 2)
mesh the reduced models' 4 query / 2 KV heads and d_ff 256 split over
the model ranks (granite's MoE and mamba2 replicate).  Then a restart
under ``fail_at_step`` on (2, 2) (with compression's residuals in the
state) ends bit-identical to an uninterrupted run on every rank, and every
rank's shards equal ``local_shard`` of the state gathered whole.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config as jget
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core.services.compression import \
    CompressionConfig as JCompressionConfig
from repro.core.services.compression import \
    GradCompression as JGradCompression
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import Trainer as JTrainer
from repro_torch.launch.mesh import run_ranks

import _torch_mesh_train_ranks as R

ARCHS = ["smollm-135m", "mamba2-1.3b", "granite-moe-1b-a400m"]
# name -> (data, model, keywords); each reference keyed by its keywords
CASES = {
    "1x1": (1, 1, {}),
    "2x1": (2, 1, {}),
    "1x2": (1, 2, {}),
    "2x2": (2, 2, {}),
    "2x1_zero3": (2, 1, {"scheme": "zero3"}),
    "2x1_microbatches2": (2, 1, {"microbatches": 2}),
    "2x1_int8": (2, 1, {"compress": True}),
}
RESTART = ("restart_2x2", 2, 2, {"restart": True})
RUN = dict(device="cpu", backend="gloo", timeout_s=60.0, deadline_s=120.0)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _reference(arch, tmp, microbatches=1, compress=False):
    comp = (JGradCompression(JCompressionConfig(bits=8, error_feedback=True))
            if compress else None)
    t = JTrainer(jget(arch).reduced(),
                 JShapeConfig("t", "train", R.SHAPE.seq_len,
                              R.SHAPE.global_batch),
                 JTrainConfig(steps=R.STEPS, log_every=1, ckpt_every=0,
                              seed=R.SEED, ckpt_dir=str(tmp),
                              microbatches=microbatches, compression=comp),
                 mesh=jmake_host_mesh(1, 1))
    params = _np_tree(t.params)
    t.run()
    return params, [(m["loss"], m["grad_norm"], m["lr"])
                    for m in t.metrics_log]


@pytest.fixture(scope="module", params=ARCHS)
def runs(request, tmp_path_factory):
    """Every case of one arch: the reference logs and the port's, one
    ``run_ranks`` per world size."""
    arch = request.param
    tmp = tmp_path_factory.mktemp(arch)
    params, base = _reference(arch, tmp / "j1")
    refs = {(): base,
            ("microbatches",): _reference(arch, tmp / "j2", 2)[1],
            ("compress",): _reference(arch, tmp / "j3", compress=True)[1]}
    got = {}
    for world in (1, 2, 4):
        cases = [(n, d, m, kw) for n, (d, m, kw) in CASES.items()
                 if d * m == world]
        if world == 4:
            cases.append(RESTART)
        outs = run_ranks(R.train_cases, world, arch, params, cases,
                         str(tmp / f"p{world}"), **RUN)
        got.update(_agree(outs, skip=RESTART[0]))
        got[RESTART[0]] = [o.get(RESTART[0]) for o in outs]
    return arch, refs, got


def _agree(outs, skip):
    """Every rank logs the same metrics (they are reduced over the
    ranks); rank 0's stand for all."""
    for o in outs[1:]:
        for name in o:
            if name != skip:
                assert o[name] == outs[0][name], name
    return {k: v for k, v in outs[0].items() if k != skip}


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_trainer_tracks_the_reference_trainer(runs, case):
    arch, refs, got = runs
    kw = CASES[case][2]
    ref = refs[tuple(k for k in kw if k != "scheme")]
    mine = got[case]
    assert len(mine) == len(ref) == R.STEPS
    for (loss, gn, lr), (jloss, jgn, jlr) in zip(mine, ref):
        np.testing.assert_allclose(loss, jloss, atol=1e-4, err_msg=case)
        np.testing.assert_allclose(gn, jgn, rtol=1e-4, err_msg=case)
        np.testing.assert_allclose(lr, jlr, rtol=1e-6, err_msg=case)


def test_mesh_restart_is_bit_identical_and_shards_agree(runs):
    outs = runs[2][RESTART[0]]
    assert len(outs) == RESTART[1] * RESTART[2]
    for o in outs:
        assert o["restarts"] == (0, 1)
        assert o["final_steps"] == (5, 5)
        assert o["same"], "restart is not bit-identical on a rank"
        assert o["shards_ok"], "a rank's shards differ from the whole state"
        assert o["losses"][0][-1] == o["losses"][1][-1]
    assert [o["writer"] for o in outs] == [True, False, False, False]
