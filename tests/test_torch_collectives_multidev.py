"""Multi-rank collective service and context-parallel decode attention of
the port against the JAX package.

Twin of ``tests/test_collectives_multidev.py``.  Eight gloo ranks on the
CPU form a (pod 2, data 2, model 2) mesh (``run_ranks``; rank bodies in
``tests/_torch_tp_ranks.py``): the hierarchical all-reduce equals the flat
one within 1e-5, and ``attend_decode_cp`` — the batch on ``data``, the
cache's sequence on ``model`` — equals the port's and the reference's
``attend_decode`` on the same inputs within 1e-4, the reference's bound.
A single process (``mesh=None``) and a world of one keep every reduction
the identity.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_ranks as ranks
from repro.core.services.collectives import (
    CollectiveConfig as JCollectiveConfig, CollectiveService as JService)
from repro.models.attention import attend_decode as jattend_decode
from repro_torch.core.services.collectives import (CollectiveConfig,
                                                   CollectiveService)
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.attention import attend_decode

torch.set_num_threads(1)

B, S, H, K, D = 4, 16, 4, 2, 8
LENS = np.array([16, 9, 12, 5], np.int32)


def _cp_inputs():
    rs = np.random.RandomState(0)
    return (rs.standard_normal((B, 1, H, D)).astype(np.float32),
            rs.standard_normal((B, S, K, D)).astype(np.float32),
            rs.standard_normal((B, S, K, D)).astype(np.float32), LENS)


@pytest.fixture(scope="module")
def eight_ranks():
    inputs = _cp_inputs()
    return inputs, run_ranks(ranks.collectives_and_cp, 8, inputs, device="cpu")


def test_hierarchical_all_reduce_equals_flat(eight_ranks):
    """reduce-scatter(data) -> all-reduce(pod) -> all-gather(data) of each
    rank's (pod, data) block of arange(32).reshape(8, 4) equals the flat
    sum over (pod, data) within 1e-5, on every rank; the flat sum is the
    four blocks' sum."""
    _, outs = eight_ranks
    x = np.arange(32.0, dtype=np.float32).reshape(8, 4)
    want = sum(np.split(x, 4))
    for out in outs:
        np.testing.assert_allclose(out["hier"], out["flat"], atol=1e-5)
        np.testing.assert_allclose(out["flat"], want, atol=1e-5)
        assert out["host_copies"] == 0        # gloo on CPU tensors


def test_cp_decode_attention_matches_dense(eight_ranks):
    """Each data coordinate's rows of ``attend_decode_cp`` equal the port's
    ``attend_decode`` and the reference's on the whole cache, atol 1e-4."""
    (q, kc, vc, lens), outs = eight_ranks
    ref = np.asarray(jattend_decode(jnp.asarray(q), jnp.asarray(kc),
                                    jnp.asarray(vc), jnp.asarray(lens)))
    port = attend_decode(torch.from_numpy(q), torch.from_numpy(kc),
                         torch.from_numpy(vc),
                         torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(port, ref, atol=1e-5)
    for out in outs:
        data = out["coords"][1]
        rows = slice(data * 2, data * 2 + 2)
        assert float(np.abs(out["cp"] - ref[rows]).max()) < 1e-4
        assert float(np.abs(out["cp"] - port[rows]).max()) < 1e-4


def test_single_process_reductions_are_the_identity():
    """``mesh=None``: every schedule returns its input, as the reference's
    does with no axis left to reduce over; the wire model and the schedule
    choice equal the reference's."""
    x = torch.arange(12.0).reshape(3, 4)
    for sched in ("auto", "flat", "hierarchical"):
        svc = CollectiveService(CollectiveConfig(schedule=sched))
        assert svc.all_reduce(x, None) is x
        assert svc.all_reduce(x, None, axes=("model",)) is x
        assert svc.pick_schedule(None) == (
            "flat" if sched == "auto" else sched)
    for sched in ("flat", "hierarchical"):
        assert CollectiveService.wire_bytes(sched, 1 << 20, 16, 2) == \
            JService.wire_bytes(sched, 1 << 20, 16, 2)
    with pytest.raises(TypeError, match="DeviceMesh"):
        CollectiveService().all_reduce(x, object())
    jsvc, svc = JService(JCollectiveConfig()), CollectiveService()
    assert [svc.create_qp(0, 1), svc.qp_permutation(1, 2)] == \
        [jsvc.create_qp(0, 1), jsvc.qp_permutation(1, 2)]


def test_world_of_one_reductions_are_the_identity():
    """A (1, 1, 1) mesh over one rank: flat, hierarchical and auto
    all-reduces and a reduction over ``model`` return the input."""
    assert run_ranks(ranks.world_of_one, 1, device="cpu") == [[True, True, True, True]]
