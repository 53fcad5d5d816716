"""The port's prefill/decode hand-off across the ``pod`` dim against the
JAX package.

Twin of ``tests/test_sampler_disagg.py::test_disaggregated_handoff_multidev``.
Four gloo ranks on the CPU form a (pod 2, data 2, model 1) mesh
(``run_ranks``; rank bodies in ``tests/_torch_tp_ranks.py``).  Each rank
passes its pod's rows of the reference test's cache: after the hand-off
pod 1's ranks hold pod 0's rows (delivered) and pod 0's keep their own
(kept), exactly; ``handoff_wire_bytes`` equals the reference's.
"""
import jax.numpy as jnp
import numpy as np
import torch

import _torch_tp_ranks as ranks
from repro.serve.disaggregated import handoff_wire_bytes as jwire_bytes
from repro_torch.launch.mesh import run_ranks
from repro_torch.serve.disaggregated import handoff_wire_bytes

torch.set_num_threads(1)

# dim 0 pod-split: rows 0-1 = the prefill pod's KV, rows 2-3 = the decode
# pool (the reference test's cache)
CACHE = {"k": np.arange(4 * 6, dtype=np.float32).reshape(4, 6),
         "v": -np.arange(4 * 6, dtype=np.float32).reshape(4, 6)}


def test_disaggregated_handoff_multirank():
    outs = run_ranks(ranks.handoff, 4, CACHE, device="cpu")
    assert {o["pod"] for o in outs} == {0, 1}
    for o in outs:
        assert o["qp"] == 1
        for name, full in CACHE.items():
            # delivered to pod 1, kept by pod 0: pod 0's rows everywhere
            np.testing.assert_array_equal(o["out"][name], full[:2])


def test_handoff_wire_bytes_equal_reference():
    want = jwire_bytes({k: jnp.asarray(v) for k, v in CACHE.items()})
    assert want == sum(x.nbytes for x in CACHE.values()) / 2
    assert handoff_wire_bytes({k: torch.from_numpy(v)
                               for k, v in CACHE.items()}) == want
    assert handoff_wire_bytes(CACHE) == want
    assert handoff_wire_bytes(CACHE, n_pods=4) == \
        jwire_bytes({k: jnp.asarray(v) for k, v in CACHE.items()}, n_pods=4)


def test_handoff_needs_two_pods():
    """A mesh of one pod raises ``ValueError`` (the reference asserts)."""
    msg, = run_ranks(ranks.handoff_needs_pods, 2, device="cpu")[:1]
    assert msg is not None and "multi-pod" in msg
