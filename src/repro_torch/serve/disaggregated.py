"""Prefill/decode disaggregation across the ``pod`` dim.

Twin of ``repro.serve.disaggregated``.  The paper's RDMA story at LLM
scale: pod 0 runs compute-bound prefill, pod 1 runs memory-bound decode,
and the prefilled KV cache crosses the pod boundary through the
collective service's queue pairs — a one-sided ``rdma_write``
(``send``/``recv`` over the ``pod`` dim's group), the Coyote v2
networking service pattern (§6.2).

``make_handoff_fn`` builds the transfer.  Every rank calls ``handoff``
with its own block of each leaf (dim 0 split over ``pod``); the rank of
the prefill pod sends its block to the rank at the same intra-pod
coordinates in the decode pod, so intra-pod layouts pass through
untouched and the wire volume is exactly one cache copy over the
inter-pod links.
"""
from __future__ import annotations

from torch.utils import _pytree as pytree

from repro_torch.core.services.collectives import (CollectiveConfig,
                                                   CollectiveService)


def make_handoff_fn(mesh, svc: CollectiveService = None, *,
                    pod_axis: str = "pod"):
    """Returns ``(handoff, qp)``: ``handoff(cache_tree) -> cache_tree``
    where every leaf on the decode pod's ranks holds pod 0's block
    (delivered) and pod 0's ranks keep their own (one-sided write
    semantics).  Raises ``ValueError`` for a mesh with fewer than two
    pods."""
    names = tuple(mesh.mesh_dim_names)
    n_pods = (int(mesh.shape[names.index(pod_axis)]) if pod_axis in names
              else 1)
    if n_pods < 2:
        raise ValueError(
            f"disaggregation needs a multi-pod mesh: dim {pod_axis!r} has "
            f"{n_pods} pod(s) in a mesh of dims {names}")
    svc = svc or CollectiveService(CollectiveConfig(pod_axis=pod_axis))
    qp = svc.create_qp(0, 1)
    me = mesh.get_local_rank(pod_axis)

    def _leaf_handoff(x):
        sent = svc.rdma_write(x, qp, mesh=mesh, pod_axis=pod_axis)
        return sent if me > 0 else x

    def handoff(cache):
        return pytree.tree_map(_leaf_handoff, cache)

    return handoff, qp


def handoff_wire_bytes(cache, n_pods: int = 2) -> float:
    """Modeled inter-pod bytes: one copy of the prefill pod's cache.
    ``cache``: the whole (global) tree, tensors or arrays."""
    total = 0
    for x in pytree.tree_leaves(cache):
        total += (x.numel() * x.element_size() if hasattr(x, "element_size")
                  else x.nbytes)
    return total / n_pods     # only the prefill pod's shard crosses
