"""Collective service: the RoCE-v2 RDMA stack analogue (paper §6.2).

Twin of ``repro.core.services.collectives`` for a world of one process.
BALBOA gives Coyote v2 a reusable, reconfigurable 100G networking service;
this service owns:

  * schedule selection — flat ring vs hierarchical (reduce-scatter within
    a pod, all-reduce across pods, all-gather back), switchable at run
    time like swapping TCP/IP <-> RDMA in the paper;
  * an RDMA-style queue-pair registry (connect/send semantics);
  * wire-byte estimates per schedule for the roofline analysis.

A "mesh" here is a ``torch.distributed`` process group, or ``None`` for a
single process.  On a world of one every reduction is the identity, as
the reference's ``all_reduce`` returns its input when no axis is left to
reduce over.  A group of more than one process raises: multi-process
collectives are ROADMAP item 14.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.services.base import Service

_MULTI = ("multi-process collectives wait for the tensor-parallel slice "
          "of the port (ROADMAP item 14)")


def _world_size(group) -> int:
    if group is None:
        return 1
    import torch.distributed as dist
    return dist.get_world_size(group)


@dataclass(frozen=True)
class CollectiveConfig:
    schedule: str = "auto"        # auto | flat | hierarchical
    data_axis: str = "data"
    pod_axis: str = "pod"
    # chunk (bytes) for bucketed gradient reduction overlap
    bucket_bytes: int = 32 << 20


class CollectiveService(Service):
    NAME = "collectives"
    PORT_METHODS = ("pick_schedule", "create_qp", "qp_permutation",
                    "wire_bytes", "status", "configure")
    PORT_MEM_MODEL = "device"

    def __init__(self, config: Optional[CollectiveConfig] = None):
        super().__init__(config if config is not None
                         else CollectiveConfig())
        self._qps: Dict[int, Tuple[int, int]] = {}   # qp id -> (src, dst)
        self._next_qp = 1

    # -- schedule selection ---------------------------------------------------
    def pick_schedule(self, mesh) -> str:
        """A single process has no pod level: ``auto`` is ``flat``."""
        c: CollectiveConfig = self.config
        if c.schedule != "auto":
            return c.schedule
        if _world_size(mesh) > 1:
            raise NotImplementedError(_MULTI)
        return "flat"

    # -- reductions -----------------------------------------------------------
    def all_reduce(self, x: torch.Tensor, mesh=None,
                   axes: Optional[Tuple[str, ...]] = None) -> torch.Tensor:
        """Schedule-aware all-reduce.  On a world of one the sum over the
        (single) participant is ``x`` itself."""
        if _world_size(mesh) > 1:
            raise NotImplementedError(_MULTI)
        return x

    # -- QP registry (RDMA verbs analogue) --------------------------------------
    def create_qp(self, src_pod: int, dst_pod: int) -> int:
        qp = self._next_qp
        self._next_qp += 1
        self._qps[qp] = (src_pod, dst_pod)
        return qp

    def qp_permutation(self, qp: int, n_pods: int) -> List[Tuple[int, int]]:
        """Peer pairs implementing this QP's one-way write."""
        src, dst = self._qps[qp]
        return [(src, dst)]

    def rdma_write(self, x, qp: int, *, pod_axis: Optional[str] = None):
        """One-sided write to the peer pod: needs more than one process."""
        raise NotImplementedError(_MULTI)

    # -- roofline estimates -------------------------------------------------------
    @staticmethod
    def wire_bytes(schedule: str, nbytes: int, data: int, pods: int,
                   pod_links: int = 1) -> Dict[str, float]:
        """Modeled per-device wire bytes for an all-reduce of `nbytes`."""
        if schedule == "flat":
            g = data * pods
            return {"intra": 2 * (g - 1) / g * nbytes, "inter": 0.0}
        rs = (data - 1) / data * nbytes
        ag = (data - 1) / data * nbytes
        inter = 2 * (pods - 1) / pods * (nbytes / data)
        return {"intra": rs + ag, "inter": inter}

    def status(self) -> Dict[str, Any]:
        s = super().status()
        s["open_qps"] = len(self._qps)
        return s
