"""Collective service: the RoCE-v2 RDMA stack analogue (paper §6.2).

Twin of ``repro.core.services.collectives`` on ``torch.distributed``.
BALBOA gives Coyote v2 a reusable, reconfigurable 100G networking service;
this service owns:

  * schedule selection — flat ring vs hierarchical (reduce-scatter within
    a pod, all-reduce across pods, all-gather back), switchable at run
    time like swapping TCP/IP <-> RDMA in the paper;
  * the reductions the tensor-parallel serving path and the gradient path
    call (``all_reduce``), over a mesh's named dims;
  * an RDMA-style queue-pair registry (connect/send semantics) and the
    one-sided ``rdma_write`` across the ``pod`` dim, used for the
    prefill/decode hand-off;
  * wire-byte estimates per schedule for the roofline analysis.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims
(``launch/mesh.py``), or ``None`` for a single process, where every
reduction is the identity, as the reference's ``all_reduce`` returns its
input when no axis is left to reduce over.  The reference's primitives
run inside ``shard_map`` bodies; here every rank calls them, in the same
order, from the thread that owns the model.

Each collective runs on its operand's device.  Gloo takes CUDA tensors
for all-reduce, broadcast, reduce-scatter and all-gather (it stages them
through the host itself); it has no CUDA send/recv, so there the service
copies the operand to the host and back explicitly and counts each such
copy in ``host_copies``.  No collective is retried another way.

``traffic`` counts every collective the service issues by (operation,
group size): calls and result bytes, which
``telemetry.roofline.collective_stats`` turns into the roofline's wire
bytes.  A ``meta`` operand (a dry run, a build on meta tensors) carries no
data: it is counted and answered with a result of the right shape, and no
call reaches the process group.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.core.services.base import Service


def _check_mesh(mesh) -> None:
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"a mesh is a torch.distributed DeviceMesh with "
                        f"named dims (or None), not {type(mesh).__name__}")


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
        # operands copied to the host (gloo's send/recv of a CUDA
        # tensor), and collectives issued
        self.host_copies = 0
        self.calls = 0
        # (op, group size) -> [calls, result bytes]
        self.traffic: Dict[Tuple[str, int], List[int]] = {}

    def _count(self, op: str, result: torch.Tensor, group) -> None:
        import torch.distributed as dist
        self.calls += 1
        key = (op, dist.get_world_size(group))
        rec = self.traffic.setdefault(key, [0, 0])
        rec[0] += 1
        rec[1] += result.numel() * result.element_size()

    # -- schedule selection ---------------------------------------------------
    def pick_schedule(self, mesh) -> str:
        c: CollectiveConfig = self.config
        if c.schedule != "auto":
            return c.schedule
        if mesh is None:
            return "flat"
        _check_mesh(mesh)
        return ("hierarchical" if c.pod_axis in mesh.mesh_dim_names
                else "flat")

    # -- the group primitives -------------------------------------------------
    def _reduce(self, x: torch.Tensor, group, op: str) -> torch.Tensor:
        import torch.distributed as dist
        self._count("all-reduce", x, group)
        y = x.clone()
        if not y.is_meta:
            dist.all_reduce(y, op={"sum": dist.ReduceOp.SUM,
                                   "max": dist.ReduceOp.MAX}[op],
                            group=group)
        return y

    def broadcast(self, x: torch.Tensor, mesh, axis: str,
                  src: int = 0) -> torch.Tensor:
        """``x`` of the rank at coordinate ``src`` of ``axis``, on every
        rank of that dim's group (in place; returns ``x``)."""
        import torch.distributed as dist
        _check_mesh(mesh)
        g = mesh.get_group(axis)
        self._count("broadcast", x, g)
        if not x.is_meta:
            dist.broadcast(x, src=dist.get_global_rank(g, src), group=g)
        return x

    # -- reductions -----------------------------------------------------------
    def all_reduce(self, x: torch.Tensor, mesh=None,
                   axes: Optional[Tuple[str, ...]] = None, *,
                   op: str = "sum") -> torch.Tensor:
        """Schedule-aware all-reduce; returns a new tensor.

        Default (``axes=None``): reduce over the data-parallel dims with
        the configured schedule (flat vs hierarchical RS/AR/AG) — the
        gradient path.  ``axes=(...,)`` overrides the dim set and always
        reduces flat: the tensor-parallel serving path sums attention/MLP
        partials over ``model`` this way (``repro_torch.serve.tp``).
        ``op="max"`` (with ``axes``) is the context-parallel softmax's
        running max.  ``mesh=None`` is a single process: ``x`` itself."""
        if mesh is None:
            return x
        _check_mesh(mesh)
        names = mesh.mesh_dim_names
        if axes is not None:
            axes = tuple(a for a in axes if a in names)
            for a in axes:
                x = self._reduce(x, mesh.get_group(a), op)
            return x
        if op != "sum":
            raise ValueError("a schedule reduces by sum; pass axes= for "
                             f"op={op!r}")
        sched = self.pick_schedule(mesh)
        c: CollectiveConfig = self.config
        if sched == "hierarchical" and c.pod_axis in names:
            return self._hierarchical_ar(x, mesh, c.data_axis, c.pod_axis)
        for a in (c.pod_axis, c.data_axis):
            if a in names:
                x = self._reduce(x, mesh.get_group(a), "sum")
        return x

    def _hierarchical_ar(self, x: torch.Tensor, mesh, data_axis: str,
                         pod_axis: str) -> torch.Tensor:
        """reduce-scatter(data) -> all-reduce(pod) -> all-gather(data).

        Inter-pod traffic drops by the data-dim size versus a flat
        all-reduce over (pod, data): only 1/|data| of the tensor crosses
        the pod boundary."""
        import torch.distributed as dist
        gd = mesh.get_group(data_axis)
        n = dist.get_world_size(gd)
        flat = x.reshape(-1)
        n_elems = flat.numel()
        pad = (-n_elems) % n
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        flat = flat.contiguous()
        part = flat.new_empty(flat.numel() // n)
        self._count("reduce-scatter", part, gd)
        if not flat.is_meta:
            dist.reduce_scatter_tensor(part, flat, group=gd)
        part = self._reduce(part, mesh.get_group(pod_axis), "sum")
        full = part.new_empty(part.numel() * n)
        self._count("all-gather", full, gd)
        if not part.is_meta:
            dist.all_gather_into_tensor(full, part, group=gd)
        return full[:n_elems].reshape(x.shape)

    def all_gather(self, x: torch.Tensor, mesh, axis: str,
                   dim: int = 0) -> torch.Tensor:
        """The ranks' ``x`` along ``axis``, concatenated on ``dim`` in
        coordinate order (JAX's ``all_gather(tiled=True)``)."""
        import torch.distributed as dist
        _check_mesh(mesh)
        g = mesh.get_group(axis)
        n = dist.get_world_size(g)
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        self._count("all-gather", out, g)
        if not src.is_meta:
            dist.all_gather_into_tensor(out, src, group=g)
        return out.movedim(0, dim)

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

    def rdma_write(self, x: torch.Tensor, qp: int, *, mesh,
                   pod_axis: Optional[str] = None) -> torch.Tensor:
        """One-sided write to the peer pod (``ppermute`` over ``pod``):
        the destination pod's ranks get the source pod's ``x`` from the
        rank at their own coordinates; every other rank gets zeros, as
        ``ppermute`` gives a device no pair sends to.

        Gloo has no send/recv of CUDA tensors: on a gloo group a CUDA
        operand is copied to the host and back, and each copy is counted
        in ``host_copies``."""
        import torch.distributed as dist
        _check_mesh(mesh)
        c: CollectiveConfig = self.config
        axis = pod_axis or c.pod_axis
        g = mesh.get_group(axis)
        me = mesh.get_local_rank(axis)
        staged = x.is_cuda and dist.get_backend(g) == "gloo"
        out = torch.zeros_like(x)
        for src, dst in self.qp_permutation(qp, dist.get_world_size(g)):
            if me == src:
                buf = x.contiguous()
                if staged:
                    buf = buf.cpu()
                    self.host_copies += 1
                self._count("collective-permute", buf, g)
                dist.send(buf, dst=dist.get_global_rank(g, dst), group=g)
            elif me == dst:
                buf = torch.zeros_like(x, device="cpu") if staged else out
                self._count("collective-permute", buf, g)
                dist.recv(buf, src=dist.get_global_rank(g, src), group=g)
                if staged:
                    self.host_copies += 1
                out = buf.to(x.device)
        return out

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
        s["host_copies"] = self.host_copies
        return s
