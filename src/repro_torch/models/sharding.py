"""Sharding policy: maps logical parameter/activation dims to mesh dims.

Twin of ``repro.models.sharding``.  The production mesh is ``(data=16,
model=16)`` per pod and ``(pod=2, data=16, model=16)`` across pods (see
``launch/mesh.py``).  Parameters are 2D-sharded: FSDP along ``data``
(+``pod``), tensor-parallel along ``model``.  Every rule degrades to
replication when a dim is not divisible by the dim's size.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh``; a spec is the
port's :class:`P`, a tuple of dim names (or ``None``) per tensor axis, as
JAX's ``PartitionSpec``.  Eager PyTorch has no sharding propagation:
:func:`local_shard` cuts a rank's block out of a full tensor, and
:func:`constrain` is the identity.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]


class P(tuple):
    """A partition spec: one entry per tensor axis, each ``None``
    (replicated), a mesh dim name or a tuple of names."""

    def __new__(cls, *axes: Axis):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass(frozen=True)
class MeshRules:
    """Divisibility-checked logical->mesh dim mapping.

    ``shard_params_fsdp=False`` is SERVING mode: parameters are TP-only
    (no FSDP row-sharding), so decode never all-gathers weights — each
    step reads its local TP shard.  The batch keeps sharding on the data
    dims either way."""

    fsdp_axes: Tuple[str, ...]   # ("data",) or ("pod", "data")
    tp_axis: str                 # "model"
    fsdp_size: int
    tp_size: int
    shard_params_fsdp: bool = True

    # -- parameter dims --
    def fsdp(self, dim: int) -> Axis:
        if not self.shard_params_fsdp:
            return None
        if self.fsdp_size > 0 and dim % self.fsdp_size == 0:
            return self.fsdp_axes if len(self.fsdp_axes) > 1 else self.fsdp_axes[0]
        return None

    def tp(self, dim: int) -> Axis:
        if self.tp_size > 0 and dim % self.tp_size == 0:
            return self.tp_axis
        return None

    # -- activation dims --
    def batch(self, dim: int) -> Axis:
        if self.fsdp_size > 0 and dim % self.fsdp_size == 0:
            return self.fsdp_axes if len(self.fsdp_axes) > 1 else self.fsdp_axes[0]
        return None

    def serving(self) -> "MeshRules":
        return dataclasses.replace(self, shard_params_fsdp=False)

    @classmethod
    def from_mesh(cls, mesh, scheme: str = "2d") -> "MeshRules":
        """scheme='2d':   FSDP rows on (pod, data) x TP columns on model.
        scheme='zero3':   pure FSDP over EVERY dim — no tensor
        parallelism, so no per-block activation all-reduces."""
        if scheme not in ("2d", "zero3"):
            raise ValueError(
                f"unknown MeshRules scheme {scheme!r}: expected '2d' "
                "(FSDP rows x TP columns) or 'zero3' (pure FSDP)")
        names = tuple(mesh.mesh_dim_names)
        sizes = dict(zip(names, (int(s) for s in mesh.shape)))
        if scheme == "zero3":
            fsdp_size = 1
            for a in names:
                fsdp_size *= sizes[a]
            return cls(fsdp_axes=names, tp_axis="model",
                       fsdp_size=fsdp_size, tp_size=0)
        fsdp_axes = tuple(a for a in names if a in ("pod", "data"))
        fsdp_size = 1
        for a in fsdp_axes:
            fsdp_size *= sizes[a]
        return cls(fsdp_axes=fsdp_axes or ("data",), tp_axis="model",
                   fsdp_size=fsdp_size, tp_size=sizes.get("model", 1))

    @classmethod
    def single_device(cls) -> "MeshRules":
        """Degenerate rules: everything replicated (CPU smoke tests)."""
        return cls(fsdp_axes=("data",), tp_axis="model", fsdp_size=0, tp_size=0)


@dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh (JAX's ``NamedSharding``)."""
    mesh: object
    spec: P


def named(mesh, spec: P) -> NamedSharding:
    return NamedSharding(mesh, spec)


def constrain(x, spec: P):
    """The reference's ``with_sharding_constraint`` outside a mesh
    context: eager tensors carry no sharding, so it is the identity."""
    return x


def local_shard(x: torch.Tensor, mesh, spec: Optional[P]) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec``: each axis
    named by the spec is cut into equal contiguous blocks, one per
    coordinate of its mesh dims (several dims: the first is the outer).
    Returns a contiguous copy."""
    if spec is None:
        return x.contiguous()
    for axis, dims in enumerate(spec):
        if dims is None:
            continue
        dims = (dims,) if isinstance(dims, str) else tuple(dims)
        n, idx = 1, 0
        for d in dims:
            size = mesh.size(mesh.mesh_dim_names.index(d))
            idx = idx * size + mesh.get_local_rank(d)
            n *= size
        if x.shape[axis] % n:
            raise ValueError(f"axis {axis} of size {x.shape[axis]} does not "
                             f"split into {n} blocks for spec {spec}")
        x = x.chunk(n, dim=axis)[idx]
    return x.contiguous()
