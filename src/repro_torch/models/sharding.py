"""Sharding policy: maps logical parameter/activation dims to mesh dims.

Twin of ``repro.models.sharding``.  The production mesh is ``(data=16,
model=16)`` per pod and ``(pod=2, data=16, model=16)`` across pods (see
``launch/mesh.py``).  Parameters are 2D-sharded: FSDP along ``data``
(+``pod``), tensor-parallel along ``model``.  Every rule degrades to
replication when a dim is not divisible by the dim's size.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh``; a spec is the
port's :class:`P`, a tuple of dim names (or ``None``) per tensor axis, as
JAX's ``PartitionSpec``.  Eager PyTorch has no sharding propagation:
:func:`local_shard` cuts a rank's block out of a full tensor,
:func:`reshard` turns a rank's block under one spec into its block under
another (gathering through a collective service where the specs differ),
:func:`shard_shape` is a block's shape, and :func:`constrain` is the
identity.

:class:`ShardedCompute` is how one rank of a mesh computes its part of a
model with Megatron's tensor parallelism on ``model``: the two
``torch.autograd.Function`` s ``_EnterTP`` (identity forward, all-reduce
backward; at a block's entry, after its norm) and ``_ExitTP``
(all-reduce forward, identity backward; after the attention's
out-projection and the FFN's ``w_down``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Tuple, Union

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


def _dims(entry: Axis) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _axes(spec: Optional[P], ndim: int) -> Tuple[Tuple[str, ...], ...]:
    """A spec's dims per tensor axis, padded with () to ``ndim``."""
    entries = tuple(_dims(e) for e in (spec or ()))
    return entries + ((),) * (ndim - len(entries))


def _size(mesh, dim: str) -> int:
    return int(mesh.size(mesh.mesh_dim_names.index(dim)))


def _cut(x: torch.Tensor, mesh, axis: int, dims: Tuple[str, ...],
         spec=None) -> torch.Tensor:
    """This rank's block of ``x`` along ``axis`` split over ``dims``
    (several: the first is the outer)."""
    n, idx = 1, 0
    for d in dims:
        size = _size(mesh, d)
        idx = idx * size + mesh.get_local_rank(d)
        n *= size
    if n == 1:
        return x
    if x.shape[axis] % n:
        raise ValueError(f"axis {axis} of size {x.shape[axis]} does not "
                         f"split into {n} blocks for spec {spec}")
    return x.chunk(n, dim=axis)[idx]


def local_shard(x: torch.Tensor, mesh, spec: Optional[P]) -> torch.Tensor:
    """This rank's block of the full tensor ``x`` under ``spec``: each axis
    named by the spec is cut into equal contiguous blocks, one per
    coordinate of its mesh dims (several dims: the first is the outer).
    Returns a contiguous copy."""
    for axis, dims in enumerate(_axes(spec, x.dim())):
        x = _cut(x, mesh, axis, dims, spec)
    return x.contiguous()


def flatten_specs(tree, prefix: str = "") -> dict:
    """A spec tree of dicts and tuples -> {"a/b/0/c": P}, the keys
    ``optim.adamw.flatten`` gives the congruent tensor tree (a ``P`` is a
    tuple, and a leaf here)."""
    if isinstance(tree, (dict, tuple)) and not isinstance(tree, P):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(flatten_specs(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def shard_shape(shape, mesh, spec: Optional[P]) -> Tuple[int, ...]:
    """The shape of one rank's block of a tensor of ``shape`` under
    ``spec``."""
    out = list(shape)
    for axis, dims in enumerate(_axes(spec, len(out))):
        for d in dims:
            out[axis] //= _size(mesh, d)
    return tuple(out)


def reshard(x: torch.Tensor, mesh, src: Optional[P], dst: Optional[P],
            collectives) -> torch.Tensor:
    """This rank's block ``x`` under ``src`` -> its block under ``dst``.
    Each axis whose dims differ is gathered over ``src``'s dims (through
    ``collectives.all_gather``, the inner dim first; dims of size 1 move
    nothing) and cut by ``dst``'s; an axis whose dims agree is left as it
    is.  Every rank of the touched dims must call it, in the same
    order."""
    for axis, (s, d) in enumerate(zip(_axes(src, x.dim()),
                                      _axes(dst, x.dim()))):
        if s == d:
            continue
        for name in reversed(s):
            if _size(mesh, name) > 1:
                x = collectives.all_gather(x, mesh, name, dim=axis)
        x = _cut(x, mesh, axis, d, dst)
    return x


class _EnterTP(torch.autograd.Function):
    """Megatron's ``f``: identity forward, all-reduce of the gradient over
    the model group backward (the split projections' input gradients are
    partial sums)."""

    @staticmethod
    def forward(ctx, x, reduce):
        ctx.reduce = reduce
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.reduce(grad), None


class _ExitTP(torch.autograd.Function):
    """Megatron's ``g``: all-reduce of the partial outputs over the model
    group forward, identity backward."""

    @staticmethod
    def forward(ctx, x, reduce):
        return reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


@dataclass
class ShardedCompute:
    """One rank's share of a model's compute on a mesh.

    ``attn``/``mlp``: the attention heads / the SwiGLU columns are split on
    ``model`` (``serve.tp.tp_plan``); the model then runs on the rank's
    heads (a local config) and wraps each split part in ``enter`` and
    ``exit``.  ``reduce`` sums a tensor over the model group.
    ``frac_mean``: the MoE load-balancing loss's routed fractions averaged
    over the ranks that split the batch (training only)."""
    attn: bool = False
    mlp: bool = False
    reduce: Optional[Callable] = None
    frac_mean: Optional[Callable] = None

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _EnterTP.apply(x, self.reduce)

    def exit(self, x: torch.Tensor) -> torch.Tensor:
        return _ExitTP.apply(x, self.reduce)
