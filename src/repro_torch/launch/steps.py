"""Step builders shared by the dry run, the trainer and the server.

Twin of ``repro.launch.steps``.  Each builder returns a
:class:`StepBundle`: the step function, its abstract inputs (``meta``
tensors of the GLOBAL shapes, the port's ``jax.eval_shape``) and their
sharding trees (:class:`~repro_torch.models.sharding.NamedSharding` of
``P`` specs).

JAX runs one program over the whole mesh; ``torch.distributed`` runs one
process per rank.  So a bundle's ``fn`` is the step as seen from one rank:
it takes the rank's blocks of the inputs under ``in_shardings`` and
returns its blocks of the outputs under ``out_shardings``, and every rank
of the mesh calls it, in the same order.  Inside, each parameter is
gathered (``sharding.reshard``) from its storage spec (``param_specs``)
to its compute spec: whole, except that on ``model`` the attention heads
and the SwiGLU columns stay split where ``serve.tp.tp_plan`` splits them,
and the model runs on the rank's heads with Megatron's pair
(``ShardedCompute``).  Where the plan replicates (MoE, GELU, heads that
do not divide, the ``zero3`` scheme), the compute is replicated.  Every
step gathers its weights, the serving steps as the train step.

The train step (``make_train_bundle``) computes the single-device step's
function: the loss and gradients of the rank's rows of the batch
(``rules.batch``), accumulated over ``microbatches`` sequential
micro-steps of those rows; the split leaves' gradients gathered over
``model`` to their full shapes; every gradient averaged over the dims that
split the batch; compression (int8 with error feedback, the residuals
stored under the parameters' specs) on the averaged gradients; the global
norm taken once over the full averaged gradients; AdamW on the rank's
shards of the parameters and moments.  The logged ``loss`` and
``aux_loss`` are the means over the batch's ranks and ``tokens`` their
sum.  The MoE load-balancing loss's routed fractions are averaged over
the batch's ranks too, so a split batch gives the whole batch's aux loss.

Every collective goes through one
:class:`~repro_torch.core.services.collectives.CollectiveService`
(``collectives``; a fresh one when None) on the mesh's groups.  The
Megatron all-reduces of the backward run inside ``torch.autograd.grad``
(on the autograd engine's thread for CUDA tensors, in the graph's order,
the same on every rank, while the calling thread waits); all others are
issued from the calling thread in program order.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core.services.collectives import CollectiveService
from repro_torch.core.static_layer import build_eager, local_specs
from repro_torch.models import transformer as T
from repro_torch.models.sharding import (MeshRules, NamedSharding, P,
                                         ShardedCompute, _dims, _size,
                                         flatten_specs, local_shard, reshard)
from repro_torch.optim import adamw
from repro_torch.serve.tp import tp_plan
from repro_torch.telemetry import spans


@dataclass
class StepBundle:
    name: str
    fn: Callable
    abstract_args: Tuple[Any, ...]
    in_shardings: Tuple[Any, ...]
    out_shardings: Any
    donate_argnums: Tuple[int, ...]
    static_broadcast: Tuple[int, ...] = ()

    def jitted(self) -> Callable:
        """The eager step as seen from this rank, bound to the mesh (its
        arguments are the rank's blocks, the donated ones updated in
        place where the layout allows)."""
        return self.fn

    def local_args(self) -> Tuple[Any, ...]:
        """``meta`` tensors of this rank's block shapes of
        ``abstract_args`` under ``in_shardings``."""
        return pytree.tree_map(lambda s: s.meta(), local_specs(
            self.abstract_args, self.in_shardings))

    def lower(self):
        """The meta-device build (``static_layer.build_eager``): the step
        run once on this rank's block shapes, which checks every shape
        and allocates nothing.  Returns ``(fn, lower_s, compile_s)``."""
        return build_eager(self.fn, self.local_args())


def _ns(mesh, tree):
    return pytree.tree_map(lambda sp: NamedSharding(mesh, sp), tree,
                           is_leaf=lambda x: isinstance(x, P))


def _abstract_params(cfg: ModelConfig, dtype) -> Dict:
    """``init_params``' tree as ``meta`` tensors: it runs under a fake
    tensor mode, so nothing is drawn or allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        fake = T.init_params(cfg, generator=torch.Generator(), dtype=dtype,
                             device="cpu")
    return pytree.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), fake)


def _batch_abstract(cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    b, s = shape.global_batch, shape.seq_len
    batch = {"tokens": torch.empty((b, s), dtype=torch.int32, device="meta")}
    if cfg.n_encoder_layers:
        batch["frames"] = torch.empty((b, cfg.encoder_seq_len, cfg.d_model),
                                      dtype=torch.bfloat16, device="meta")
    return batch


def _batch_specs(cfg: ModelConfig, shape: ShapeConfig, rules: MeshRules):
    bax = rules.batch(shape.global_batch)
    specs = {"tokens": P(bax, None)}
    if cfg.n_encoder_layers:
        specs["frames"] = P(bax, None, None)
    return specs


class _Layout:
    """A rank's compute layout on a mesh: the local config, the Megatron
    hooks and each leaf's compute spec."""

    def __init__(self, cfg: ModelConfig, mesh, rules: MeshRules,
                 svc: CollectiveService):
        self.mesh, self.svc = mesh, svc
        names = tuple(mesh.mesh_dim_names)
        tp = rules.tp_size if rules.tp_axis in names else 0
        plan = tp_plan(cfg, tp)
        self.shard_heads, self.shard_mlp = (plan["shard_heads"],
                                            plan["shard_mlp"])
        self.cfg = (dataclasses.replace(
            cfg, n_heads=cfg.n_heads // tp, n_kv_heads=cfg.n_kv_heads // tp,
            head_dim=cfg.resolved_head_dim) if self.shard_heads else cfg)
        self.axis = rules.tp_axis

    def sharded(self, frac_mean=None) -> Optional[ShardedCompute]:
        if not (self.shard_heads or self.shard_mlp or frac_mean):
            return None
        return ShardedCompute(
            attn=self.shard_heads, mlp=self.shard_mlp,
            reduce=lambda x: self.svc.all_reduce(x, self.mesh,
                                                 axes=(self.axis,)),
            frac_mean=frac_mean)

    def param_compute_specs(self, params) -> Dict:
        """P() (whole) for every leaf, but the split attention and SwiGLU
        matrices: columns (``wq/wk/wv``, their biases, ``w_gate/w_up``) or
        rows (``wo``, ``w_down``) on ``model``, whatever axes lead."""
        ax = self.axis

        def cols(x):
            return P(*((None,) * (x.dim() - 1) + (ax,)))

        def rows(x):
            return P(*((None,) * (x.dim() - 2) + (ax, None)))

        def walk(node, key):
            if not isinstance(node, (dict, tuple)):
                return P()
            if isinstance(node, tuple):
                return tuple(walk(v, key) for v in node)
            if key in ("attn", "xattn") and self.shard_heads:
                return {k: rows(v) if k == "wo" else cols(v)
                        for k, v in node.items()}
            if key == "ffn" and self.shard_mlp and "w_gate" in node:
                return {k: rows(v) if k == "w_down" else cols(v)
                        for k, v in node.items()}
            return {k: walk(v, k) for k, v in node.items()}
        return walk(params, "")

    def cache_compute_specs(self, cspec, cp: bool) -> Dict:
        """A cache's storage specs with ``model`` taken out, but on the KV
        head axis when the heads are split and on the sequence axis of a
        context-parallel cache: the layout the rank's step computes on."""
        ax = self.axis

        def keep(sp, path):
            key = path.rsplit("/", 1)[-1]
            out = []
            for i, e in enumerate(sp):
                dims = tuple(d for d in _dims(e)
                             if d != ax
                             or (i == 3 and key in ("k", "v", "xk", "xv")
                                 and self.shard_heads)
                             or (i == 2 and key in ("k", "v") and cp))
                out.append(None if not dims else
                           dims[0] if len(dims) == 1 else dims)
            return P(*out)
        flat = flatten_specs(cspec)
        return adamw.unflatten({k: keep(v, k) for k, v in flat.items()})


def _reshard_tree(tree, src, dst, layout: _Layout):
    fs, fd = flatten_specs(src), flatten_specs(dst)
    flat = {k: reshard(x, layout.mesh, fs[k], fd[k], layout.svc)
            for k, x in adamw.flatten(tree).items()}
    return adamw.unflatten(flat)


def _cut_tree(tree, specs, mesh):
    fs = flatten_specs(specs)
    return adamw.unflatten({k: local_shard(x, mesh, fs[k])
                            for k, x in adamw.flatten(tree).items()})


# ================================================================= train ===
def make_train_bundle(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                      remat: str = "dots",
                      compute_dtype=torch.bfloat16,
                      opt_cfg: Optional[adamw.AdamWConfig] = None,
                      param_dtype=torch.float32,
                      microbatches: int = 1,
                      compression=None,
                      attention_impl: str = "ref",
                      param_scheme: str = "2d",
                      cast_params_bf16: bool = False,
                      collectives: Optional[CollectiveService] = None
                      ) -> StepBundle:
    """``microbatches`` > 1 accumulates gradients over sequential
    micro-steps of the rank's rows (memory lever); ``compression`` is an
    optional GradCompression service whose error-feedback state rides in
    opt_state["ef"].  ``attention_impl`` is kept for the reference's
    keywords: the device picks the attention path.  The step records the
    Trainer's ``train.step`` span, with ``train.forward`` and
    ``train.backward`` for each micro-step and ``train.optimizer``
    (``repro_torch.telemetry.spans``)."""
    rules = MeshRules.from_mesh(mesh, scheme=param_scheme)
    opt_cfg = opt_cfg or adamw.AdamWConfig()
    svc = collectives if collectives is not None else CollectiveService()
    if shape.global_batch % microbatches:
        raise ValueError(f"global batch {shape.global_batch} does not split "
                         f"into {microbatches} microbatches")
    bax = _dims(rules.batch(shape.global_batch))
    n_batch = math.prod(_size(mesh, d) for d in bax)
    if (shape.global_batch // n_batch) % microbatches:
        raise ValueError(f"a rank's {shape.global_batch // n_batch} rows do "
                         f"not split into {microbatches} microbatches")
    lay = _Layout(cfg, mesh, rules, svc)
    fused = attention_impl == "fused"
    ef_on = compression is not None and compression.config.error_feedback

    params_abs = _abstract_params(cfg, param_dtype)
    pspec = T.param_specs(cfg, rules)
    fps = flatten_specs(pspec)
    fcs = flatten_specs(lay.param_compute_specs(params_abs))
    ospec = adamw.state_specs(pspec)
    moments = pytree.tree_map(lambda x: torch.empty(
        x.shape, dtype=torch.float32, device="meta"), params_abs)
    opt_abs = {"m": moments, "v": moments,
               "step": torch.empty((), dtype=torch.int32, device="meta")}
    if ef_on:
        ospec = dict(ospec, ef=pspec)
        opt_abs["ef"] = moments
    bspec = _batch_specs(cfg, shape, rules)

    def batch_mean(x):
        if n_batch == 1:
            return x
        return svc.all_reduce(x, mesh, axes=bax) / n_batch

    sharded = lay.sharded(frac_mean=batch_mean if cfg.moe is not None
                          and n_batch > 1 else None)

    def loss_grads(comp, leaves, mb):
        dev = leaves[0].device
        with spans.span("train.forward", device=dev):
            loss, m = T.loss_fn(comp, lay.cfg, mb, remat=remat, rules=rules,
                                compute_dtype=compute_dtype,
                                fused_attention=fused, sharded=sharded)
        with spans.span("train.backward", device=dev):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for g, x in zip(grads, leaves)]
        return grads, torch.stack([m["loss"].detach().float(),
                                   m["aux_loss"].detach().float(),
                                   m["tokens"].detach().float()])

    def train_step(params, opt_state, batch):
        with spans.span("train.step"):
            return _train_step(params, opt_state, batch)

    def _train_step(params, opt_state, batch):
        comp = {}
        for k, p in adamw.flatten(params).items():
            x = p.detach()
            if cast_params_bf16 and x.dtype == torch.float32 and x.dim() >= 2:
                # cast BEFORE the gathers so they move bf16
                x = x.to(torch.bfloat16)
            comp[k] = reshard(x, mesh, fps[k], fcs[k], svc).requires_grad_()
        ctree, leaves = adamw.unflatten(comp), list(comp.values())
        if microbatches == 1:
            grads, msum = loss_grads(ctree, leaves, batch)
        else:
            rows = next(iter(batch.values())).shape[0] // microbatches
            grads, msum = None, None
            for i in range(microbatches):
                mb = {n: v[i * rows:(i + 1) * rows] for n, v in batch.items()}
                g, m = loss_grads(ctree, leaves, mb)
                g = [x.float() for x in g]
                grads = g if grads is None else [a + b for a, b in
                                                 zip(grads, g)]
                msum = m if msum is None else msum + m
            grads = [g / microbatches for g in grads]
            msum = msum * torch.tensor([1 / microbatches, 1 / microbatches,
                                        1.0], device=msum.device)
        del ctree, leaves, comp
        # full shapes (the split leaves gathered over model), one bucket
        full = {k: reshard(g.float(), mesh, fcs[k], P(), svc)
                for k, g in zip(list(adamw.flatten(params)), grads)}
        del grads
        if n_batch > 1:
            flat = torch.cat([g.reshape(-1) for g in full.values()])
            flat = svc.all_reduce(flat, mesh, axes=bax) / n_batch
            out, off = {}, 0
            for k, g in full.items():
                out[k] = flat[off:off + g.numel()].view_as(g)
                off += g.numel()
            full = out
            msum = svc.all_reduce(msum, mesh, axes=bax)
            msum = msum * torch.tensor([1 / n_batch, 1 / n_batch, 1.0],
                                       device=msum.device)
        grads = adamw.unflatten(full)
        with spans.span("train.optimizer", device=msum.device):
            opt_state = dict(opt_state)
            new_ef = None
            if compression is not None:
                ef = opt_state.pop("ef", None)
                if ef is not None:
                    ef = _reshard_tree(ef, pspec, adamw.unflatten(
                        {k: P() for k in fps}), lay)
                grads, new_ef, _ = compression.apply(grads, ef)
            gnorm = adamw.global_norm(grads)
            shards = _cut_tree(grads, pspec, mesh)
            del grads, full
            params, opt_state, om = adamw.update(shards, opt_state, params,
                                                 opt_cfg, grad_norm=gnorm)
            if new_ef is not None:
                opt_state["ef"] = _cut_tree(new_ef, pspec, mesh)
        metrics = {"loss": msum[0], "aux_loss": msum[1], "tokens": msum[2]}
        metrics.update(om)
        return params, opt_state, metrics

    return StepBundle(
        name=f"train[{cfg.arch_id}/{shape.name}]",
        fn=train_step,
        abstract_args=(params_abs, opt_abs, _batch_abstract(cfg, shape)),
        in_shardings=(_ns(mesh, pspec), _ns(mesh, ospec), _ns(mesh, bspec)),
        out_shardings=(_ns(mesh, pspec), _ns(mesh, ospec),
                       NamedSharding(mesh, P())),
        donate_argnums=(0, 1),
    )


# =============================================================== prefill ===
def make_prefill_bundle(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                        param_dtype=torch.bfloat16,
                        cache_dtype=torch.bfloat16,
                        attention_impl: str = "ref",
                        serving_params: bool = False,
                        collectives: Optional[CollectiveService] = None
                        ) -> StepBundle:
    rules = MeshRules.from_mesh(mesh)
    if serving_params:
        rules = rules.serving()
    svc = collectives if collectives is not None else CollectiveService()
    lay = _Layout(cfg, mesh, rules, svc)
    max_len = shape.seq_len
    fused = attention_impl == "fused"
    sharded = lay.sharded()

    params_abs = _abstract_params(cfg, param_dtype)
    pspec = T.param_specs(cfg, rules)
    pcomp = lay.param_compute_specs(params_abs)
    bspec = _batch_specs(cfg, shape, rules)
    cspec = T.cache_specs(cfg, rules, shape.global_batch, max_len)
    ccomp = lay.cache_compute_specs(cspec, cp=False)
    bax = rules.batch(shape.global_batch)
    logits_spec = P(bax, rules.tp(cfg.padded_vocab))

    def prefill_step(params, batch):
        comp = _reshard_tree(params, pspec, pcomp, lay)
        logits, cache = T.prefill(comp, lay.cfg, batch["tokens"], max_len,
                                  encoder_frames=batch.get("frames"),
                                  rules=rules, cache_dtype=cache_dtype,
                                  fused_attention=fused, sharded=sharded)
        return (reshard(logits, mesh, P(bax, None), logits_spec, svc),
                _reshard_tree(cache, ccomp, cspec, lay))

    return StepBundle(
        name=f"prefill[{cfg.arch_id}/{shape.name}]",
        fn=prefill_step,
        abstract_args=(params_abs, _batch_abstract(cfg, shape)),
        in_shardings=(_ns(mesh, pspec), _ns(mesh, bspec)),
        out_shardings=(NamedSharding(mesh, logits_spec), _ns(mesh, cspec)),
        donate_argnums=(),
    )


# ================================================================ decode ===
def make_decode_bundle(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                       param_dtype=torch.bfloat16,
                       cache_dtype=torch.bfloat16,
                       attention_impl: str = "ref",
                       uniform_pos: bool = False,
                       context_parallel: bool = False,
                       serving_params: bool = False,
                       collectives: Optional[CollectiveService] = None
                       ) -> StepBundle:
    """A cache sequence-sharded on ``model`` (KV heads that do not divide
    the TP degree) attends context-parallel when ``context_parallel``
    holds (the reference's condition); otherwise each step gathers the
    layers' blocks whole, writes and attends, and keeps its own block, as
    the reference's partitioner does without it."""
    rules = MeshRules.from_mesh(mesh)
    if serving_params:
        rules = rules.serving()       # TP-only weights: no FSDP gathers
    svc = collectives if collectives is not None else CollectiveService()
    lay = _Layout(cfg, mesh, rules, svc)
    b = shape.global_batch
    max_len = shape.seq_len
    fused = attention_impl == "fused"
    sharded = lay.sharded()
    # context-parallel decode only applies when the cache is seq-sharded
    kl = T.decode_cache_len(cfg, max_len)
    cp = (mesh if context_parallel and rules.tp(cfg.n_kv_heads) is None
          and rules.tp_size and kl % rules.tp_size == 0 else None)

    params_abs = _abstract_params(cfg, param_dtype)
    cache_abs = T.init_cache(cfg, b, max_len, dtype=cache_dtype,
                             device="meta", enc_seq=cfg.encoder_seq_len)
    tok_abs = torch.empty((b, 1), dtype=torch.int32, device="meta")
    pos_abs = torch.empty((b,), dtype=torch.int32, device="meta")

    pspec = T.param_specs(cfg, rules)
    pcomp = lay.param_compute_specs(params_abs)
    cspec = T.cache_specs(cfg, rules, b, max_len)
    ccomp = lay.cache_compute_specs(cspec, cp=cp is not None)
    bax = rules.batch(b)
    logits_spec = P(bax, rules.tp(cfg.padded_vocab))

    def serve_step(params, cache, tokens, pos):
        comp = _reshard_tree(params, pspec, pcomp, lay)
        work = _reshard_tree(cache, cspec, ccomp, lay)
        logits, work = T.decode_step(comp, lay.cfg, work, tokens, pos,
                                     fused_attention=fused,
                                     uniform_pos=uniform_pos, cp_mesh=cp,
                                     sharded=sharded, collectives=svc)
        return (reshard(logits, mesh, P(bax, None), logits_spec, svc),
                _reshard_tree(work, ccomp, cspec, lay))

    return StepBundle(
        name=f"decode[{cfg.arch_id}/{shape.name}]",
        fn=serve_step,
        abstract_args=(params_abs, cache_abs, tok_abs, pos_abs),
        in_shardings=(_ns(mesh, pspec), _ns(mesh, cspec),
                      NamedSharding(mesh, P(bax, None)),
                      NamedSharding(mesh, P(bax))),
        out_shardings=(NamedSharding(mesh, logits_spec), _ns(mesh, cspec)),
        donate_argnums=(1,),
    )


def make_bundle(cfg: ModelConfig, shape: ShapeConfig, mesh,
                **kw) -> StepBundle:
    if shape.kind == "train":
        return make_train_bundle(cfg, shape, mesh, **kw)
    if shape.kind == "prefill":
        return make_prefill_bundle(cfg, shape, mesh, **kw)
    return make_decode_bundle(cfg, shape, mesh, **kw)
