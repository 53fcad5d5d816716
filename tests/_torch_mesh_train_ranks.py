"""Rank bodies of the port's mesh-bound launcher twins.

``repro_torch.launch.mesh.run_ranks`` starts each rank with ``spawn`` and
calls one of these functions there as ``fn(rank, world, device, ...)``.
They import neither JAX nor the JAX package, so a rank starts with torch
and the port alone; the test files compare what the ranks return with
the JAX package in the parent.  Weights arrive as numpy trees
(``params.from_reference``); every result is numpy or plain Python.
"""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.services.collectives import CollectiveService
from repro_torch.core.services.compression import (CompressionConfig,
                                                   GradCompression)
from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.launch.steps import (make_decode_bundle, make_prefill_bundle,
                                      make_train_bundle)
from repro_torch.models.params import from_reference
from repro_torch.models.sharding import P, flatten_specs, local_shard
from repro_torch.optim import adamw
from repro_torch.train.loop import TrainConfig, Trainer

torch.set_num_threads(1)

SHAPE = ShapeConfig("t", "train", 32, 4)
STEPS, SEED = 3, 2


def _cfg(arch, overrides=None):
    return dataclasses.replace(get_config(arch).reduced(), **(overrides or {}))


def _tcfg(ckpt_dir, **kw):
    kw = dict(dict(steps=STEPS, ckpt_every=0), **kw)
    return TrainConfig(log_every=1, seed=SEED, ckpt_dir=ckpt_dir,
                       batch_timeout_s=60.0, **kw)


def _compression():
    return GradCompression(CompressionConfig(bits=8, error_feedback=True))


def _log(metrics_log):
    return [(m["loss"], m["grad_norm"], m["lr"]) for m in metrics_log]


def _bundle_run(cfg, mesh, np_params, scheme):
    """STEPS steps of ``make_train_bundle(param_scheme=scheme)`` driven by
    hand on the Trainer's data: the bundle's own contract, without the
    Trainer."""
    b = make_train_bundle(cfg, SHAPE, mesh, remat="none", compute_dtype=None,
                          param_scheme=scheme)
    specs = [{k: sh.spec for k, sh in flatten_specs(t).items()}
             for t in (b.in_shardings[0], b.in_shardings[2])]
    full = from_reference(np_params, device="cpu")
    params = adamw.unflatten({k: local_shard(x, mesh, specs[0][k])
                              for k, x in adamw.flatten(full).items()})
    opt = adamw.init(params)
    corpus = SyntheticCorpus(DataConfig(
        seq_len=SHAPE.seq_len, global_batch=SHAPE.global_batch,
        vocab_size=cfg.vocab_size, seed=SEED))
    log = []
    for step in range(STEPS):
        tokens = torch.from_numpy(corpus.batch(step)["tokens"])
        batch = {"tokens": local_shard(tokens, mesh, specs[1]["tokens"])}
        params, opt, m = b.jitted()(params, opt, batch)
        log.append((float(m["loss"]), float(m["grad_norm"]),
                    float(m["lr"])))
    return log


def train_cases(rank, world, device, arch, np_params, cases, ckpt_root):
    """Each ``(name, data, model, kw)`` of ``cases`` (data * model ==
    world): a mesh Trainer from ``np_params`` for STEPS steps, or with
    ``kw["scheme"]`` the bare train bundle; returns {name: [(loss,
    grad_norm, lr)] a step}.  ``kw["restart"]``: :func:`restart`'s
    result instead."""
    cfg = _cfg(arch)
    out = {}
    for name, data, model, kw in cases:
        if kw.get("restart"):
            out[name] = restart(rank, world, device, arch, np_params, data,
                                model, f"{ckpt_root}/{name}")
            continue
        mesh = make_host_mesh(data, model, device=device.type)
        kw = dict(kw)
        if "scheme" in kw:
            out[name] = _bundle_run(cfg, mesh, np_params, kw["scheme"])
            continue
        if kw.pop("compress", False):
            kw["compression"] = _compression()
        t = Trainer(cfg, SHAPE, _tcfg(f"{ckpt_root}/{name}", **kw),
                    mesh=mesh, device=device)
        t.load_params(from_reference(np_params, device=device))
        t.run()
        out[name] = _log(t.metrics_log)
    return out


def restart(rank, world, device, arch, np_params, data, model, ckpt_root):
    """A run with a failure injected at step 3 (checkpoints every 2)
    against an uninterrupted one on a (data, model) mesh: whether every
    shard ends bit-identical, the restarts, and whether this rank's shards
    equal ``local_shard`` of the state gathered whole."""
    cfg = _cfg(arch)
    mesh = make_host_mesh(data, model, device=device.type)
    runs = []
    for name, fail in (("a", -1), ("b", 3)):
        t = Trainer(cfg, SHAPE, _tcfg(f"{ckpt_root}/{name}", steps=5,
                                      fail_at_step=fail, ckpt_every=2,
                                      compression=_compression()),
                    mesh=mesh, device=device)
        t.load_params(from_reference(np_params, device=device))
        runs.append((t, t.run()))
    (ta, ra), (tb, rb) = runs
    same = all(torch.equal(x, y) for x, y in zip(
        adamw.flatten({"p": ta.params, "o": ta.opt_state}).values(),
        adamw.flatten({"p": tb.params, "o": tb.opt_state}).values()))
    full = tb.full_state()
    specs = tb._pspecs
    shards_ok = True
    for part in ("params", "opt"):
        fs = flatten_specs(specs[part])
        mine = adamw.flatten(getattr(tb, "params" if part == "params"
                                     else "opt_state"))
        for k, x in adamw.flatten(full[part]).items():
            shards_ok &= torch.equal(local_shard(x, mesh, fs[k]), mine[k])
    return {"same": same, "restarts": (ra["restarts"], rb["restarts"]),
            "final_steps": (ra["final_step"], rb["final_step"]),
            "losses": (_log(ta.metrics_log), _log(tb.metrics_log)),
            "shards_ok": bool(shards_ok),
            "writer": tb._writes_checkpoints()}


def serve_bundles(rank, world, device, arch, np_params, overrides, mesh_shape,
                  prompt, n_decode, context_parallel):
    """The prefill bundle on ``prompt`` (B, S) then ``n_decode`` greedy
    steps of the decode bundle (max_len S + n_decode), fp32, on a
    ``mesh_shape`` (data, model) mesh.  Returns the gathered logits of the
    prefill and of every decode step, the greedy tokens, and whether the
    decode step attended context-parallel."""
    cfg = _cfg(arch, overrides)
    data, model = mesh_shape
    mesh = make_host_mesh(data, model, device=device.type)
    svc = CollectiveService()
    b, s = prompt.shape
    max_len = s + n_decode
    kw = dict(param_dtype=torch.float32, cache_dtype=torch.float32,
              collectives=svc)
    pre = make_prefill_bundle(cfg, ShapeConfig("p", "prefill", max_len, b),
                              mesh, **kw)
    dec = make_decode_bundle(cfg, ShapeConfig("d", "decode", max_len, b),
                             mesh, context_parallel=context_parallel, **kw)
    full = from_reference(np_params, device=device)

    def specs(tree):
        return {k: sh.spec for k, sh in flatten_specs(tree).items()}

    pspec = specs(pre.in_shardings[0])
    params = adamw.unflatten({k: local_shard(x, mesh, pspec[k])
                              for k, x in adamw.flatten(full).items()})
    bspec = pre.in_shardings[1]["tokens"].spec
    logits_spec = pre.out_shardings[0].spec
    tokens = torch.as_tensor(prompt, dtype=torch.int32)

    def gather(logits):
        """The whole (B, V) logits: every rank's block, gathered."""
        import torch.distributed as dist
        blocks = [None] * world
        dist.all_gather_object(blocks, logits.cpu())
        whole = torch.zeros(b, cfg.padded_vocab)
        for blk, r in zip(blocks, range(world)):
            coords = mesh.mesh.flatten().tolist().index(r)
            di, mi = divmod(coords, model)
            rows = _block(b, logits_spec[0], data, model, di, mi)
            cols = _block(cfg.padded_vocab, logits_spec[1], data, model,
                          di, mi)
            whole[rows, cols] = blk
        return whole

    logits, cache = pre.jitted()(params,
                                 {"tokens": local_shard(tokens, mesh,
                                                        bspec)})
    out = [gather(logits)]
    greedy = [out[-1].argmax(-1)]
    pos = torch.full((b,), s, dtype=torch.int32)
    for _ in range(n_decode):
        tok = greedy[-1][:, None].int()
        logits, cache = dec.jitted()(
            params, cache, local_shard(tok, mesh, P(bspec[0], None)),
            local_shard(pos, mesh, P(bspec[0])))
        out.append(gather(logits))
        greedy.append(out[-1].argmax(-1))
        pos = pos + 1
    cp = dec.in_shardings[1]["k"].spec[2] == "model" and context_parallel
    return {"logits": torch.stack(out).numpy(),
            "greedy": torch.stack(greedy).numpy(), "cp": cp,
            "traffic": dict(svc.traffic)}


def _block(n, dims, data, model, di, mi):
    """The slice of an axis of size ``n`` that a rank at (di, mi) holds
    under a spec entry ``dims`` on a (data, model) mesh."""
    dims = () if dims is None else (dims,) if isinstance(dims, str) else dims
    k, idx = 1, 0
    for d in dims:
        size, at = (data, di) if d == "data" else (model, mi)
        idx, k = idx * size + at, k * size
    return slice(idx * n // k, (idx + 1) * n // k)


def sharded_app(rank, world, device, arch, np_params, prompt):
    """A prefill StepBundle loaded as a vFPGA app on a (2, 1) mesh, its
    weights through the sharded ``migrate_tree``; returns this rank's
    logits block and whether the build ran on the rank's shard shapes."""
    from repro_torch.core.static_layer import StaticLayer
    from repro_torch.core.vfpga import AppArtifact, VFpga
    cfg = _cfg(arch)
    mesh = make_mesh((world, 1), ("data", "model"), device=device.type)
    b, s = prompt.shape
    bundle = make_prefill_bundle(cfg, ShapeConfig("p", "prefill", s, b), mesh,
                                 param_dtype=torch.float32,
                                 cache_dtype=torch.float32)
    seen = []
    fn = bundle.jitted()

    def app(params, batch):
        seen.append(tuple(batch["tokens"].shape))
        return fn(params, batch)

    art = AppArtifact(name="prefill", fn=app,
                      weights=from_reference(np_params, device="cpu"),
                      abstract_args=bundle.abstract_args,
                      in_shardings=bundle.in_shardings,
                      out_shardings=bundle.out_shardings,
                      config_repr=cfg)
    static = StaticLayer(device=device)
    slot = VFpga(0, static)
    stats = slot.load(art, services=None, mesh=mesh)
    tokens = local_shard(torch.as_tensor(prompt, dtype=torch.int32), mesh,
                         bundle.in_shardings[1]["tokens"].spec)
    logits, _ = slot.invoke_kernel(slot.device_weights, {"tokens": tokens})
    return {"logits": logits.numpy(), "built_on": seen[0],
            "hbm_used": slot.hbm_used, "stats": stats,
            "embed_rows": tuple(slot.device_weights["embed"]["table"].shape)}


def describe_bundles(rank, world, device, archs, shapes):
    """Each (arch, shape) bundle on a (1, 1) mesh, reduced config:
    {(arch, shape name): (abstract {path: (shape, dtype)}, in specs
    {path: spec}, out specs {path: spec})} in plain Python."""
    from repro_torch.launch.steps import make_bundle
    mesh = make_host_mesh(1, 1, device=device.type)
    out = {}
    for arch in archs:
        cfg = _cfg(arch)
        for shape in shapes:
            b = make_bundle(cfg, shape, mesh)
            out[(arch, shape.name)] = (
                {k: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
                 for k, x in flatten_specs(b.abstract_args).items()},
                {k: tuple(sh.spec) for k, sh in
                 flatten_specs(b.in_shardings).items()},
                {k: tuple(sh.spec) for k, sh in
                 flatten_specs(b.out_shardings).items()},
                b.name, b.donate_argnums)
    return out


def cp_decode(rank, world, device, arch, steps=4):
    """``decode_step(cp_mesh=...)`` on a (1, world) mesh against the
    dense ``decode_step``, float32, seeded weights: each rank holds its
    block of the sequence.  Returns the largest difference of the logits
    and of the rank's cache block from the dense cache's, over every step
    (a mamba model's cache has no sequence: the whole cache)."""
    from repro_torch.models import transformer as T
    cfg = _cfg(arch)
    mesh = make_mesh((1, world), ("data", "model"), device=device.type)
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(5),
                           dtype=torch.float32, device=device)
    prompt = torch.randint(3, 400, (2, 12),
                           generator=torch.Generator().manual_seed(6))
    max_len = 12 + steps
    _, dense = T.prefill(params, cfg, prompt, max_len,
                         cache_dtype=torch.float32)
    blk = max_len // world
    mine = {k: (v[:, :, rank * blk:(rank + 1) * blk] if k in ("k", "v")
                else v).clone()
            for k, v in adamw.flatten(dense).items()}
    cp = adamw.unflatten(mine)
    err = cache_err = 0.0
    tok = prompt[:, -1:]
    for t in range(steps):
        pos = torch.full((2,), 12 + t)
        want, dense = T.decode_step(params, cfg, dense, tok, pos)
        got, cp = T.decode_step(params, cfg, cp, tok, pos, cp_mesh=mesh)
        err = max(err, float((got - want).abs().max()))
        for k, v in adamw.flatten(cp).items():
            ref = adamw.flatten(dense)[k]
            if k in ("k", "v"):
                ref = ref[:, :, rank * blk:(rank + 1) * blk]
            cache_err = max(cache_err, float((v - ref).abs().max()))
        tok = want.argmax(-1, keepdim=True)
    return {"err": err, "cache_err": cache_err}


def mesh_step_spans(rank, world, device, arch, microbatches, steps):
    """``steps`` steps of a ``make_train_bundle(microbatches=...)`` on a
    (1, 1) mesh with the span recorder on, reduced config, seeded
    weights: the spans as (name, id, parent, start ns, end ns)."""
    from repro_torch.models import transformer as T
    from repro_torch.telemetry import spans
    cfg = _cfg(arch)
    mesh = make_host_mesh(1, 1, device=device.type)
    b = make_train_bundle(cfg, SHAPE, mesh, remat="none", compute_dtype=None,
                          microbatches=microbatches)
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(3),
                           dtype=torch.float32, device=device)
    opt = adamw.init(params)
    tokens = torch.randint(3, cfg.vocab_size,
                           (SHAPE.global_batch, SHAPE.seq_len),
                           generator=torch.Generator().manual_seed(4))
    step = b.jitted()
    with spans.enable():
        for _ in range(steps):
            params, opt, _ = step(params, opt, {"tokens": tokens})
    return [(r.name, r.id, r.parent, r.start_ns, r.end_ns)
            for r in spans.snapshot()]
