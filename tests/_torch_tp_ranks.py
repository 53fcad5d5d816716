"""Rank bodies of the port's multi-process twins.

``repro_torch.launch.mesh.run_ranks`` starts each rank with ``spawn`` and
calls one of these functions there as ``fn(rank, world, device, ...)``.
They live in a module of their own that imports neither JAX nor the JAX
package, so a rank starts with torch and the port alone; the test files
compare what the ranks return with the JAX package in the parent.
Weights arrive as numpy trees (``params.from_reference``), requests as
``(prompt, submit keywords)`` pairs.
"""
import dataclasses

import torch

from repro_torch.configs import get_config
from repro_torch.core.faults import FaultKind
from repro_torch.core.services.collectives import (CollectiveConfig,
                                                   CollectiveService)
from repro_torch.core.services.mmu import MMU, MMUConfig
from repro_torch.launch.mesh import make_host_mesh, make_mesh
from repro_torch.models import attention
from repro_torch.models.params import from_reference
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.gateway import ServingGateway


def _cfg(overrides):
    return dataclasses.replace(get_config("smollm-135m").reduced(),
                               **overrides)


def _tokens(eng):
    return {r.rid: list(r.out_tokens) for r in eng.completed}


def _drain(*engines):
    for eng in engines:
        while eng.pending():
            eng.step()


def _streams_agree(streams):
    """Every rank's completed streams, gathered over the world: the
    rank-divergence guard."""
    import torch.distributed as dist
    seen = [None] * dist.get_world_size()
    dist.all_gather_object(seen, streams)
    return all(s == seen[0] for s in seen)


def serve(rank, world, device, np_params, cfg_kw, reqs, eng_kw, mmu_kw):
    """A TP engine over all ranks (data 1, model ``world``) serving
    ``reqs`` to completion; returns its streams, plan and pool layout."""
    cfg = _cfg(cfg_kw)
    params = from_reference(np_params, device=device)
    mesh = make_host_mesh(1, world, device=device.type)
    svc = CollectiveService()
    eng = ServingEngine(cfg, params, MMU(MMUConfig(**mmu_kw)), mesh=mesh,
                        collectives=svc, device=device, **eng_kw)
    for prompt, kw in reqs:
        eng.submit(prompt, **kw)
    stats = eng.run()
    # a plain admission hook (not a gateway's) runs on every rank
    hook_calls = []
    eng.admission_hook = hook_calls.append
    eng.step()
    return {"tokens": _tokens(eng), "agree": _streams_agree(_tokens(eng)),
            "hook_ran": hook_calls == [eng],
            "plan": {"shard_heads": eng.tp.shard_heads,
                     "shard_mlp": eng.tp.shard_mlp},
            "pool_shape": tuple(eng.pools["k"].shape),
            "local_wq": tuple(eng.params["layers"]["attn"]["wq"].shape),
            "local_w_up": tuple(eng.params["layers"]["ffn"]["w_up"].shape),
            "completed": stats["completed"],
            "ewma": (eng.ewma_prefill_s_per_tok, eng.ewma_decode_step_s),
            "collective_calls": svc.calls, "steps": eng.steps,
            "allreduce_bytes": eng.tp.allreduce_bytes_per_step(2)}


def evict_with_copy(rank, world, device, np_params, cfg_kw):
    """Evict-with-copy on the head-split pools: the host copy of every
    evicted page equals its full-head gather before the eviction, and the
    page faulted back holds the same bytes, this rank's heads in its own
    pool.  Returns the checks' outcomes."""
    cfg = _cfg(cfg_kw)
    params = from_reference(np_params, device=device)
    mesh = make_host_mesh(1, world, device=device.type)
    mmu = MMU(MMUConfig(page_size=8, n_pages=8, host_pool_pages=64))
    eng = ServingEngine(cfg, params, mmu, max_batch=2, max_len=80, seed=0,
                        mesh=mesh, device=device)
    eng.submit(list(range(3, 30)), max_new_tokens=30)
    for _ in range(3):
        eng.step()
    se = mmu._seqs[1]
    pre = {p.vpage: eng._pager_gather(p.ppage)
           for p in se.pages if not p.on_host}
    mmu.alloc_seq(99, 8 * (len(mmu._free) + 2))       # pressure -> evict
    evicted = [p.vpage for p in se.pages if p.on_host]
    stored_equal = all(
        torch.equal(torch.as_tensor(mmu.host_page_data(1, v)[s]),
                    pre[v][s]) for v in evicted for s in ("k", "v"))
    mmu.free_seq(99)
    back_equal, local_equal = True, True
    from repro_torch.serve.paged_model import (flat_page_indices,
                                               gather_kv_pages)
    hs = eng.tp.head_slice()
    for v in evicted:                                 # fault back in
        ppage, _ = mmu.translate(1, v * 8)
        flat = flat_page_indices([ppage], cfg.n_layers, mmu.config.n_pages)
        full = eng.gather_kv(flat)
        local = gather_kv_pages(eng.pools, flat)
        for s in ("k", "v"):
            back_equal &= torch.equal(full[s].cpu(), pre[v][s])
            local_equal &= torch.equal(local[s].cpu(), pre[v][s][:, :, hs])
    return {"evicted": len(evicted), "stored_equal": stored_equal,
            "back_equal": back_equal, "local_equal": local_equal,
            "local_heads": int(eng.pools["k"].shape[2])}


def prefill_paged_twin(rank, world, device, np_params, prompts):
    """``TPContext.prefill_paged`` beside the single-process
    ``prefill_paged`` on the same prompts and block tables: the first
    tokens (greedy and sampled rows), and this rank's heads of the full
    pools.  Returns the tokens and the pools' largest difference."""
    from repro_torch.serve import paged_model
    from repro_torch.serve.tp import TPContext
    cfg = _cfg({})
    params = from_reference(np_params, device=device)
    mesh = make_host_mesh(1, world, device=device.type)
    page, n_pages = 8, 16
    n = len(prompts)
    width = max(len(p) for p in prompts)
    maxp = -(-width // page)
    tokens = torch.zeros((n, width), dtype=torch.long, device=device)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = torch.tensor(p)
    lens = torch.tensor([len(p) for p in prompts], device=device)
    tables = torch.arange(n * maxp, device=device).reshape(n, maxp)
    temps = torch.tensor([0.0, 0.9, 1.3][:n], device=device)
    seq_ids = torch.arange(1, n + 1, device=device)
    full = paged_model.make_pools(cfg, n_pages, page, device=device)
    want = paged_model.prefill_paged(params, full, tokens, lens, tables, 7,
                                     temps, seq_ids=seq_ids, cfg=cfg,
                                     page_size=page)
    tp = TPContext(cfg, mesh, params, page_size=page)
    local = paged_model.make_pools(tp.local_cfg, n_pages, page,
                                   device=device)
    got = tp.prefill_paged(tp.params, local, tokens, lens, tables, 7, temps,
                           seq_ids=seq_ids)
    # every slot but the last, the write sink, where each path drops
    # what it does not keep (padding positions) and which nothing reads
    hs = tp.head_slice()
    kv_err = max(float((local[s][:-1] - full[s][:-1, :, hs]).abs().max())
                 for s in ("k", "v"))
    return {"got": got.tolist(), "want": want.tolist(), "kv_err": kv_err,
            "local_heads": int(local["k"].shape[2])}


def migrate_and_recover(rank, world, device, np_params, reqs):
    """A TP tenant live-migrates to a single-device shell (stop-and-copy,
    then pre-copy), and a TP slot recovers in place
    (``Shell.recover_slot``), each beside an unmoved single-device oracle
    engine.  Returns the streams of each pair."""
    from repro_torch.core import Shell, ShellConfig, migrate
    from repro_torch.core.migrate import migrate_precopy
    cfg = _cfg({})
    params = from_reference(np_params, device=device)
    mesh = make_host_mesh(1, world, device=device.type)

    def shell():
        s = Shell(ShellConfig.make(
            services={"mmu": MMUConfig(page_size=16, n_pages=128)},
            n_vfpgas=2), device=device)
        s.build()
        return s

    def engine(sh, mesh):
        return ServingEngine(cfg, params, sh.services.get("mmu"),
                             max_batch=3, max_len=128, shell=sh, slot=0,
                             tenant="gold", mesh=mesh, device=device)

    def oracle():
        eng = ServingEngine(cfg, params,
                            MMU(MMUConfig(page_size=16, n_pages=128)),
                            max_batch=3, max_len=128, device=device)
        for prompt, kw in reqs:
            eng.submit(prompt, **kw)
        return eng

    out = {}
    # ---- migrate: head-split source -> single-device destination ----
    src, dst = shell(), shell()
    eng_src, eng_dst = engine(src, mesh), engine(dst, None)
    want = oracle()
    for prompt, kw in reqs:
        eng_src.submit(prompt, **kw)
    for _ in range(4):
        eng_src.step()
        want.step()
    report = migrate(src, dst, "gold")
    _drain(eng_dst, want)
    out["migrate"] = {
        "n_requests": report.n_requests, "got": _tokens(eng_dst),
        "want": _tokens(want),
        "src_pages_used": src.services.get("mmu").utilization()["pages_used"]}
    src.close()
    dst.close()
    # ---- pre-copy: warm rounds ship every head from the TP source ----
    src, dst = shell(), shell()
    eng_src, eng_dst = engine(src, mesh), engine(dst, None)
    want = oracle()
    for prompt, kw in reqs:
        eng_src.submit(prompt, **kw)
    for _ in range(4):
        eng_src.step()
        want.step()
    # two rounds, each followed by one source decode step: no request
    # completes on the source before the freeze
    report = migrate_precopy(src, dst, "gold", max_rounds=2)
    _drain(eng_dst, want)
    out["precopy"] = {
        "n_requests": report.n_requests, "rounds": report.precopy_rounds,
        "precopy_pages": report.precopy_pages, "got": _tokens(eng_dst),
        "want": _tokens(want),
        "src_pages_used": src.services.get("mmu").utilization()["pages_used"]}
    src.close()
    dst.close()
    # ---- recover_slot: the TP engine, in place, KV intact ----
    sh = shell()
    eng = engine(sh, mesh)
    want = oracle()
    for prompt, kw in reqs:
        eng.submit(prompt, **kw)
    for _ in range(4):
        eng.step()
        want.step()
    report = sh.recover_slot(0)
    _drain(eng, want)
    out["recover"] = {
        "n_requests": report.n_requests, "n_pages": report.n_pages,
        "got": _tokens(eng), "want": _tokens(want),
        "local_heads": int(eng.pools["k"].shape[2])}
    out["agree"] = _streams_agree(out)
    sh.close()
    return out


# ----------------------------------------------------------- collectives --
def _block(x, idx, n):
    return x.chunk(n, dim=0)[idx]


def collectives_and_cp(rank, world, device, cp_inputs):
    """On a (pod 2, data 2, model 2) mesh: the hierarchical all-reduce of
    each rank's block of a (pod, data)-split tensor beside the flat sum,
    and ``attend_decode_cp`` with the batch on ``data`` and the cache's
    sequence on ``model``.  Returns the sums and this rank's rows."""
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"),
                     device=device.type)
    pod, data, model = (mesh.get_local_rank(a)
                        for a in ("pod", "data", "model"))
    x = torch.arange(32.0, device=device).reshape(8, 4)
    local = _block(x, pod * 2 + data, 4)
    flat = CollectiveService(CollectiveConfig(schedule="flat"))
    hier = CollectiveService(CollectiveConfig(schedule="hierarchical"))
    f = flat.all_reduce(local, mesh)
    h = hier.all_reduce(local, mesh)
    q, kc, vc, lens = (torch.as_tensor(a, device=device) for a in cp_inputs)
    q, kc, vc, lens = (_block(t, data, 2) for t in (q, kc, vc, lens))
    kc, vc = (t.chunk(2, dim=1)[model] for t in (kc, vc))
    out = attention.attend_decode_cp(q, kc, vc, lens, mesh)
    return {"coords": (pod, data, model), "flat": f.cpu().numpy(),
            "hier": h.cpu().numpy(), "cp": out.cpu().numpy(),
            "host_copies": flat.host_copies + hier.host_copies}


def world_of_one(rank, world, device):
    """A (1, 1, 1) mesh: each schedule's all-reduce and a reduction over
    ``model`` return the input's values."""
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"),
                     device=device.type)
    x = torch.arange(12.0, device=device).reshape(3, 4)
    outs = [CollectiveService(CollectiveConfig(schedule=s)).all_reduce(
        x, mesh) for s in ("flat", "hierarchical", "auto")]
    outs.append(CollectiveService().all_reduce(x, mesh, axes=("model",)))
    return [bool(torch.equal(o, x)) for o in outs]


def handoff(rank, world, device, cache):
    """The prefill/decode hand-off on a (pod 2, data 2, model 1) mesh: each
    rank passes its pod's block of every leaf and returns what it holds
    after the hand-off."""
    from repro_torch.serve.disaggregated import make_handoff_fn
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"),
                     device=device.type)
    fn, qp = make_handoff_fn(mesh)
    pod = mesh.get_local_rank("pod")
    local = {k: _block(torch.as_tensor(v, device=device), pod, 2)
             for k, v in cache.items()}
    out = fn(local)
    return {"pod": pod, "qp": qp,
            "out": {k: v.cpu().numpy() for k, v in out.items()}}


def handoff_needs_pods(rank, world, device):
    """``make_handoff_fn`` on a mesh of one pod raises ``ValueError``."""
    from repro_torch.serve.disaggregated import make_handoff_fn
    mesh = make_mesh((1, 2, 1), ("pod", "data", "model"),
                     device=device.type)
    try:
        make_handoff_fn(mesh)
    except ValueError as e:
        return str(e)
    return None


# ------------------------------------------------------------ the gateway --
def drive_gateway(gw, arrivals):
    """Submit each ``(step, prompt, kw)`` arrival once the gateway has
    taken ``step`` steps and step until every request is served; returns
    the completed streams' tokens by gid.  Shared by the ranks and the
    single-process gateways they are compared with (either package's)."""
    arrivals = sorted(arrivals, key=lambda a: a[0])
    steps, i = 0, 0
    while i < len(arrivals) or gw.pending():
        while i < len(arrivals) and arrivals[i][0] <= steps:
            gw.submit(arrivals[i][1], **arrivals[i][2])
            i += 1
        gw.step()
        steps += 1
    return {s.gid: list(s.tokens) for s in gw.completed}


class _AheadClock:
    """A stand-in for ``gateway.time`` whose clock reads ``ahead_s``
    seconds later than the process's."""

    def __init__(self, ahead_s):
        import time
        self._time, self.ahead_s = time, ahead_s

    def perf_counter(self):
        return self._time.perf_counter() + self.ahead_s


def _gateway_outcome(gw):
    streams = list(gw.completed) + list(gw.streams.values())
    return {"tokens": {s.gid: list(s.tokens) for s in gw.completed},
            "expired": [s.gid for s in gw.rejected
                        if s.error.kind == FaultKind.SLO_EXPIRED],
            "rejected_kinds": [s.error.kind for s in gw.rejected],
            "dispatch_order": [s.gid for s in sorted(
                (s for s in streams if s.rid is not None),
                key=lambda s: s.rid)],
            "dispatched": gw.dispatched, "expired_count": gw.expired}


def serve_deadlined(gw, deadlined, ahead_s):
    """Submit every ``(prompt, kw)`` of ``deadlined`` at once, then serve
    them with ``gateway.time`` reading ``ahead_s`` seconds ahead; returns
    the gateway's outcome."""
    from repro_torch.serve import gateway as gateway_module
    for prompt, kw in deadlined:
        gw.submit(prompt, **kw)
    real = gateway_module.time
    gateway_module.time = _AheadClock(ahead_s)
    try:
        gw.drain()
    finally:
        gateway_module.time = real
    return _gateway_outcome(gw)


def submit_bad_prompt(gw):
    """Two requests through ``gw``, the second with a token outside the
    vocabulary, and one step, whose dispatch of the second raises;
    returns the error and what the gateway and engine are left with."""
    gw.submit(list(range(3, 9)), max_new_tokens=4)
    gw.submit([3, gw.engine.cfg.vocab_size + 5], max_new_tokens=4)
    error = None
    try:
        gw.step()
    except Exception as e:
        error = (type(e).__name__, str(e))
    return {"error": error, "queue": [p.stream.gid for p in gw.queue],
            "streams": sorted(gw.streams), "dispatched": gw.dispatched,
            "engine_queue": [(r.rid, r.prompt) for r in gw.engine.queue]}


def serve_with_plain_hook(eng):
    """Serve one request on ``eng`` under a hook that is no gateway's and
    submits a second request, from replicated state, at its third call;
    returns the hook's calls, the steps and the streams."""
    calls = []

    def hook(e):
        calls.append(e.steps)
        if len(calls) == 3:
            e.submit(list(range(4, 12)), max_new_tokens=6)

    eng.admission_hook = hook
    eng.submit(list(range(3, 9)), max_new_tokens=6)
    steps = 0
    while eng.pending():
        eng.step()
        steps += 1
    return {"calls": len(calls), "steps": steps, "tokens": _tokens(eng)}


def gateway(rank, world, device, np_params, arrivals, deadlined, eng_kw,
            mmu_kw, ahead_s):
    """Every gateway scenario on one TP engine per scenario (data 1, model
    ``world``), so the ranks start once.

    ``parity``: ``arrivals`` through ``ServingGateway(admission="slo")``.
    ``rank1_ahead`` / ``rank0_ahead``: ``serve_deadlined`` with that
    rank's gateway clock ``ahead_s`` ahead.  ``bad_prompt``:
    ``submit_bad_prompt``, after which the ranks go on in step.
    ``plain_hook``: ``serve_with_plain_hook``.  Returns each scenario's
    outcome."""
    cfg = _cfg({})
    params = from_reference(np_params, device=device)
    mesh = make_host_mesh(1, world, device=device.type)

    def engine():
        return ServingEngine(cfg, params, MMU(MMUConfig(**mmu_kw)),
                             mesh=mesh, device=device, **eng_kw)

    out = {}
    gw = ServingGateway(engine(), admission="slo")
    drive_gateway(gw, arrivals)
    out["parity"] = _gateway_outcome(gw)
    for name, ahead_rank in (("rank1_ahead", 1), ("rank0_ahead", 0)):
        out[name] = serve_deadlined(
            ServingGateway(engine(), admission="slo"), deadlined,
            ahead_s if rank == ahead_rank else 0.0)
    out["bad_prompt"] = submit_bad_prompt(
        ServingGateway(engine(), admission="slo"))
    out["plain_hook"] = serve_with_plain_hook(engine())
    out["agree"] = _streams_agree(out)
    return out
