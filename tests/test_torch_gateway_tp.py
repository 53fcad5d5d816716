"""A ``ServingGateway`` in front of a tensor-parallel engine.

The gateway's backfill reads the rank's own clock (expiry, aging, slack
order), so on a TP engine ``TPContext.backfill`` runs it on model-rank 0
and the other ranks replay its outcome from one broadcast.  The
reference's one controller runs the hook once and has no gateway-on-mesh
test; these hold a TP 2 gateway (gloo ranks on the CPU) to the port's
single-process gateway on the same arrivals, and its greedy streams to
the JAX gateway's.  Every scenario runs in one ``run_ranks`` call (the
rank body is ``tests/_torch_tp_ranks.py::gateway``), so the ranks start
once; the in-process tests replay one gateway's outcome on another
directly.
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_ranks as ranks
from repro.configs import get_config as jget
from repro.core.services.mmu import MMU as JMMU, MMUConfig as JMMUConfig
from repro.models import transformer as JT
from repro.serve.engine import ServingEngine as JEngine
from repro.serve.gateway import ServingGateway as JGateway
from repro_torch.configs import get_config
from repro_torch.core.faults import FaultKind
from repro_torch.core.services.mmu import MMU, MMUConfig
from repro_torch.launch.mesh import run_ranks
from repro_torch.models.params import from_reference
from repro_torch.serve import gateway as gateway_module
from repro_torch.serve.engine import ServingEngine
from repro_torch.serve.gateway import ServingGateway
from repro_torch.serve.tp import (DISPATCHED, FAILED, QUEUED, RAISED,
                                  TPContext, _backfill_outcome,
                                  _replay_backfill)

torch.set_num_threads(1)

ENG_KW = dict(max_batch=2, max_len=96, seed=0)
MMU_KW = dict(page_size=16, n_pages=128)
# (step, prompt, submit keywords): open arrivals through 2 slots, greedy,
# sampled and filtered rows, priorities that reorder the queue
ARRIVALS = [(0, list(range(3, 9)), dict(max_new_tokens=8)),
            (0, list(range(3, 17)), dict(max_new_tokens=8, temperature=0.8)),
            (0, list(range(5, 11)), dict(max_new_tokens=8, priority=2)),
            (2, list(range(2, 14)), dict(max_new_tokens=8, temperature=1.3,
                                         top_k=5)),
            (3, list(range(9, 15)), dict(max_new_tokens=8, priority=1)),
            (5, list(range(4, 20)), dict(max_new_tokens=8, temperature=0.7,
                                         top_p=0.9))]
# deadlines 80 s out, the clock that jumps ahead 100 s: gids 0, 2, 4
DEADLINE_S, AHEAD_S = 80.0, 100.0
DEADLINED = [(list(range(3, 9)), dict(max_new_tokens=6,
                                      deadline_s=DEADLINE_S)),
             (list(range(3, 12)), dict(max_new_tokens=6, temperature=0.9)),
             (list(range(6, 14)), dict(max_new_tokens=6, priority=1,
                                       deadline_s=DEADLINE_S)),
             (list(range(2, 9)), dict(max_new_tokens=6)),
             (list(range(7, 19)), dict(max_new_tokens=6, temperature=1.1,
                                       deadline_s=DEADLINE_S))]


@pytest.fixture(scope="module")
def weights():
    jcfg = jget("smollm-135m").reduced()
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    return jcfg, jparams, jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def rank_outs(weights):
    return run_ranks(ranks.gateway, 2, weights[2], ARRIVALS, DEADLINED,
                     ENG_KW, MMU_KW, AHEAD_S, device="cpu")


def _engine(np_params):
    return ServingEngine(get_config("smollm-135m").reduced(),
                         from_reference(np_params, device="cpu"),
                         MMU(MMUConfig(**MMU_KW)), device="cpu", **ENG_KW)


def _single(np_params, *, ahead_s=0.0):
    """The deadlined scenario on the port's single-process gateway, its
    clock ``ahead_s`` ahead after the submits."""
    return ranks.serve_deadlined(
        ServingGateway(_engine(np_params), admission="slo"), DEADLINED,
        ahead_s)


def test_tp2_gateway_streams_equal_the_single_process_gateway(weights,
                                                              rank_outs):
    """Open arrivals through the TP 2 gateway: on every rank the streams,
    dispatch order and counters equal the port's single-process
    gateway's, and the greedy streams the JAX gateway's on one device."""
    jcfg, jparams, w = weights
    gw = ServingGateway(_engine(w), admission="slo")
    ranks.drive_gateway(gw, ARRIVALS)
    want = ranks._gateway_outcome(gw)
    for out in rank_outs:
        assert out["agree"]
        assert out["parity"] == want
    assert len(want["tokens"]) == len(ARRIVALS)
    jgw = JGateway(JEngine(jcfg, jparams, JMMU(JMMUConfig(**MMU_KW)),
                           **ENG_KW), admission="slo")
    jtokens = ranks.drive_gateway(jgw, ARRIVALS)
    greedy = [gid for gid, (_, _, kw) in enumerate(ARRIVALS)
              if kw.get("temperature", 0.0) == 0.0]
    assert greedy
    for gid in greedy:
        assert rank_outs[1]["parity"]["tokens"][gid] == jtokens[gid]


def test_rank1_clock_ahead_changes_nothing(weights, rank_outs):
    """Rank 1's gateway clock 100 s ahead of rank 0's, past every
    deadline: rank 0 decides, so nothing expires on rank 1 either, and
    both ranks dispatch the gids the single-process gateway does."""
    want = _single(weights[2])
    assert want["expired"] == [] and want["dispatched"] == len(DEADLINED)
    for out in rank_outs:
        assert out["rank1_ahead"] == want
    assert rank_outs[0]["rank1_ahead"]["dispatch_order"] == \
        rank_outs[1]["rank1_ahead"]["dispatch_order"]


def test_rank0_clock_ahead_expires_the_same_gids_on_every_rank(weights,
                                                               rank_outs):
    """Rank 0's clock 100 s ahead: rank 0 expires the three deadlined
    requests, and rank 1, whose clock says they have 80 s left, expires
    the same gids with the same typed ``SLO_EXPIRED`` refusal."""
    want = _single(weights[2], ahead_s=AHEAD_S)
    deadlined = [gid for gid, (_, kw) in enumerate(DEADLINED)
                 if "deadline_s" in kw]
    assert want["expired"] == deadlined
    assert want["rejected_kinds"] == ["slo_expired"] * len(deadlined)
    for out in rank_outs:
        assert out["rank0_ahead"] == want
        assert out["rank0_ahead"]["expired_count"] == len(deadlined)


def test_a_raising_submit_raises_the_same_error_on_every_rank(weights,
                                                             rank_outs):
    """A prompt token outside the vocabulary, which ``gateway.submit``
    takes and ``engine.submit`` refuses: rank 0's backfill raises
    ``ValueError`` in its dispatch, and rank 1, which waits on rank 0's
    broadcast, raises the same error instead of hanging.  Both ranks are
    left as the single-process gateway is, and go on in step (the
    scenario after it runs collectives)."""
    want = ranks.submit_bad_prompt(
        ServingGateway(_engine(weights[2]), admission="slo"))
    assert want["error"][0] == "ValueError"
    assert want["dispatched"] == 1 and want["queue"] == [0, 1]
    for out in rank_outs:
        assert out["bad_prompt"] == want


def test_plain_hook_runs_once_per_step_on_every_rank(weights, rank_outs):
    """A hook that is no gateway's runs on every rank, once a step; the
    request it submits from replicated state (its third call) is served
    as the single-process engine serves it."""
    want = ranks.serve_with_plain_hook(_engine(weights[2]))
    for out in rank_outs:
        assert out["plain_hook"] == want
    assert want["calls"] == want["steps"] and len(want["tokens"]) == 2


# ============================================ in process (no ranks) =====
def test_gateway_of_recognises_only_a_gateways_backfill(weights):
    gw = ServingGateway(_engine(weights[2]))
    assert TPContext.gateway_of(gw._backfill) is gw
    assert TPContext.gateway_of(gw._on_token) is None
    assert TPContext.gateway_of(lambda engine: None) is None
    assert TPContext.gateway_of([].append) is None


def test_replayed_backfill_equals_the_deciding_gateways(weights):
    """``_backfill_outcome`` on one gateway and ``_replay_backfill`` of
    its rows on another, whose clock is 100 s ahead, leave the two alike:
    the same refusals, counters, engine submits and queue order, though
    the replaying gateway's own backfill would have expired everything
    with a deadline."""
    w = weights[2]
    gws = _twin_gateways(w, DEADLINED)
    # the deciding gateway sees one deadline already past
    gws[0].queue[2].stream.deadline = time.perf_counter() - 1.0
    rows, error = _backfill_outcome(gws[0].engine, gws[0])
    assert error is None
    assert rows.dtype == np.int32 and rows.shape == (len(DEADLINED), 3)
    assert rows[:, 1].tolist() == [0, 1, 1, 2, 2]   # expired, sent, queued
    real = gateway_module.time
    gateway_module.time = ranks._AheadClock(AHEAD_S)
    try:
        _replay_backfill(gws[1].engine, gws[1], rows)
    finally:
        gateway_module.time = real
    a, b = gws
    assert [s.gid for s in b.rejected] == [s.gid for s in a.rejected] == [2]
    assert b.rejected[0].error.kind == FaultKind.SLO_EXPIRED
    assert (b.expired, b.dispatched) == (a.expired, a.dispatched) == (1, 2)
    assert [p.stream.gid for p in b.queue] == [p.stream.gid for p in a.queue]
    assert sorted(b.streams) == sorted(a.streams)
    # every field of the engine's requests, the deadline too, as the
    # gateway's own dispatch would have set it
    assert _requests(b.engine) == _requests(a.engine)
    assert [r.deadline_s for r in a.engine.queue] == \
        [a.streams[r.rid].deadline for r in a.engine.queue]
    assert any(r.deadline_s is not None for r in a.engine.queue)
    with pytest.raises(RuntimeError, match="gateway submits differ"):
        _replay_backfill(b.engine, b, np.asarray([[99, 2, 0]], np.int32))


def _twin_gateways(w, arrivals):
    """Two gateways on two engines with the same submits and the same
    absolute deadlines, as the ranks' replicated state would be."""
    gws = [ServingGateway(_engine(w), admission="slo") for _ in range(2)]
    for gw in gws:
        for prompt, kw in arrivals:
            gw.submit(prompt, **kw)
    for p, q in zip(*(gw.queue for gw in gws)):
        q.stream.deadline = p.stream.deadline
    return gws


def _requests(engine):
    """The engine's queued requests, every field but the submit time."""
    return [{f.name: getattr(r, f.name) for f in dataclasses.fields(r)
             if f.name != "t_submit"} for r in engine.queue]


def test_a_raising_submit_is_marked_and_raised_on_replay(weights):
    """Rank 0's dispatch of an out-of-vocabulary prompt raises: its row is
    ``FAILED``, and the replaying gateway is left as the deciding one was
    (the sent request dispatched and still queued, as the reference's
    backfill leaves it) and raises the same ``ValueError``."""
    bad = [(list(range(3, 9)), dict(max_new_tokens=4)),
           ([3, 10 ** 6], dict(max_new_tokens=4)),
           (list(range(4, 9)), dict(max_new_tokens=4))]
    a, b = _twin_gateways(weights[2], bad)
    rows, error = _backfill_outcome(a.engine, a)
    assert isinstance(error, ValueError)
    assert rows[:, :2].tolist() == [[0, DISPATCHED], [1, FAILED],
                                    [2, QUEUED]]
    with pytest.raises(ValueError, match="out of range"):
        _replay_backfill(b.engine, b, rows)
    assert [p.stream.gid for p in b.queue] == \
        [p.stream.gid for p in a.queue] == [0, 1, 2]
    assert sorted(b.streams) == sorted(a.streams)
    assert [s.gid for s in b.streams.values()] == [0]
    assert (b.dispatched, a.dispatched) == (1, 1)
    assert _requests(b.engine) == _requests(a.engine)


def test_a_backfill_error_elsewhere_raises_on_every_rank(weights,
                                                        monkeypatch):
    """An error outside ``engine.submit`` marks every row ``RAISED``;
    the deciding rank gets the error itself, the others a
    ``RuntimeError``.  A replayed submit that does not raise where rank
    0's did means the engines differ."""
    a, b = _twin_gateways(weights[2], DEADLINED[:2])

    def broken(*args):
        raise ZeroDivisionError("estimate")

    monkeypatch.setattr(a, "_service_estimate", broken)
    rows, error = _backfill_outcome(a.engine, a)
    assert isinstance(error, ZeroDivisionError)
    assert rows.shape == (2, 3) and (rows[:, 1] == RAISED).all()
    with pytest.raises(RuntimeError, match="backfill raised"):
        _replay_backfill(b.engine, b, rows)
    assert b.dispatched == 0 and not b.engine.queue
    with pytest.raises(RuntimeError, match="engines differ"):
        _replay_backfill(b.engine, b,
                         np.asarray([[0, FAILED, 0], [1, QUEUED, 0]],
                                    np.int32))


def test_a_repeated_gid_is_refused_before_the_broadcast(weights):
    """Streams adopted from another gateway may repeat a gid; every rank
    sees the queue, so each refuses it before any collective."""
    from types import SimpleNamespace
    gw = ServingGateway(_engine(weights[2]))
    for prompt, kw in DEADLINED[:2]:
        gw.submit(prompt, **kw)
    gw.queue[1].stream.gid = gw.queue[0].stream.gid

    def broadcast(x):
        raise AssertionError("broadcast issued")

    for rank in (0, 1):
        tp = SimpleNamespace(rank=rank, broadcast_from_rank0=broadcast)
        with pytest.raises(RuntimeError, match="repeats a gid"):
            TPContext.backfill(tp, gw.engine, gw)
