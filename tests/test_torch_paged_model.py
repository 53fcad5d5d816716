"""Port paged model against the JAX reference under teacher forcing.

Reduced smollm-135m at float32, the same weights on both sides (the
reference's init, converted with ``from_reference``).  Tolerances:
pool bytes atol 1e-5 (matrix products summed in another order move
float32 KV by ~1e-6); logits atol 1e-4 (the same, carried through two
layers and a 128-wide LM head); greedy tokens identical.  The reference
runs its public jitted functions with the Pallas kernel in interpret
mode; its logits are rebuilt from its dense ``forward`` and
``lm_logits``, with nothing in ``repro`` changed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.serve import paged_model as JP
from repro_torch.configs import get_config
from repro_torch.kernels.paged_attention import paged_attention as pa
from repro_torch.models.params import from_reference
from repro_torch.serve import paged_model as P

# small shapes: one intra-op thread is faster and leaves the cores to
# the other test workers
torch.set_num_threads(1)

POOL_ATOL = 1e-5
LOGIT_ATOL = 1e-4
PAGE, N_PAGES, MAXP = 8, 24, 6
PLENS = [7, 16, 23, 0]            # row 3 is an inactive slot (all -1)


@pytest.fixture(scope="module")
def setup():
    jcfg = jget("smollm-135m").reduced()
    cfg = get_config("smollm-135m").reduced()
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    params = from_reference(jax.tree.map(np.asarray, jparams), device="cpu")
    rs = np.random.RandomState(0)
    b = len(PLENS)
    tables = np.full((b, MAXP), -1, np.int32)
    perm = rs.permutation(N_PAGES)
    nxt = 0
    for i, n in enumerate(PLENS):
        if n:
            need = -(-(n + 6) // PAGE)          # room for decode steps
            tables[i, :need] = perm[nxt:nxt + need]
            nxt += need
    prompts = [rs.randint(0, cfg.vocab_size, n).tolist() for n in PLENS]
    tokens = np.zeros((b, 32), np.int32)
    for i, p in enumerate(prompts):
        tokens[i, :len(p)] = p
    return jcfg, cfg, jparams, params, tables, prompts, tokens


def _j(x):
    return jnp.asarray(np.asarray(x))


def _t(x, dtype=None):
    t = torch.tensor(np.asarray(x))
    return t if dtype is None else t.to(dtype)


def _pools_close(port, ref):
    for s in ("k", "v"):
        assert port[s].shape[0] == ref[s].shape[0] + 1       # + sink slot
        np.testing.assert_allclose(port[s][:-1].numpy(), np.asarray(ref[s]),
                                   atol=POOL_ATOL, rtol=0)


def _ref_logits(jcfg, jparams, seq):
    """Reference logits for the next token after ``seq``: dense forward
    over the whole sequence, LM head at the last position."""
    hidden, _, _, _ = JT.forward(jparams, jcfg, jnp.asarray([seq], jnp.int32))
    return np.asarray(JT.lm_logits(jparams, jcfg, hidden[0, -1]))[
        :jcfg.vocab_size]


def _prefill_both(setup):
    jcfg, cfg, jparams, params, tables, prompts, tokens = setup
    b = len(PLENS)
    zeros = np.zeros(b, np.int32)
    lens = np.asarray(PLENS, np.int32)
    temps = np.zeros(b, np.float32)
    rids = np.arange(1, b + 1, dtype=np.int32)
    jpools = JP.make_pools(jcfg, N_PAGES, PAGE)
    jfirst, jpools, _ = JP.prefill_shared_paged(
        jparams, jpools, _j(tokens), _j(lens), _j(zeros), _j(zeros),
        _j(tables), jax.random.PRNGKey(0), _j(temps), seq_ids=_j(rids),
        cfg=jcfg, page_size=PAGE)
    pools = P.make_pools(cfg, N_PAGES, PAGE, device="cpu")
    first = P.prefill_shared_paged(
        params, pools, _t(tokens), _t(lens), _t(zeros), _t(zeros),
        _t(tables), 0, _t(temps), seq_ids=_t(rids), cfg=cfg, page_size=PAGE)
    return jfirst, jpools, first, pools


def test_prefill_shared_matches_reference(setup):
    jcfg, cfg, jparams, params, tables, prompts, tokens = setup
    jfirst, jpools, first, pools = _prefill_both(setup)
    _pools_close(pools, jpools)
    live = [i for i, n in enumerate(PLENS) if n]
    np.testing.assert_array_equal(first.numpy()[live],
                                  np.asarray(jfirst)[live])
    # logits of each row's last prompt token, against the dense reference
    fresh = P.make_pools(cfg, N_PAGES, PAGE, device="cpu")
    z = np.zeros(len(PLENS), np.int32)
    logits = P._prefill_logits(params, fresh, _t(tokens),
                               _t(np.asarray(PLENS, np.int32)), _t(z), _t(z),
                               _t(tables), cfg=cfg, page_size=PAGE)
    for i in live:
        np.testing.assert_allclose(logits[i].numpy(),
                                   _ref_logits(jcfg, jparams, prompts[i]),
                                   atol=LOGIT_ATOL, rtol=0)


def test_decode_steps_match_reference_under_teacher_forcing(setup):
    jcfg, cfg, jparams, params, tables, prompts, tokens = setup
    jfirst, jpools, first, pools = _prefill_both(setup)
    b = len(PLENS)
    live = [i for i, n in enumerate(PLENS) if n]
    temps = np.zeros(b, np.float32)
    rids = np.arange(1, b + 1, dtype=np.int32)
    jlens = _j(np.asarray(PLENS, np.int32))
    lens = _t(np.asarray(PLENS, np.int32))
    teacher = np.asarray(jfirst)
    seqs = [list(p) + [int(teacher[i])] for i, p in enumerate(prompts)]
    rng = jax.random.PRNGKey(0)
    launches = pa.LAUNCHES
    for _ in range(4):
        # logits first, on a copy (the decode body appends KV in place)
        scratch = {s: v.clone() for s, v in pools.items()}
        logits = P._decode_logits(params, scratch, _t(tables), lens,
                                  _t(teacher), cfg=cfg, page_size=PAGE)
        for i in live:
            np.testing.assert_allclose(logits[i].numpy(),
                                       _ref_logits(jcfg, jparams, seqs[i]),
                                       atol=LOGIT_ATOL, rtol=0)
        jtok, jpools, jlens, rng = JP.decode_step_paged(
            jparams, jpools, _j(tables), jlens, _j(teacher), rng, _j(temps),
            seq_ids=_j(rids), cfg=jcfg, page_size=PAGE, use_pallas=True)
        tok, lens = P.decode_step_paged(
            params, pools, _t(tables), lens, _t(teacher), 0, _t(temps),
            seq_ids=_t(rids), cfg=cfg, page_size=PAGE)
        np.testing.assert_array_equal(tok.numpy()[live],
                                      np.asarray(jtok)[live])
        np.testing.assert_array_equal(lens.numpy(), np.asarray(jlens))
        _pools_close(pools, jpools)
        teacher = np.asarray(jtok)
        for i in live:
            seqs[i].append(int(teacher[i]))
    assert pa.LAUNCHES == launches               # the CPU took no kernel


def test_chunked_prefill_equals_one_shot_and_reference(setup):
    jcfg, cfg, jparams, params, tables, prompts, tokens = setup
    row = 2                                   # the 23-token prompt
    n = PLENS[row]
    tab = tables[row:row + 1]
    one = P.make_pools(cfg, N_PAGES, PAGE, device="cpu")
    z = _t(np.zeros(1, np.int32))
    temps, rid = _t(np.zeros(1, np.float32)), _t(np.asarray([3], np.int32))
    first_one = P.prefill_shared_paged(
        params, one, _t(tokens[row:row + 1]), _t(np.asarray([n], np.int32)),
        z, z, _t(tab), 0, temps, seq_ids=rid, cfg=cfg, page_size=PAGE)
    chunk = 8
    chunked = P.make_pools(cfg, N_PAGES, PAGE, device="cpu")
    jpools = JP.make_pools(jcfg, N_PAGES, PAGE)
    pos = 0
    while n - pos > chunk:
        toks = np.asarray([prompts[row][pos:pos + chunk]], np.int32)
        args = (np.asarray([chunk], np.int32), np.asarray([pos], np.int32))
        P.prefill_chunk_paged(params, chunked, _t(toks), _t(args[0]),
                              _t(args[1]), _t(tab), cfg=cfg, page_size=PAGE)
        jpools = JP.prefill_chunk_paged(jparams, jpools, _j(toks),
                                        _j(args[0]), _j(args[1]), _j(tab),
                                        cfg=jcfg, page_size=PAGE)
        _pools_close(chunked, jpools)          # intermediate chunks agree
        pos += chunk
    rest = np.zeros((1, chunk), np.int32)
    rest[0, :n - pos] = prompts[row][pos:]
    start = _t(np.asarray([pos], np.int32))
    first_chunked = P.prefill_shared_paged(
        params, chunked, _t(rest), _t(np.asarray([n - pos], np.int32)),
        start, start, _t(tab), 0, temps, seq_ids=rid, cfg=cfg,
        page_size=PAGE)
    assert int(first_chunked[0]) == int(first_one[0])
    for s in ("k", "v"):
        torch.testing.assert_close(chunked[s][:-1], one[s][:-1],
                                   atol=POOL_ATOL, rtol=0)


def test_shared_prefix_pages_are_never_written(setup):
    """write_from masks the covered prefix: its pages keep their bytes and
    the suffix attends to them (the reference's prefix-sharing path)."""
    jcfg, cfg, jparams, params, tables, prompts, tokens = setup
    row = 2
    n = PLENS[row]
    tab = _t(tables[row:row + 1])
    full = P.make_pools(cfg, N_PAGES, PAGE, device="cpu")
    one = _t(np.asarray([n], np.int32))
    z = _t(np.zeros(1, np.int32))
    temps = _t(np.zeros(1, np.float32))
    want = P.prefill_shared_paged(params, full, _t(tokens[row:row + 1]), one,
                                  z, z, tab, 0, temps, cfg=cfg,
                                  page_size=PAGE)
    shared = {s: v.clone() for s, v in full.items()}
    first_page = int(tables[row, 0])
    before = {s: shared[s][first_page].clone() for s in ("k", "v")}
    cov = _t(np.asarray([PAGE], np.int32))
    suffix = np.zeros((1, 16), np.int32)
    suffix[0, :n - PAGE] = prompts[row][PAGE:]
    got = P.prefill_shared_paged(params, shared, _t(suffix),
                                 _t(np.asarray([n - PAGE], np.int32)), cov,
                                 cov, tab, 0, temps, cfg=cfg, page_size=PAGE)
    assert int(got[0]) == int(want[0])
    for s in ("k", "v"):
        assert torch.equal(shared[s][first_page], before[s])
        torch.testing.assert_close(shared[s][:-1], full[s][:-1],
                                   atol=POOL_ATOL, rtol=0)


# the prefill attention's cases (``ops.paged_prefill``, its plain version
# on the CPU), through both prefill entry points against the reference:
# name -> (heads, kv heads, head dim, page, maxp, q_starts, q_lens,
# unmapped (row, page)); chunks of 16 queries; layer 0's attention reaches
# the KV that layer 1 writes
PREFILL_CASES = {
    # a later chunk of two rows, GQA 4:1 at h2o-danube's D 120
    "later_chunk": (8, 2, 120, 8, 10, [24, 40], [16, 16], []),
    # ragged q_lens with a padding row (q_len 0, its table all -1)
    "ragged_padding_row": (8, 2, 120, 8, 6, [0, 8, 0], [13, 5, 0], []),
    # padded queries (t >= q_len) beside real ones
    "padded_queries": (9, 3, 64, 8, 6, [8, 0], [3, 9], []),
    # an unmapped page inside the causal range, and a row whose first page
    # is unmapped, so its first queries see no key at all
    "unmapped_page": (8, 2, 64, 4, 12, [20, 4], [12, 12], [(0, 2),
                                                           (1, 0)]),
    # GQA 3:1 (the TP-local 9/3 slice) at D 64, one chunk from position 0
    "gqa3_d64": (9, 3, 64, 4, 8, [0, 16], [12, 7], [(1, 1)]),
    # the TP-local 3/1 slice, D 120
    "gqa3to1_d120": (3, 1, 120, 8, 4, [5, 0, 17], [8, 2, 0], []),
}


@pytest.mark.parametrize("name", list(PREFILL_CASES))
def test_prefill_attention_cases_match_reference(name):
    """An intermediate chunk and a prefill-finishing batch over pools that
    already hold earlier positions' KV: the pools every layer writes and
    the greedy first tokens equal the reference's.  (A padded query's
    output reaches neither; the card tests hold the kernel to the plain
    version there.)"""
    h, kh, d, page, maxp, q_starts, q_lens, unmapped = PREFILL_CASES[name]
    n, t, n_pages = len(q_starts), 16, 40
    shape = dict(n_heads=h, n_kv_heads=kh, head_dim=d)
    jcfg = dataclasses.replace(jget("smollm-135m").reduced(), **shape)
    cfg = dataclasses.replace(get_config("smollm-135m").reduced(), **shape)
    jparams = JT.init_params(jax.random.PRNGKey(1), jcfg, dtype=jnp.float32)
    params = from_reference(jax.tree.map(np.asarray, jparams), device="cpu")
    rs = np.random.RandomState(sum(map(ord, name)))
    tables = np.full((n, maxp), -1, np.int32)
    for i in range(n):
        if q_lens[i]:
            need = min(maxp, -(-(q_starts[i] + q_lens[i] + page) // page))
            tables[i, :need] = rs.permutation(n_pages)[:need]
    for i, p in unmapped:
        tables[i, p] = -1
    tokens = rs.randint(0, cfg.vocab_size, (n, t)).astype(np.int32)
    lens, starts = np.asarray(q_lens, np.int32), np.asarray(q_starts,
                                                            np.int32)
    # earlier chunks' KV, and one zero sink slot on the port's side
    kv = {s: rs.randn(cfg.n_layers * n_pages, page, kh, d).astype(np.float32)
          for s in ("k", "v")}

    def both():
        return ({s: jnp.asarray(a) for s, a in kv.items()},
                {s: torch.cat([_t(a), torch.zeros(1, page, kh, d)])
                 for s, a in kv.items()})

    jpools, pools = both()
    jpools = JP.prefill_chunk_paged(jparams, jpools, _j(tokens), _j(lens),
                                    _j(starts), _j(tables), cfg=jcfg,
                                    page_size=page)
    P.prefill_chunk_paged(params, pools, _t(tokens), _t(lens), _t(starts),
                          _t(tables), cfg=cfg, page_size=page)
    _pools_close(pools, jpools)

    jpools, pools = both()
    temps, rids = np.zeros(n, np.float32), np.arange(1, n + 1, dtype=np.int32)
    jfirst, jpools, _ = JP.prefill_shared_paged(
        jparams, jpools, _j(tokens), _j(lens), _j(starts), _j(starts),
        _j(tables), jax.random.PRNGKey(0), _j(temps), seq_ids=_j(rids),
        cfg=jcfg, page_size=page)
    first = P.prefill_shared_paged(
        params, pools, _t(tokens), _t(lens), _t(starts), _t(starts),
        _t(tables), 0, _t(temps), seq_ids=_t(rids), cfg=cfg, page_size=page)
    _pools_close(pools, jpools)
    live = [i for i in range(n) if q_lens[i]]
    np.testing.assert_array_equal(first.numpy()[live],
                                  np.asarray(jfirst)[live])


def test_drops_go_to_the_sink_only(setup):
    """Padding and inactive rows write nowhere but the trailing sink."""
    jcfg, cfg, jparams, params, tables, prompts, tokens = setup
    pools = P.make_pools(cfg, N_PAGES, PAGE, device="cpu")
    for s in pools:
        pools[s].fill_(7.5)
    b = len(PLENS)
    empty = np.full((b, MAXP), -1, np.int32)
    P.decode_step_paged(params, pools, _t(empty),
                        _t(np.asarray(PLENS, np.int32)),
                        _t(np.zeros(b, np.int32)), 0,
                        _t(np.zeros(b, np.float32)), cfg=cfg, page_size=PAGE)
    for s in pools:
        assert (pools[s][:-1] == 7.5).all()
        assert not (pools[s][-1] == 7.5).all()


def test_gather_scatter_roundtrip_and_flat_indices(setup):
    jcfg, cfg = setup[0], setup[1]
    np.testing.assert_array_equal(
        P.flat_page_indices([3, 5], cfg.n_layers, N_PAGES).numpy(),
        np.asarray(JP.flat_page_indices([3, 5], jcfg.n_layers, N_PAGES)))
    assert P.bucket_pages(5) == JP.bucket_pages(5) == 8
    pools = P.make_pools(cfg, N_PAGES, PAGE, device="cpu")
    rs = np.random.RandomState(1)
    for s in pools:
        pools[s].copy_(torch.tensor(rs.randn(*pools[s].shape)
                                    .astype(np.float32)))
    flat = P.flat_page_indices([3, 5], cfg.n_layers, N_PAGES)
    kv = P.gather_kv_pages(pools, flat)
    assert kv["k"].shape == (2 * cfg.n_layers, PAGE, cfg.n_kv_heads,
                             cfg.resolved_head_dim)
    dst = P.flat_page_indices([7, 9], cfg.n_layers, N_PAGES)
    P.scatter_kv_pages(pools, dst, kv)
    for s in pools:
        assert torch.equal(pools[s][dst], pools[s][flat])


def test_make_pools_needs_the_card_unless_asked_for_cpu(setup):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.make_pools(setup[1], N_PAGES, PAGE)
