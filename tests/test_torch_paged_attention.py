"""Port paged attention against the JAX reference.

The port's plain version (the CPU path of ``ops.paged_decode``) is held to
the reference's ``paged_attention_ref`` and to the Pallas kernel run in
interpret mode, on the cases of ``tests/test_kernels.py``.  Tolerance:
float32 atol 2e-5, as the reference's own kernel tests use.  The CUDA
kernel itself runs only on the card: ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention.paged_attention import \
    paged_attention as pallas_paged_attention
from repro.kernels.paged_attention.ref import paged_attention_ref as jref
from repro_torch.kernels import built_width
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention import paged_attention as pa
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

# small shapes: one intra-op thread is faster and leaves the cores to
# the other test workers
torch.set_num_threads(1)

ATOL = 2e-5
PA_CASES = [                              # b, h, kh, d, page, maxp, npages
    (2, 8, 2, 64, 128, 4, 16),
    (3, 4, 4, 128, 64, 6, 32),
    (1, 16, 8, 64, 256, 3, 8),
    (2, 8, 2, 80, 16, 5, 16),             # head dim 80: zamba2's block
    (1, 32, 8, 120, 16, 4, 8),            # head dim 120: h2o-danube
]


def _tables(b, page, maxp, npages, lens):
    tables = np.full((b, maxp), -1, np.int32)
    for i in range(b):
        need = -(-int(lens[i]) // page)
        tables[i, :need] = np.random.RandomState(i).permutation(
            npages)[:need]
    return tables


def _inputs(b, h, kh, d, page, npages, seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(b, h, d).astype(np.float32),
            rs.randn(npages, page, kh, d).astype(np.float32),
            rs.randn(npages, page, kh, d).astype(np.float32))


def _port(q, kp, vp, tables, lens):
    return paged_attention_ref(
        torch.tensor(q), torch.tensor(kp), torch.tensor(vp),
        torch.tensor(tables), torch.tensor(np.asarray(lens, np.int32))
    ).numpy()


@pytest.mark.parametrize("ppb", [1, 2, None], ids=["ppb1", "ppb2", "ppbauto"])
@pytest.mark.parametrize("case", PA_CASES,
                         ids=[f"pa{i}" for i in range(len(PA_CASES))])
def test_plain_version_matches_reference_and_pallas(case, ppb):
    b, h, kh, d, page, maxp, npages = case
    q, kp, vp = _inputs(b, h, kh, d, page, npages, seed=2)
    lens = np.minimum(np.arange(1, b + 1) * (page + 7), page * maxp)
    tables = _tables(b, page, maxp, npages, lens)
    got = _port(q, kp, vp, tables, lens)
    args = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(lens, jnp.int32))
    np.testing.assert_allclose(got, np.asarray(jref(*args)), atol=ATOL)
    pal = pallas_paged_attention(*args, pages_per_block=ppb, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pal), atol=ATOL)


def test_ragged_occupancy_empty_row_boundary_and_hole():
    """An empty slot (all -1), a length exactly on a page boundary and a
    host-swapped page (-1 mid-table) match the reference; the empty row
    is exactly 0."""
    b, h, kh, d, page, maxp, npages = 3, 4, 2, 64, 16, 7, 32
    q, kp, vp = _inputs(b, h, kh, d, page, npages, seed=9)
    lens = np.asarray([0, 32, 100], np.int32)
    tables = np.full((b, maxp), -1, np.int32)
    tables[1, :2] = [5, 9]
    tables[2, :7] = [1, 2, 3, -1, 4, 6, 7]
    got = _port(q, kp, vp, tables, lens)
    args = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(lens))
    np.testing.assert_allclose(got, np.asarray(jref(*args)), atol=ATOL)
    for ppb in (1, 2, 3, 4, None):
        pal = pallas_paged_attention(*args, pages_per_block=ppb,
                                     interpret=True)
        np.testing.assert_allclose(got, np.asarray(pal), atol=ATOL,
                                   err_msg=f"ppb={ppb}")
    assert (got[0] == 0).all()


def test_paged_decode_on_cpu_takes_the_plain_version():
    b, h, kh, d, page, maxp, npages = PA_CASES[0]
    q, kp, vp = _inputs(b, h, kh, d, page, npages, seed=4)
    lens = np.asarray([100, 300], np.int32)
    tables = _tables(b, page, maxp, npages, lens)
    before = pa.LAUNCHES
    out = ops.paged_decode(torch.tensor(q), torch.tensor(kp),
                           torch.tensor(vp), torch.tensor(tables),
                           torch.tensor(lens))
    assert pa.LAUNCHES == before
    np.testing.assert_array_equal(out.numpy(),
                                  _port(q, kp, vp, tables, lens))


def test_per_layer_pool_view_equals_biased_table():
    """Decode hands the kernel pool[l*n:(l+1)*n] with the raw table; the
    reference biases the table by l*n over the whole flat pool instead
    (``paged_model.py:496``).  Both read the same pages."""
    n_layers, n_pages, page, b, h, kh, d, maxp = 3, 8, 4, 3, 4, 2, 32, 5
    rs = np.random.RandomState(11)
    q = torch.tensor(rs.randn(b, h, d).astype(np.float32))
    pools = [torch.tensor(rs.randn(n_layers * n_pages + 1, page, kh, d)
                          .astype(np.float32)) for _ in range(2)]
    tables = torch.tensor([[3, 0, 7, -1, -1], [-1, -1, -1, -1, -1],
                           [1, -1, 2, 5, 6]], dtype=torch.int32)
    lens = torch.tensor([10, 0, 19], dtype=torch.int32)
    for li in range(n_layers):
        base = li * n_pages
        view = ops.paged_decode(q, pools[0][base:base + n_pages],
                                pools[1][base:base + n_pages], tables, lens)
        ltab = torch.where(tables >= 0, tables + base, -1).int()
        biased = ops.paged_decode(q, pools[0], pools[1], ltab, lens)
        torch.testing.assert_close(view, biased, atol=0, rtol=0)
        # the reference's own form on the same bytes
        jb = jref(jnp.asarray(q.numpy()), jnp.asarray(pools[0].numpy()),
                  jnp.asarray(pools[1].numpy()), jnp.asarray(ltab.numpy()),
                  jnp.asarray(lens.numpy()))
        np.testing.assert_allclose(view.numpy(), np.asarray(jb), atol=ATOL)
        # the views are pointer offsets into one buffer, as the kernel sees
        assert pools[0][base:base + n_pages].data_ptr() == (
            pools[0].data_ptr() + base * page * kh * d * 4)


def test_wrapper_refuses_cpu_tensors_instead_of_falling_back():
    b, h, kh, d, page, maxp, npages = PA_CASES[0]
    q, kp, vp = _inputs(b, h, kh, d, page, npages, seed=1)
    lens = np.asarray([5, 6], np.int32)
    before = pa.LAUNCHES
    with pytest.raises(ValueError, match="CUDA device"):
        pa.paged_attention(torch.tensor(q), torch.tensor(kp),
                           torch.tensor(vp),
                           torch.tensor(_tables(b, page, maxp, npages, lens)),
                           torch.tensor(lens))
    assert pa.LAUNCHES == before


def test_paged_decode_raises_for_other_devices():
    q = torch.zeros(1, 2, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.paged_decode(q, q, q, q, q)


# ------------------------------------------------ the Hopper kernel's order
# ``csrc/paged_attention.cu`` walks each row in splits of pages_per_split
# pages, each split in tiles of TILE tokens across page boundaries; a tile's
# token i belongs to token group i % tpp (the lanes that score it), each
# group keeps its own running max, sum and accumulator in log2 units and
# takes its max once per tile; the groups merge (a shuffle tree inside each
# warp, then across the warps), each split leaves a partial state, and the
# row's splits merge last.  This emulation does the same in plain float32
# PyTorch, for the bf16 (8 elements per 16-byte lane) and the float32 (4)
# lane layouts.
THREADS, WARP = 128, 32
LOG2E = 1.4426950408889634


def _merge(a, b):
    """Merge two (m, l, acc) states taken in log2 units."""
    m = torch.maximum(a[0], b[0])
    ca, cb = torch.exp2(a[0] - m), torch.exp2(b[0] - m)
    return m, a[1] * ca + b[1] * cb, a[2] * ca[..., None] + b[2] * cb[..., None]


def emulate_kernel(q, kp, vp, tables, lens, *, pages_per_split, vec=8,
                   sm_scale=None):
    b, h, d = q.shape
    n_pages, page, kh, _ = kp.shape
    g = h // kh
    ch = built_width(d) // vec                  # lanes per token
    tpp = THREADS // ch                         # token groups per block
    nk = pa.TILE // tpp                         # tokens per group per tile
    gpw = WARP // ch                            # token groups per warp
    maxp, pps = tables.shape[1], pages_per_split
    scale = (1.0 / np.sqrt(d) if sm_scale is None else sm_scale) * LOG2E
    out = torch.zeros(b, kh, g, d)
    neg = torch.tensor(-1e30)
    for bi in range(b):
        n = int(lens[bi])
        row_pages = min(-(-n // page), maxp) if n > 0 else 0
        qs = q[bi].reshape(kh, g, d).float() * scale
        parts = []
        for z in range(-(-row_pages // pps)):   # splits past the row: none
            sl = tables[bi, z * pps:(z + 1) * pps]      # the table slice
            t0 = z * pps * page
            t1 = min(n, (z * pps + len(sl)) * page)
            m = torch.full((kh, g, tpp), -1e30)
            l = torch.zeros(kh, g, tpp)
            acc = torch.zeros(kh, g, tpp, d)
            for t in range(-(-(t1 - t0) // pa.TILE)):
                rel = t * pa.TILE + torch.arange(pa.TILE)
                inside = t0 + rel < t1
                pp = torch.where(inside, sl[(rel // page).clamp(
                    max=len(sl) - 1)].long(), -1)
                ok = (pp >= 0) & (pp < n_pages)
                safe = pp.clamp(0, n_pages - 1)
                k = torch.where(ok[:, None, None], kp[safe, rel % page],
                                0.0).float()
                v = torch.where(ok[:, None, None], vp[safe, rel % page],
                                0.0).float()
                s = torch.where(ok, torch.einsum("kgd,tkd->kgt", qs, k), neg)
                s = s.reshape(kh, g, nk, tpp)   # token i: slot i // tpp
                mn = torch.maximum(m, s.max(2).values)
                alpha = torch.exp2(m - mn)
                m, l, acc = mn, l * alpha, acc * alpha[..., None]
                p = torch.where(ok.reshape(nk, tpp),
                                torch.exp2(s - m[:, :, None]), 0.0)
                l = l + p.sum(2)
                acc = acc + torch.einsum("kgnt,ntkd->kgtd", p,
                                         v.reshape(nk, tpp, kh, d))
            state = [x.reshape(kh, g, tpp // gpw, gpw, *x.shape[3:])
                     for x in (m, l, acc)]
            o = 1                               # shuffle tree in each warp
            while o < gpw:
                idx = torch.arange(gpw) ^ o
                state = list(_merge(state, [x[:, :, :, idx] for x in state]))
                o *= 2
            state = [x[:, :, :, 0] for x in state]     # one per warp
            mx = state[0].max(2).values                 # then across warps
            c = torch.exp2(state[0] - mx[..., None])
            parts.append((mx, (state[1] * c).sum(2),
                          (state[2] * c[..., None]).sum(2)))
        if not parts:
            continue                            # empty row: exactly 0
        mx = torch.stack([pm for pm, _, _ in parts]).max(0).values
        lsum, acc = torch.zeros(kh, g), torch.zeros(kh, g, d)
        for pm, pl_, pa_ in parts:
            c = torch.exp2(pm - mx)
            lsum, acc = lsum + c * pl_, acc + c[..., None] * pa_
        out[bi] = torch.where(lsum[..., None] > 0,
                              acc / torch.where(lsum > 0, lsum, 1.0)[..., None],
                              0.0)
    return out.reshape(b, h, d)


def _ragged():
    tables = np.full((3, 7), -1, np.int32)
    tables[1, :2] = [5, 9]
    tables[2, :7] = [1, 2, 3, -1, 4, 6, 7]
    return (3, 4, 2, 64, 16, 7, 32), np.asarray([0, 32, 100]), tables


EMU_CASES = {f"pa{i}": (c, None, None) for i, c in enumerate(PA_CASES)}
EMU_CASES.update({
    "ragged": _ragged(),
    "g1": ((2, 4, 4, 64, 16, 12, 32), None, None),
    "g8": ((2, 16, 2, 128, 16, 12, 32), None, None),
    "d48": ((2, 6, 2, 48, 16, 9, 24), None, None),
    "d80g5": ((2, 10, 2, 80, 16, 9, 24), None, None),
    "d120": ((2, 8, 2, 120, 16, 12, 32), None, None),
    # rows ending on a tile (32), on a split of 8 pages (128), on two
    # splits (256) and one token past a split; a zero-length row
    "edges": ((5, 6, 2, 64, 16, 24, 96),
              np.asarray([32, 128, 256, 129, 0]), None),
})


def _emu_inputs(name):
    case, lens, tables = EMU_CASES[name]
    b, h, kh, d, page, maxp, npages = case
    q, kp, vp = _inputs(b, h, kh, d, page, npages, seed=5)
    if lens is None:
        lens = np.minimum(np.arange(1, b + 1) * (page * maxp // b + 7),
                          page * maxp)
    if tables is None:
        tables = _tables(b, page, maxp, npages, lens)
    return case, q, kp, vp, tables, np.asarray(lens, np.int32)


@pytest.mark.parametrize("vec", [8, 4], ids=["bf16lanes", "f32lanes"])
@pytest.mark.parametrize("name", list(EMU_CASES))
def test_kernel_order_of_work_matches_plain_version(name, vec):
    """The emulation at the planner's split and at splits of 1 and 3 pages
    equals the port's plain version (fp32 atol 2e-5)."""
    case, q, kp, vp, tables, lens = _emu_inputs(name)
    b, h, kh, d, page, maxp, npages = case
    want = _port(q, kp, vp, tables, lens)
    args = [torch.tensor(x) for x in (q, kp, vp, tables, lens)]
    for pps in {pa.plan(b, h, kh, maxp, page, 132), 1, 3}:
        got = emulate_kernel(*args, pages_per_split=pps, vec=vec).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL,
                                   err_msg=f"pages_per_split={pps}")
        assert (got[lens == 0] == 0).all()


@pytest.mark.parametrize("name", list(EMU_CASES))
def test_kernel_order_of_work_matches_pallas_kernel(name):
    """The emulation at the planner's split against the reference's
    ``_pa_kernel`` in interpret mode and its ``paged_attention_ref``."""
    case, q, kp, vp, tables, lens = _emu_inputs(name)
    b, h, kh, d, page, maxp, npages = case
    got = emulate_kernel(
        *[torch.tensor(x) for x in (q, kp, vp, tables, lens)],
        pages_per_split=pa.plan(b, h, kh, maxp, page, 132)).numpy()
    args = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(lens))
    np.testing.assert_allclose(got, np.asarray(jref(*args)), atol=ATOL)
    pal = pallas_paged_attention(*args, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pal), atol=ATOL)


def test_kernel_order_of_work_takes_sm_scale():
    case, q, kp, vp, tables, lens = _emu_inputs("pa3")
    args = [torch.tensor(x) for x in (q, kp, vp, tables, lens)]
    got = emulate_kernel(*args, pages_per_split=2, sm_scale=0.3)
    want = paged_attention_ref(*args, sm_scale=0.3)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


PLAN_SHAPES = [                           # b, h, kh, maxp, page, sms
    (16, 9, 3, 64, 16, 132),              # smollm decode (phase 4)
    (8, 32, 8, 66, 16, 132),              # h2o-danube decode (phase 10)
    (192, 9, 3, 8, 16, 132), (1, 16, 8, 3, 256, 132), (3, 4, 4, 6, 64, 132),
    (4, 6, 2, 9, 5, 132), (1, 64, 8, 4096, 16, 132), (2, 40, 8, 700, 16, 78),
    (1, 1, 1, 1, 1, 1), (64, 64, 8, 2048, 128, 132)]


@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=[f"s{i}" for i in range(len(PLAN_SHAPES))])
def test_split_planner_covers_every_page_once(shape):
    b, h, kh, maxp, page, sms = shape
    pps = pa.plan(b, h, kh, maxp, page, sms)
    splits = -(-maxp // pps)
    assert 1 <= pps <= min(maxp, pa.MAX_SPLIT_PAGES)
    # split z holds pages [z * pps, min((z + 1) * pps, maxp)): together
    # every page once, and no split starts at or past maxp
    covered = [p for z in range(splits)
               for p in range(z * pps, min((z + 1) * pps, maxp))]
    assert covered == list(range(maxp))
    assert (splits - 1) * pps < maxp
    # long enough for the ring: MIN_TILES_PER_SPLIT tiles, unless the row
    # (or the table slice's room) is shorter
    assert pps * page >= min(pa.MIN_TILES_PER_SPLIT * pa.TILE, maxp * page,
                             pa.MAX_SPLIT_PAGES * page)
    assert pa.plan(b, h, kh, maxp, page, sms) == pps     # pure, memoised


def test_split_planner_at_the_decode_shapes():
    """smollm's decode (B 16, K 3, maxp 64, page 16): 8 splits of 8 pages
    (128 tokens, 4 tiles); h2o-danube's (B 8, K 8, maxp 66): 9 of 8."""
    assert pa.plan(16, 9, 3, 64, 16, 132) == 8
    assert pa.plan(8, 32, 8, 66, 16, 132) == 8
    assert pa.plan(192, 9, 3, 8, 16, 132) == 8       # one split per row
