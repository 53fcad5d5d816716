"""Tests of the port that need the CUDA card (the kernels have no CPU mode).

They skip without a card.  On the machine with the H100, which has no
JAX, run them without the JAX-importing ``conftest.py``:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX or of the JAX package.  Tolerances: a
kernel's output against its plain version in float32 at atol 2e-5 (the
JAX package's kernel tolerance; 5e-4 for the flash-attention gradients, as
its backward tests), in bf16 at atol 2e-2 against the plain version run in
float32 on the same bf16 inputs.  The bf16 flash-attention gradients come
from the tensor-core kernels, which round dS (dq) and P and dS (dk, dv)
to bf16 before their last products: they are held to the elementwise
bounds ``ref.bf16_dq_bound`` and ``ref.bf16_dkv_bound`` derive from that
rounding.  Head dims 80 and 120 (zamba2's shared block, h2o-danube) run
on the kernels built for 128, 48 on the one built for 64.  The SSD scan kernel: y and the final state at atol 5e-4 (the
reference's SSD tests) plus rtol 2^-12, because the two versions sum the
prefix of dt * A over a chunk in float32 in other orders, and at L 256 its
rounding moves each decay by ~1e-4 of its value; in bf16, y at rtol 2^-8
instead, for the one bf16 rounding of each stored y.  The bf16 SSD runs
on the tensor cores with every float32 operand split into bf16 hi + lo,
which keeps these tolerances (``tests/test_torch_ssd.py`` emulates it).
The SSD backward kernel against ``ref.ssd_chunked_bwd``: dx and dinit at
the same tolerances (bf16 dx at rtol 2^-8); ddt, dA, dB and dC, sums whose
terms cancel, normwise at 2^-12 of their largest value (``_bwd_close``).
"""
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.services.mmu import MMU, MMUConfig
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref,
                                                     bf16_dkv_bound,
                                                     bf16_dq_bound)
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention import paged_attention as pa
from repro_torch.kernels.paged_attention import paged_prefill as pp
from repro_torch.kernels.paged_attention.ref import (bf16_prefill_bound,
                                                     paged_attention_ref,
                                                     paged_prefill_ref)
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.kernels.ssd import ssd as ssd_k
from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_chunked_bwd
from repro_torch.models import transformer as T
from repro_torch.models.transformer import init_params
from repro_torch.serve import paged_model as P
from repro_torch.serve.engine import ServingEngine
from repro_torch.train.loop import TrainConfig, Trainer

pytestmark = pytest.mark.cuda

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
CASES = [                                 # b, h, kh, d, page, maxp, npages
    (2, 8, 2, 64, 128, 4, 16),            # tests/test_kernels.py PA_CASES
    (3, 4, 4, 128, 64, 6, 32),
    (1, 16, 8, 64, 256, 3, 8),
    (4, 6, 2, 32, 5, 9, 40),              # D=32, odd page, G=3
    (192, 9, 3, 64, 16, 8, 2048),         # fills the card: one pass
    (2, 8, 2, 80, 16, 9, 40),             # D 80: zamba2's shared block
    (3, 32, 8, 120, 16, 6, 32),           # D 120: h2o-danube, G=4
    (2, 4, 2, 48, 8, 5, 16),              # D 48: run as 64
    (2, 16, 2, 128, 16, 20, 64),          # G 8: qwen2, chameleon
    (2, 20, 2, 64, 16, 12, 32),           # G 10: two blocks of heads
    (2, 4, 4, 64, 16, 24, 64),            # G 1, several splits
    (16, 3, 1, 64, 16, 64, 2048),         # smollm at TP 3: 1 KV head a rank
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(case, seed, dtype, card, lens=None):
    b, h, kh, d, page, maxp, npages = case
    rs = np.random.RandomState(seed)
    if lens is None:
        lens = np.minimum(rs.randint(0, page * maxp + 1, size=b),
                          page * maxp)
    lens = np.asarray(lens)
    lens[0] = 0                                   # an empty row
    tables = np.full((b, maxp), -1, np.int32)
    for i in range(b):
        need = -(-int(lens[i]) // page)
        tables[i, :need] = rs.permutation(npages)[:need]
        if need > 2:
            tables[i, need // 2] = -1             # a page out on the host
    q, kp, vp = (torch.tensor(rs.randn(*shape).astype(np.float32))
                 .to(card, dtype) for shape in
                 ((b, h, d), (npages, page, kh, d), (npages, page, kh, d)))
    return (q, kp, vp, torch.tensor(tables).to(card),
            torch.tensor(lens, dtype=torch.int32).to(card))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[f"c{i}" for i in range(len(CASES))])
def test_kernel_matches_plain_version(card, case, dtype):
    q, kp, vp, tables, lens = _inputs(case, 3, getattr(torch, dtype), card)
    before = pa.LAUNCHES
    out = ops.paged_decode(q, kp, vp, tables, lens)
    assert pa.LAUNCHES == before + 1
    want = paged_attention_ref(q.float(), kp.float(), vp.float(), tables,
                               lens)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype
    torch.testing.assert_close(out.float(), want, atol=ATOL[dtype], rtol=0)
    assert (out[0] == 0).all()                    # empty row: exactly 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stages", [1, 2, 3, 4, 6])
def test_kernel_variants_match_and_count(card, stages, dtype):
    """Every ring depth with splits of 1, 3 and the planner's pages (the
    row's last block merging 24, 8 or 3 splits); each launch counted."""
    case = (5, 9, 3, 64, 16, 24, 128)
    # rows ending on a tile (32 tokens), on 8 and on 16 pages, and 300
    q, kp, vp, tables, lens = _inputs(case, 4, getattr(torch, dtype), card,
                                      lens=[0, 32, 128, 256, 300])
    want = paged_attention_ref(q.float(), kp.float(), vp.float(), tables,
                               lens)
    for pps in (1, 3, None):
        before = pa.LAUNCHES
        out = pa.paged_attention(q, kp, vp, tables, lens,
                                 pages_per_split=pps, stages=stages)
        assert pa.LAUNCHES == before + 1
        torch.cuda.synchronize()
        torch.testing.assert_close(out.float(), want, atol=ATOL[dtype],
                                   rtol=0, msg=f"pages_per_split={pps}")
        assert (out[0] == 0).all()


def test_kernel_skips_page_ids_past_the_pool(card):
    """A table entry >= P is never read: the output equals the plain
    version's with that entry unmapped (-1)."""
    q, kp, vp, tables, lens = _inputs((3, 8, 2, 64, 16, 12, 40), 6,
                                      torch.bfloat16, card)
    lens[:] = torch.tensor([150, 100, 190], dtype=torch.int32)
    tables[:, :12] = torch.arange(36, dtype=torch.int32).reshape(3, 12)
    tables[1, 2] = 40                              # P: past the pool
    tables[2, 5] = 1 << 30
    out = pa.paged_attention(q, kp, vp, tables, lens)
    unmapped = torch.where(tables >= 40, -1, tables).int()
    want = paged_attention_ref(q.float(), kp.float(), vp.float(), unmapped,
                               lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want, atol=ATOL["bfloat16"],
                               rtol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take(card):
    q, kp, vp, tables, lens = _inputs(CASES[0], 1, torch.float32, card)
    before = pa.LAUNCHES
    with pytest.raises(TypeError):
        pa.paged_attention(q.half(), kp.half(), vp.half(), tables, lens)
    with pytest.raises(TypeError):
        pa.paged_attention(q, kp.bfloat16(), vp.bfloat16(), tables, lens)
    with pytest.raises(TypeError):
        pa.paged_attention(q, kp, vp, tables.long(), lens)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_attention(q, kp.transpose(1, 2), vp, tables, lens)
    for d in (136, 100):      # over 128; not a multiple of 8
        wide = [torch.cat([t] * 3, -1)[..., :d].contiguous()
                for t in (q, kp, vp)]
        with pytest.raises(ValueError, match="head_dim"):
            pa.paged_attention(*wide, tables, lens)
    with pytest.raises(ValueError, match="CUDA device"):
        pa.paged_attention(q, kp, vp, tables.cpu(), lens)
    buf = torch.empty(q.numel() + 1, dtype=q.dtype, device=q.device)
    shifted = buf[1:].view(q.shape)               # contiguous, 4 bytes off
    with pytest.raises(ValueError, match="16-byte"):
        pa.paged_attention(shifted, kp, vp, tables, lens)
    for bad in ({"stages": 7}, {"pages_per_split": 2000}):
        with pytest.raises(ValueError):
            pa.paged_attention(q, kp, vp, tables, lens, **bad)
    assert pa.LAUNCHES == before


def _params(cfg, device):
    return init_params(cfg, generator=torch.Generator().manual_seed(0),
                       dtype=torch.float32, device=device)


def test_decode_launches_the_kernel_once_per_layer(card):
    """The port's twin of the reference's "decode compiles once" guard."""
    cfg = get_config("smollm-135m").reduced()
    params = _params(cfg, card)
    pools = P.make_pools(cfg, 16, 8, device=card)
    tables = torch.arange(12, dtype=torch.int32, device=card).reshape(3, 4)
    lens = torch.tensor([3, 9, 0], dtype=torch.int32, device=card)
    for _ in range(3):
        before = pa.LAUNCHES
        _, lens = P.decode_step_paged(
            params, pools, tables, lens,
            torch.zeros(3, dtype=torch.int32, device=card), 0,
            torch.zeros(3, device=card), cfg=cfg, page_size=8)
        assert pa.LAUNCHES - before == cfg.n_layers


# paged prefill at h2o-danube's chunk shape: 4 rows (the last a padding
# row), 512 queries, 32 / 8 heads of 120, page 16, 512 pages a row; each
# live row maps its prompt's pages past this chunk's keys.  ``drop``: a
# mapped page of row 1 that its queries see, for the tolerance's own check
PP_DANUBE = dict(t=512, h=32, kh=8, d=120, page=16, maxp=512, n_pages=1100,
                 q_starts=[0, 2048, 7168, 0], q_lens=[512, 300, 512, 0],
                 prompt_end=[1500, 3000, 8192, 0],
                 unmapped=[(0, 0), (1, 100)], drop=60)
# the TP-local head slices serve/tp.py hands down, at D 64
PP_TP = [dict(t=256, h=h, kh=kh, d=64, page=16, maxp=64, n_pages=200,
              q_starts=[0, 300, 700], q_lens=[256, 100, 256],
              prompt_end=[400, 700, 1024], unmapped=[(1, 3)], drop=10)
         for h, kh in ((9, 3), (3, 1))]


def _pp_inputs(spec, seed, dtype, card):
    """q, one layer's pools, tables, q_starts, q_lens on the card: every
    live row's table maps random distinct pages up to ``prompt_end``, then
    the ``unmapped`` (row, page) entries are -1."""
    rs = np.random.RandomState(seed)
    n = len(spec["q_starts"])
    page, maxp = spec["page"], spec["maxp"]
    tables = np.full((n, maxp), -1, np.int32)
    for i, end in enumerate(spec["prompt_end"]):
        need = -(-end // page)
        tables[i, :need] = rs.permutation(spec["n_pages"])[:need]
    for i, p in spec["unmapped"]:
        tables[i, p] = -1
    shapes = ((n, spec["t"], spec["h"], spec["d"]),
              (spec["n_pages"], page, spec["kh"], spec["d"]),
              (spec["n_pages"], page, spec["kh"], spec["d"]))
    q, kp, vp = (torch.tensor(rs.randn(*s).astype(np.float32)).to(card, dtype)
                 for s in shapes)
    i32 = dict(dtype=torch.int32, device=card)
    return (q, kp, vp, torch.tensor(tables).to(card),
            torch.tensor(spec["q_starts"], **i32),
            torch.tensor(spec["q_lens"], **i32))


def _pp_want(q, kp, vp, tables, q_starts, q_lens, bound=False):
    """The plain version in float32, or with ``bound`` the bf16 kernel's
    elementwise tolerance around it, a row at a time (the plain version's
    scores of one danube row are 0.5 GB)."""
    rows = []
    for i in range(q.shape[0]):
        row = (q[i:i + 1], kp, vp, tables[i:i + 1], q_starts[i:i + 1],
               q_lens[i:i + 1])
        want = paged_prefill_ref(row[0].float(), kp.float(), vp.float(),
                                 *row[3:])
        rows.append(bf16_prefill_bound(*row, want) if bound else want)
    return torch.cat(rows)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("spec", [PP_DANUBE] + PP_TP,
                         ids=["danube", "tp9_3", "tp3_1"])
def test_paged_prefill_kernel_matches_plain_version(card, spec, dtype):
    """The kernel against ``paged_prefill_ref``.  float32: atol 2e-5.
    bf16: ``ref.bf16_prefill_bound``, elementwise, for P rounded to bf16 as
    the A operand of P V and the output rounded to bf16; the inputs are the
    same bf16 values on both sides.  The tolerance is tight enough to see
    one of row 1's visible pages left out.  Padded queries (t >= q_len) are
    compared like the rest; a query with no visible key (the padding row,
    and row 0's first page, which is unmapped) is exactly 0."""
    args = _pp_inputs(spec, 7, getattr(torch, dtype), card)
    before = (pp.LAUNCHES, pp.WGMMA_LAUNCHES, pp.FMA_LAUNCHES)
    out = ops.paged_prefill(*args)
    tc = dtype == "bfloat16"            # the dtype picks the kernel
    assert (pp.LAUNCHES, pp.WGMMA_LAUNCHES, pp.FMA_LAUNCHES) == (
        before[0] + 1, before[1] + tc, before[2] + (not tc))
    want = _pp_want(*args)
    tol = (_pp_want(*args, bound=True) if tc
           else torch.full_like(want, ATOL[dtype]))
    torch.cuda.synchronize()
    assert out.dtype == args[0].dtype and out.shape == args[0].shape
    err = (out.float() - want).abs()
    assert (err <= tol).all(), f"error at {float((err / tol).max()):.3f}x tol"
    q, kp, vp, tables, q_starts, q_lens = args
    dropped = tables[1:2].clone()
    assert dropped[0, spec["drop"]] >= 0
    dropped[0, spec["drop"]] = -1
    moved = _pp_want(q[1:2], kp, vp, dropped, q_starts[1:2], q_lens[1:2])
    assert ((out[1].float() - moved[0]).abs() > tol[1]).any()
    if spec is PP_DANUBE:
        assert (out[-1] == 0).all()              # the padding row
        assert (out[0, :spec["page"]] == 0).all()  # only page 0, unmapped
        assert (out[0, spec["page"]:].abs().amax(-1) > 0).all()


def test_paged_prefill_chunk_launches_the_kernel_once_per_layer(card):
    """Both prefill entry points launch the prefill kernel n_layers times a
    call, in float32 (FMA) and in bf16 (wgmma), and no dense flash kernel."""
    cfg = get_config("smollm-135m").reduced()
    tables = torch.arange(12, dtype=torch.int32, device=card).reshape(3, 4)
    q_lens = torch.tensor([16, 9, 0], dtype=torch.int32, device=card)
    q_starts = torch.tensor([16, 0, 0], dtype=torch.int32, device=card)
    tokens = torch.ones(3, 16, dtype=torch.int32, device=card)
    for dtype in (torch.float32, torch.bfloat16):
        params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                             dtype=dtype, device=card)
        pools = P.make_pools(cfg, 16, 16, dtype=dtype, device=card)
        before, fa_before = pp.LAUNCHES, fa.LAUNCHES
        P.prefill_chunk_paged(params, pools, tokens, q_lens, q_starts,
                              tables, cfg=cfg, page_size=16)
        assert pp.LAUNCHES - before == cfg.n_layers
        P.prefill_shared_paged(params, pools, tokens, q_lens, q_starts,
                               q_starts, tables, 0,
                               torch.zeros(3, device=card), cfg=cfg,
                               page_size=16)
        assert pp.LAUNCHES - before == 2 * cfg.n_layers
        assert fa.LAUNCHES == fa_before
        torch.cuda.synchronize()


def test_paged_prefill_wrapper_rejects_what_the_kernel_does_not_take(card):
    args = _pp_inputs(PP_TP[0], 1, torch.bfloat16, card)
    q, kp, vp, tables, q_starts, q_lens = args
    before = pp.LAUNCHES
    for d in (136, 100):      # over 128; not a multiple of 8
        wide = [torch.cat([t] * 3, -1)[..., :d].contiguous()
                for t in (q, kp, vp)]
        with pytest.raises(ValueError, match="head_dim"):
            pp.paged_prefill(*wide, tables, q_starts, q_lens)
    with pytest.raises(TypeError):
        pp.paged_prefill(q, kp, vp, tables.long(), q_starts, q_lens)
    with pytest.raises(TypeError):
        pp.paged_prefill(q.float(), kp, vp, tables, q_starts, q_lens)
    odd = [t[:, :12].contiguous() for t in (kp, vp)]   # page 12, bf16
    with pytest.raises(ValueError, match="page size"):
        pp.paged_prefill(q, *odd, tables, q_starts, q_lens)
    with pytest.raises(ValueError, match="CUDA device"):
        pp.paged_prefill(q, kp, vp, tables.cpu(), q_starts, q_lens)
    assert pp.LAUNCHES == before


def _serve(cfg, device, modes):
    mmu = MMU(MMUConfig(page_size=8, n_pages=128))
    eng = ServingEngine(cfg, _params(cfg, device), mmu, max_batch=3,
                        max_len=96, prefill_chunk=16, device=device)
    rs = np.random.RandomState(2)
    for m in modes:
        eng.submit(rs.randint(0, cfg.vocab_size,
                              int(rs.randint(3, 40))).tolist(),
                   max_new_tokens=6, **m)
    eng.run()
    assert mmu.utilization()["pages_used"] == 0
    return {r.rid: r.out_tokens for r in eng.completed}


def test_engine_on_the_card_matches_the_cpu(card):
    """Greedy streams of the reduced model, fp32, with churn and chunked
    prefill: the card (kernel) and the CPU (plain version) agree."""
    cfg = get_config("smollm-135m").reduced()
    modes = [{}] * 5
    before = pa.LAUNCHES
    got = _serve(cfg, card, modes)
    assert pa.LAUNCHES > before
    assert got == _serve(cfg, "cpu", modes)


def _prefill_paged(cfg, device):
    """The batched padded prefill of tests/test_torch_decode_hot_path.py
    on ``device``: a padding row, a sampled row, and a row whose third page
    is out on the host (its tokens drop to the sink)."""
    page, n_pages, maxp = 8, 32, 6
    rs = np.random.RandomState(1)
    lens = np.asarray([13, 40, 0, 7], np.int32)
    tokens = rs.randint(0, cfg.vocab_size, size=(4, 40))
    tables = np.full((4, maxp), -1, np.int32)
    perm = rs.permutation(n_pages)
    tables[0, :2], tables[1, :5], tables[3, :1] = (perm[:2], perm[2:7],
                                                   perm[7:8])
    tables[1, 2] = -1
    pools = P.make_pools(cfg, n_pages, page, device=device)
    first = P.prefill_paged(
        _params(cfg, device), pools, torch.as_tensor(tokens),
        torch.as_tensor(lens), torch.as_tensor(tables), 0,
        torch.tensor([0.0, 0.9, 0.0, 0.0]), cfg=cfg, page_size=page)
    return first.cpu()[lens > 0], {s: pools[s][:-1].cpu() for s in pools}


def test_prefill_paged_on_the_card_matches_the_cpu(card):
    """``prefill_paged`` (and its ``write_prefill`` scatter) on the card:
    the pools below the sink within atol 1e-4 of the CPU run's (fp32,
    flash forward kernel against the plain softmax), first tokens equal,
    the sampled row included."""
    cfg = get_config("smollm-135m").reduced()
    before = fa.LAUNCHES
    first, pools = _prefill_paged(cfg, card)
    assert fa.LAUNCHES - before == cfg.n_layers
    want_first, want_pools = _prefill_paged(cfg, "cpu")
    assert torch.equal(first, want_first)
    for side in ("k", "v"):
        torch.testing.assert_close(pools[side], want_pools[side],
                                   atol=1e-4, rtol=0)


# ----------------------------------------------------------- flash attention
FA_CASES = [                    # b, h, kh, sq, sk, d, causal, window
    (2, 4, 2, 256, 256, 64, True, 0),     # tests/test_kernels.py FA_CASES
    (1, 8, 8, 128, 384, 128, True, 0),
    (2, 4, 1, 200, 200, 64, True, 0),     # ragged: last tile part-filled
    (1, 4, 2, 256, 256, 64, True, 128),   # sliding window
    (1, 2, 2, 128, 256, 64, False, 0),    # cross-attention shape
    (1, 4, 2, 128, 128, 64, True, 0),
    (2, 4, 2, 77, 77, 32, True, 0),       # head_dim 32: the reduced model
    (1, 6, 2, 300, 300, 32, True, 100),   # D 32, window, ragged
    (2, 4, 2, 200, 200, 128, True, 96),   # D 128, window, ragged, GQA
    (1, 3, 1, 130, 70, 128, False, 0),    # D 128, Sq > Sk, no mask
    (2, 4, 2, 200, 200, 80, True, 0),     # D 80, ragged
    (1, 4, 1, 130, 130, 120, True, 64),   # D 120, window, ragged
    (1, 4, 2, 96, 96, 48, True, 0),       # D 48
    (2, 32, 8, 2048, 2048, 120, True, 0),  # h2o-danube-3-4b's shape
    (1, 32, 8, 4200, 4200, 120, True, 4096),  # and past its window
    (8, 16, 16, 1500, 1500, 64, False, 0),  # whisper's encoder, 1500 frames
    (8, 16, 16, 448, 1500, 64, False, 0),  # its training cross-attention
    (8, 16, 16, 32, 1500, 64, False, 0),  # its prefill cross-attention
    (8, 16, 16, 448, 448, 64, True, 0),   # its decoder self-attention
    (8, 16, 16, 32, 32, 64, True, 0),     # its prefill self-attention
    (2, 16, 16, 200, 200, 64, True, 0),   # its fp32 consistency prefills:
    (2, 16, 16, 200, 1500, 64, False, 0),  # 200 and 201 tokens, self and
    (2, 16, 16, 201, 201, 64, True, 0),   # cross attention
    (2, 16, 16, 201, 1500, 64, False, 0),
    (2, 4, 2, 37, 203, 64, False, 0),     # ragged Sq and Sk, no mask
]
BWD_CASES = [                   # tests/test_kernels.py BWD_CASES
    (1, 4, 2, 128, 128, 64, True, 0),
    (2, 2, 1, 96, 160, 64, True, 0),
    (1, 4, 4, 128, 128, 64, False, 0),
    (1, 2, 2, 128, 128, 64, True, 64),
    (1, 2, 1, 100, 100, 128, True, 0),
    (2, 4, 2, 77, 77, 32, True, 0),       # D 32, ragged
    (1, 6, 2, 300, 300, 32, True, 100),   # D 32, window, GQA
    (2, 4, 2, 200, 200, 128, True, 96),   # D 128, window, ragged
    (1, 2, 2, 70, 130, 128, False, 0),    # D 128, Sq < Sk, no mask
    (2, 4, 2, 200, 200, 80, True, 0),     # D 80, ragged
    (1, 4, 1, 130, 130, 120, True, 64),   # D 120, window, ragged
    (1, 4, 2, 96, 96, 48, True, 0),       # D 48
    (2, 32, 8, 2048, 2048, 120, True, 0),  # h2o-danube-3-4b's shape
    (8, 16, 16, 448, 1500, 64, False, 0),  # whisper's training cross
    (8, 16, 16, 448, 448, 64, True, 0),   # its decoder self-attention
    (8, 16, 16, 1500, 1500, 64, False, 0),  # whisper's encoder
    (2, 4, 2, 37, 203, 64, False, 0),     # ragged Sq and Sk, no mask
]


def _fa_inputs(case, seed, dtype, card, n=3):
    b, h, kh, sq, sk, d = case[:6]
    rs = np.random.RandomState(seed)
    shapes = [(b, h, sq, d), (b, kh, sk, d), (b, kh, sk, d)]
    shapes += [(b, h, sq, d)] * (n - 3)
    return [torch.tensor(rs.randn(*s).astype(np.float32)).to(card, dtype)
            for s in shapes]


def _close_grad(got, want, dtype, bound=None):
    """float32 at atol 5e-4; bf16 within ``bound`` from
    ``ref.bf16_dq_bound`` or ``ref.bf16_dkv_bound``."""
    if bound is None:
        torch.testing.assert_close(got.float(), want, atol=5e-4, rtol=0)
        return
    excess = float(((got.float() - want).abs() - bound).max())
    assert excess <= 0, f"{excess} past the bf16 gradient bound"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FA_CASES,
                         ids=[f"fa{i}" for i in range(len(FA_CASES))])
def test_flash_forward_matches_plain_version(card, case, dtype):
    causal, window = case[6], case[7]
    q, k, v = _fa_inputs(case, 4, getattr(torch, dtype), card)
    before = (fa.LAUNCHES, fa.WGMMA_LAUNCHES, fa.FMA_LAUNCHES)
    o, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                return_lse=True)
    tc = dtype == "bfloat16"            # the dtype picks the kernel
    assert (fa.LAUNCHES, fa.WGMMA_LAUNCHES, fa.FMA_LAUNCHES) == (
        before[0] + 1, before[1] + tc, before[2] + (not tc))
    want_o, want_lse = attention_ref(q.float(), k.float(), v.float(),
                                     causal=causal, window=window)
    torch.cuda.synchronize()
    assert o.dtype == q.dtype and lse.dtype == torch.float32
    torch.testing.assert_close(o.float(), want_o, atol=ATOL[dtype], rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BWD_CASES,
                         ids=[f"fabwd{i}" for i in range(len(BWD_CASES))])
def test_flash_backward_matches_plain_version(card, case, dtype):
    causal, window = case[6], case[7]
    q, k, v, do = _fa_inputs(case, 5, getattr(torch, dtype), card, n=4)
    o, lse = fa.flash_attention(q, k, v, causal=causal, window=window,
                                return_lse=True)
    counts = lambda: (  # noqa: E731
        fab.DQ_LAUNCHES, fab.DKV_LAUNCHES, fab.DQ_WGMMA_LAUNCHES,
        fab.DQ_FMA_LAUNCHES, fab.DKV_WGMMA_LAUNCHES, fab.DKV_FMA_LAUNCHES)
    before = counts()
    dq, dk, dv = fab.flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                         window=window)
    tc = dtype == "bfloat16"
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + tc,
                        before[3] + (not tc), before[4] + tc,
                        before[5] + (not tc))
    f32 = [t.float() for t in (q, k, v, o, do)]
    want = attention_bwd_ref(*f32, lse, causal=causal, window=window)
    kw = dict(causal=causal, window=window)
    bounds = ((None, None, None) if dtype == "float32" else
              (bf16_dq_bound(*f32, lse, **kw),
               *bf16_dkv_bound(*f32, lse, **kw)))
    del f32
    torch.cuda.synchronize()
    for got, ref, bound in zip((dq, dk, dv), want, bounds):
        assert got.dtype == q.dtype
        _close_grad(got, ref, dtype, bound)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [32, 64, 80, 120, 128])
def test_flash_kernels_read_the_model_layout_through_strides(card, d, dtype):
    """(B, S, H, D) activations go in as transposed views, no copy: the
    outputs keep that layout and equal the contiguous inputs' results."""
    rs = np.random.RandomState(6)
    b, s, h, kh = 2, 130, 6, 2
    q, k, v, do = (torch.tensor(rs.randn(b, s, n, d).astype(np.float32),
                                device=card).to(getattr(torch, dtype))
                   .transpose(1, 2) for n in (h, kh, kh, h))
    assert all(fa.readable(t) is t for t in (q, k, v, do))
    o, lse = fa.flash_attention(q, k, v, return_lse=True)
    assert o.stride() == q.stride()
    grads = fab.flash_attention_bwd(q, k, v, o, do, lse)
    want_o, want_lse = fa.flash_attention(*(t.contiguous() for t in (q, k, v)),
                                          return_lse=True)
    want = fab.flash_attention_bwd(*(t.contiguous()
                                     for t in (q, k, v, o, do)), want_lse)
    torch.cuda.synchronize()
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    for got, ref in zip(grads, want):
        assert torch.equal(got, ref)


def test_flash_wrappers_reject_what_the_kernels_do_not_take(card):
    q, k, v = _fa_inputs(FA_CASES[0], 1, torch.float32, card)
    before = (fa.LAUNCHES, fab.DQ_LAUNCHES, fab.DKV_LAUNCHES)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.bfloat16(), v.bfloat16())
    for d in (136, 100):      # over 128; not a multiple of 8
        wide = [torch.cat([t] * 3, -1)[..., :d] for t in (q, k, v)]
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention(*wide)
    with pytest.raises(ValueError, match="group"):
        fa.flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention(q, k.cpu(), v)
    lse = torch.zeros(q.shape[:3], device=card)
    with pytest.raises(ValueError, match="lse"):
        fab.flash_attention_bwd(q, k, v, q, q, lse.double())
    assert (fa.LAUNCHES, fab.DQ_LAUNCHES, fab.DKV_LAUNCHES) == before


@pytest.mark.parametrize("heads", [(2, 2), (4, 2)], ids=["mha", "gqa"])
def test_mha_fused_gradient_matches_autograd_of_plain_forward(card, heads):
    """The port's twin of test_mha_fused_custom_vjp_end_to_end (atol 1e-3)."""
    h, kh = heads
    q, k, v = (t.requires_grad_(True) for t in
               _fa_inputs((1, h, kh, 128, 128, 64), 8, torch.float32, card))
    before = (fa.LAUNCHES, fab.DQ_LAUNCHES, fab.DKV_LAUNCHES)
    g1 = torch.autograd.grad((fa_ops.mha_fused(q, k, v) ** 2).sum(),
                             (q, k, v))
    assert (fa.LAUNCHES, fab.DQ_LAUNCHES, fab.DKV_LAUNCHES) == tuple(
        n + 1 for n in before)
    g2 = torch.autograd.grad((attention_ref(q, k, v)[0] ** 2).sum(),
                             (q, k, v))
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=0)


def test_mha_fused_gradient_at_whisper_cross_shape(card):
    """Non-causal cross-attention, Sq 448 against Sk 1500 (whisper's
    training shape), float32: the backward gets the non-causal forward's
    lse; atol 1e-3 as the test above."""
    q, k, v = (t.requires_grad_(True) for t in _fa_inputs(
        (8, 16, 16, 448, 1500, 64), 9, torch.float32, card))
    g1 = torch.autograd.grad(
        (fa_ops.mha_fused(q, k, v, False) ** 2).sum(), (q, k, v))
    g2 = torch.autograd.grad(
        (attention_ref(q, k, v, causal=False)[0] ** 2).sum(), (q, k, v))
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=0)


def test_whisper_serving_and_training_on_the_card_match_the_cpu(card,
                                                                tmp_path):
    """Reduced whisper, fp32: prefill (encoder, self and cross attention
    on the flash forward kernel) and 4 greedy decode steps, then 3
    Trainer steps, card against CPU."""
    cfg = get_config("whisper-medium").reduced()
    params = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                           dtype=torch.float32, device="cpu")
    rs = np.random.RandomState(0)
    toks = torch.as_tensor(rs.randint(0, cfg.vocab_size, (2, 12)))
    frames = torch.as_tensor(rs.randn(2, cfg.encoder_seq_len,
                                      cfg.d_model).astype(np.float32))
    out = {}
    for dev in ("cpu", card):
        p = tree_map(lambda t: t.to(dev), params)
        before = fa.LAUNCHES
        logits, cache = T.prefill(p, cfg, toks.to(dev), 20,
                                  encoder_frames=frames.to(dev),
                                  cache_dtype=torch.float32)
        if dev == card:
            assert fa.LAUNCHES - before == (cfg.n_encoder_layers
                                            + 2 * cfg.n_layers)
        seq = [logits.cpu()]
        for t in range(12, 16):
            nxt = logits[:, :cfg.vocab_size].argmax(-1, keepdim=True)
            logits, cache = T.decode_step(p, cfg, cache, nxt,
                                          torch.full((2,), t, device=dev))
            seq.append(logits.cpu())
        out[str(dev)] = (seq, {k: v.cpu() for k, v in cache.items()})
    (cs, cc), (gs, gc) = out["cpu"], out["cuda"]
    for a, b in zip(cs, gs):
        assert torch.equal(a.argmax(-1), b.argmax(-1))
        torch.testing.assert_close(b, a, atol=1e-4, rtol=0)
    for k in ("k", "v", "xk", "xv"):
        torch.testing.assert_close(gc[k], cc[k], atol=1e-4, rtol=0)
    losses = {}
    for dev in ("cpu", card):
        t = Trainer(cfg, ShapeConfig("t", "train", 32, 2), TrainConfig(
            steps=3, log_every=1, ckpt_every=0, seed=4,
            ckpt_dir=str(tmp_path)), device=dev)
        t.run()
        losses[str(dev)] = [m["loss"] for m in t.metrics_log]
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], atol=1e-4)


def test_trainer_on_the_card_matches_the_cpu(card, tmp_path):
    """Reduced smollm, fp32, 3 steps from the same weights: the card (the
    flash kernels) and the CPU (the chunked plain attention) agree."""
    cfg = get_config("smollm-135m").reduced()
    shape = ShapeConfig("t", "train", 96, 2)
    runs = {}
    for dev in ("cpu", card):
        before = fa.LAUNCHES
        t = Trainer(cfg, shape, TrainConfig(
            steps=3, log_every=1, ckpt_every=0, seed=4,
            ckpt_dir=str(tmp_path)), device=dev)
        t.run()
        if dev == card:
            assert fa.LAUNCHES - before == 3 * cfg.n_layers
        runs[str(dev)] = [m["loss"] for m in t.metrics_log]
    np.testing.assert_allclose(runs["cuda"], runs["cpu"], atol=1e-4)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b",
                                  "granite-moe-1b-a400m"])
def test_ssm_hybrid_and_moe_trainers_on_the_card_match_the_cpu(card, arch,
                                                              tmp_path):
    """Reduced mamba2, zamba2 and granite, fp32, 3 steps from the same
    weights: the card (the SSD forward and backward kernels once per mamba
    layer a step, the flash kernels once per attention layer) and the CPU
    (the plain versions) agree, losses atol 1e-4."""
    cfg = get_config(arch).reduced()
    kinds = cfg.layer_kinds()
    n_mamba = sum(k == "mamba" for k in kinds)
    n_attn = len(kinds) - n_mamba
    shape = ShapeConfig("t", "train", 96, 2)
    runs = {}
    for dev in ("cpu", card):
        before = (ssd_k.FMA_LAUNCHES, ssd_k.BWD_LAUNCHES, fab.DQ_LAUNCHES)
        t = Trainer(cfg, shape, TrainConfig(
            steps=3, log_every=1, ckpt_every=0, seed=4,
            ckpt_dir=str(tmp_path / str(dev))), device=dev)
        t.run()
        if dev == card:
            assert (ssd_k.FMA_LAUNCHES - before[0],
                    ssd_k.BWD_LAUNCHES - before[1],
                    fab.DQ_LAUNCHES - before[2]) == (3 * n_mamba,
                                                     3 * n_mamba,
                                                     3 * n_attn)
        runs[str(dev)] = [m["loss"] for m in t.metrics_log]
    np.testing.assert_allclose(runs["cuda"], runs["cpu"], atol=1e-4)


# =================================================================== SSD ===
SSD_CASES = [                      # b, s, h, p, g, n, chunk
    (2, 128, 4, 64, 1, 32, 32),    # tests/test_kernels.py SSD_CASES
    (1, 200, 8, 64, 2, 64, 64),
    (2, 256, 4, 32, 4, 16, 128),
    (2, 77, 8, 32, 1, 16, 32),     # the reduced model's shape, ragged
    (1, 1000, 64, 64, 1, 128, 256),  # the main path's, ragged
]
SSD_IDS = [f"ssd{i}" for i in range(len(SSD_CASES))]


def _ssd_inputs(case, seed, dtype, card):
    b, s, h, p, g, n, _ = case
    rs = np.random.RandomState(seed)
    f = lambda a: torch.tensor(a.astype(np.float32)).to(card)  # noqa: E731
    x = f(rs.randn(b, s, h, p)).to(dtype)
    dt = f(np.logaddexp(rs.randn(b, s, h), 0.0))
    A = f(-np.exp(rs.randn(h) * 0.5))
    Bm = f(rs.randn(b, s, g, n) * 0.3).to(dtype)
    C = f(rs.randn(b, s, g, n) * 0.3).to(dtype)
    init = f(rs.randn(b, h, p, n))
    return x, dt, A, Bm, C, init


def _ssd_close(got, want, dtype):
    (y, st), (wy, wst) = got, want
    torch.testing.assert_close(st, wst, atol=5e-4, rtol=2.0 ** -12)
    rtol = 2.0 ** -8 if dtype == "bfloat16" else 2.0 ** -12
    torch.testing.assert_close(y.float(), wy.float(), atol=5e-4, rtol=rtol)


@pytest.mark.parametrize("with_init", [False, True], ids=["zeros", "init"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES, ids=SSD_IDS)
def test_ssd_kernel_matches_plain_version(card, case, dtype, with_init):
    x, dt, A, Bm, C, init = _ssd_inputs(case, 4, getattr(torch, dtype), card)
    init = init if with_init else None
    counts = lambda: (ssd_k.LAUNCHES, ssd_k.TC_LAUNCHES,  # noqa: E731
                      ssd_k.FMA_LAUNCHES)
    before = counts()
    got = ssd_ops.ssd(x, dt, A, Bm, C, chunk=case[-1], init_state=init)
    tc = dtype == "bfloat16"            # the dtype picks the kernels
    assert counts() == (before[0] + 1, before[1] + tc, before[2] + (not tc))
    want = ssd_chunked(x.float(), dt, A, Bm.float(), C.float(),
                       chunk=case[-1], init_state=init)
    torch.cuda.synchronize()
    assert got[0].dtype == x.dtype and got[1].dtype == torch.float32
    _ssd_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_kernel_reads_the_model_layout_through_strides(card, dtype):
    """x, B and C as views split out of one (B, S, H*P + 2*G*N) tensor, dt
    as a transposed view: no copy, the same result."""
    b, s, h, p, g, n, chunk = SSD_CASES[3]
    rs = np.random.RandomState(5)
    xbc = torch.tensor(rs.randn(b, s, h * p + 2 * g * n).astype(np.float32),
                       device=card).to(getattr(torch, dtype))
    xp, Bp, Cp = torch.split(xbc, [h * p, g * n, g * n], dim=-1)
    x, Bm, C = (xp.reshape(b, s, h, p), Bp.reshape(b, s, g, n),
                Cp.reshape(b, s, g, n))
    dt = torch.tensor(np.logaddexp(rs.randn(b, h, s), 0.0).astype(
        np.float32), device=card).transpose(1, 2)
    A = -torch.rand(h, device=card) - 0.1
    assert all(fa.readable(t) is t for t in (x, Bm, C))
    got = ssd_k.ssd_scan(x, dt, A, Bm, C, chunk=chunk)
    want = ssd_chunked(*(t.contiguous().float() for t in (x, dt, A, Bm, C)),
                       chunk=chunk)
    torch.cuda.synchronize()
    _ssd_close(got, want, dtype)


def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(card):
    x, dt, A, Bm, C, init = _ssd_inputs(SSD_CASES[0], 1, torch.float32,
                                        card)
    before = ssd_k.LAUNCHES
    with pytest.raises(ValueError, match="not built"):
        ssd_k.ssd_scan(x, dt, A, Bm, C, chunk=48)
    with pytest.raises(ValueError, match="not built"):
        ssd_k.ssd_scan(x[..., :48], dt, A, Bm, C, chunk=32)
    with pytest.raises(TypeError):
        ssd_k.ssd_scan(x.half(), dt, A, Bm.half(), C.half(), chunk=32)
    with pytest.raises(TypeError):
        ssd_k.ssd_scan(x, dt.bfloat16(), A, Bm, C, chunk=32)
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_k.ssd_scan(x, dt, A.cpu(), Bm, C, chunk=32)
    with pytest.raises(ValueError, match="init_state"):
        ssd_k.ssd_scan(x, dt, A, Bm, C, chunk=32, init_state=init[:1])
    with pytest.raises(ValueError, match="dy must match"):
        ssd_k.ssd_scan_bwd(x, dt, A, Bm, C, x[:, :-1], chunk=32)
    with pytest.raises(ValueError, match="dfinal_state"):
        ssd_k.ssd_scan_bwd(x, dt, A, Bm, C, x, chunk=32,
                           dfinal_state=init[:1])
    with pytest.raises(ValueError, match="not built"):
        ssd_k.ssd_scan_bwd(x, dt, A, Bm, C, x, chunk=48)
    assert ssd_k.LAUNCHES == before


def _bwd_counts():
    return (ssd_k.BWD_LAUNCHES, ssd_k.BWD_TC_LAUNCHES, ssd_k.BWD_FMA_LAUNCHES)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_gradient_launches_the_backward_kernel_once(card, dtype):
    """A CUDA input that needs a gradient: one forward launch, one
    backward launch on its dtype's path (float32: the FMA kernel; bf16:
    the tensor-core kernels), and the plain backward's gradients."""
    dtype = getattr(torch, dtype)
    x, dt, A, Bm, C, init = _ssd_inputs(SSD_CASES[3], 2, dtype, card)
    ins = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, C, init)]
    before = ssd_k.LAUNCHES, _bwd_counts()
    y, st = ssd_ops.ssd(*ins[:5], chunk=32, init_state=ins[5])
    w = torch.randn_like(y), torch.randn_like(st)
    got = torch.autograd.grad((y.float() * w[0].float()).sum()
                              + (st * w[1]).sum(), ins)
    tc = dtype == torch.bfloat16
    n, ntc, nfma = before[1]
    assert (ssd_k.LAUNCHES, _bwd_counts()) == (
        before[0] + 1, (n + 1, ntc + tc, nfma + (not tc)))
    want = ssd_chunked_bwd(x.float(), dt, A, Bm.float(), C.float(),
                           w[0].float(), chunk=32, init_state=init,
                           dfinal_state=w[1])
    torch.cuda.synchronize()
    _bwd_close(got, want, dtype)


def _bwd_close(got, want, dtype):
    """dx and dinit as the forward's y and state: atol 5e-4 plus rtol
    2^-12 (bf16 dx: 2^-8, one rounding of the float32 sum).  ddt, dA, dB
    and dC are sums whose terms cancel (through dcum's suffix sums, over
    batch and positions, over a group's heads): float32 in another order
    moves them by a share of the terms' size, so they are held normwise,
    atol 5e-4 plus 2^-12 of the tensor's largest |value| (bf16 dB and dC
    also 2^-8 of each element)."""
    bf16 = dtype == torch.bfloat16
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = a.float(), b.float()
        if i in (0, 5):
            torch.testing.assert_close(
                a, b, atol=5e-4, rtol=2.0 ** -8 if bf16 and i == 0
                else 2.0 ** -12)
        else:
            lim = (5e-4 + 2.0 ** -12 * b.abs().max()
                   + (2.0 ** -8 * b.abs() if bf16 and i in (3, 4) else 0.0))
            assert bool(((a - b).abs() <= lim).all()), (i, (a - b).abs().max())


@pytest.mark.parametrize("with_init", [False, True],
                         ids=["zeros", "init_dfinal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES, ids=SSD_IDS)
def test_ssd_bwd_kernel_matches_plain_version(card, case, dtype, with_init):
    dtype = getattr(torch, dtype)
    x, dt, A, Bm, C, init = _ssd_inputs(case, 8, dtype, card)
    rs = np.random.RandomState(9)
    dy = torch.tensor(rs.randn(*x.shape).astype(np.float32),
                      device=card).to(dtype)
    dfin = (torch.tensor(rs.randn(*init.shape).astype(np.float32),
                         device=card) if with_init else None)
    init = init if with_init else None
    n, ntc, nfma = _bwd_counts()
    tc = dtype == torch.bfloat16
    got = ssd_k.ssd_scan_bwd(x, dt, A, Bm, C, dy, chunk=case[-1],
                             init_state=init, dfinal_state=dfin)
    assert _bwd_counts() == (n + 1, ntc + tc, nfma + (not tc))
    want = ssd_chunked_bwd(x.float(), dt, A, Bm.float(), C.float(),
                           dy.float(), chunk=case[-1], init_state=init,
                           dfinal_state=dfin)
    torch.cuda.synchronize()
    assert [t.dtype for t in got] == [dtype, torch.float32, torch.float32,
                                      dtype, dtype, torch.float32]
    _bwd_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_bwd_kernel_reads_the_model_layout_through_strides(card, dtype):
    """x, B and C as views of one tensor and dt transposed, as
    ``mamba_apply`` hands them over: the same gradients as contiguous
    copies."""
    b, s, h, p, g, n, chunk = SSD_CASES[3]
    rs = np.random.RandomState(5)
    dtype = getattr(torch, dtype)
    xbc = torch.tensor(rs.randn(b, s, h * p + 2 * g * n).astype(np.float32),
                       device=card).to(dtype)
    xp, Bp, Cp = torch.split(xbc, [h * p, g * n, g * n], dim=-1)
    x, Bm, C = (xp.reshape(b, s, h, p), Bp.reshape(b, s, g, n),
                Cp.reshape(b, s, g, n))
    dt = torch.tensor(np.logaddexp(rs.randn(b, h, s), 0.0).astype(
        np.float32), device=card).transpose(1, 2)
    A = -torch.rand(h, device=card) - 0.1
    dy = torch.randn(b, s, h, p, device=card).to(dtype)
    n, ntc, nfma = _bwd_counts()
    got = ssd_k.ssd_scan_bwd(x, dt, A, Bm, C, dy, chunk=chunk)
    want = ssd_k.ssd_scan_bwd(*(t.contiguous() for t in (x, dt, A, Bm, C,
                                                         dy)), chunk=chunk)
    tc = dtype == torch.bfloat16
    assert _bwd_counts() == (n + 2, ntc + 2 * tc, nfma + 2 * (not tc))
    torch.cuda.synchronize()
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSD_CASES, ids=SSD_IDS)
def test_ssd_bwd_kernel_gives_the_same_bits_every_run(card, case, dtype):
    """No float atomics: per-head partials of dB and dC and per-chunk
    parts of dA, summed in a fixed order, so two calls on the same inputs
    return identical tensors."""
    dtype = getattr(torch, dtype)
    x, dt, A, Bm, C, init = _ssd_inputs(case, 10, dtype, card)
    gen = torch.Generator(device=card).manual_seed(3)
    dy = torch.randn(x.shape, device=card, generator=gen).to(dtype)
    dfin = torch.randn_like(init)
    runs = [ssd_k.ssd_scan_bwd(x, dt, A, Bm, C, dy, chunk=case[-1],
                               init_state=init, dfinal_state=dfin)
            for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_mamba_serving_on_the_card_matches_the_cpu(card):
    """Reduced mamba2, fp32: prefill and 8 teacher-forced decode steps on
    the card (the SSD kernel, once per layer per prefill) and on the CPU
    (the plain scan) agree: logits and caches atol 1e-4, tokens equal."""
    cfg = get_config("mamba2-1.3b").reduced()
    params = _params(cfg, "cpu")
    toks = torch.tensor(np.random.RandomState(6).randint(
        0, cfg.vocab_size, size=(3, 45)))
    runs = {}
    for dev in ("cpu", card):
        p = T.ssm.cast(params, dev, torch.float32)
        before = ssd_k.LAUNCHES
        logits, cache = T.prefill(p, cfg, toks[:, :37].to(dev), 45,
                                  cache_dtype=torch.float32)
        out = [logits.cpu()]
        for t in range(37, 45):
            logits, cache = T.decode_step(p, cfg, cache,
                                          toks[:, t:t + 1].to(dev),
                                          torch.full((3,), t, device=dev))
            out.append(logits.cpu())
        if dev == card:
            assert ssd_k.LAUNCHES - before == cfg.n_layers
        runs[str(dev)] = (out, {k: v.cpu() for k, v in
                                cache["mamba"].items()})
    for a, g in zip(runs["cpu"][0], runs["cuda"][0]):
        torch.testing.assert_close(g, a, atol=1e-4, rtol=0)
        assert torch.equal(g[:, :cfg.vocab_size].argmax(-1),
                           a[:, :cfg.vocab_size].argmax(-1))
    for k in ("conv", "ssm"):
        torch.testing.assert_close(runs["cuda"][1][k], runs["cpu"][1][k],
                                   atol=1e-4, rtol=0)


# ------------------------------------------------------- the shell, on card
@pytest.mark.parametrize("path", ["word_granular", "chunked", "whole"])
def test_transfer_engine_round_trip_on_the_card(card, path):
    """Each upload path of the static layer's transfer engine puts the
    bytes on the card unchanged (the chunked path through its pinned
    ring, with a ragged last chunk), and a download gives them back."""
    from repro_torch.core.static_layer import TransferEngine
    eng = TransferEngine(card)
    data = np.random.RandomState(0).randint(
        0, 256, size=(3 << 20) + 4099).astype(np.uint8)
    if path == "word_granular":
        out, st = eng.upload_word_granular(data[:1 << 20])
        data = data[:1 << 20]
    elif path == "chunked":
        out, st = eng.upload(data, chunk_bytes=1 << 20)
        assert st.chunks == 4
    else:
        out, st = eng.upload_whole(data)
    assert out.device.type == "cuda" and st.nbytes == data.nbytes
    back, _ = eng.download(out)
    assert np.array_equal(back.reshape(-1), data)
    rows = data[:(3 << 20)].view(np.float32).reshape(-1, 256)
    got = torch.cat(list(eng.stream_rows(rows, 100))).cpu().numpy()
    assert np.array_equal(got.view(np.uint8), rows.view(np.uint8))


def test_aes_on_the_card_matches_the_cpu(card):
    from repro_torch.core.services import encryption as E
    rs = np.random.RandomState(1)
    rk = torch.from_numpy(E.expand_key(
        rs.randint(0, 256, 16).astype(np.uint8)))
    blocks = torch.from_numpy(rs.randint(0, 256, (4096, 16)).astype(
        np.uint8))
    ivs = torch.from_numpy(rs.randint(0, 256, (8, 16)).astype(np.uint8))
    ecb = E.aes_ecb(blocks.to(card), rk.to(card)).cpu()
    assert torch.equal(ecb, E.aes_ecb(blocks, rk))
    ms = blocks[:8 * 32].reshape(8, 32, 16)
    cbc = E.aes_cbc_multistream(ms.to(card), ivs.to(card), rk.to(card))
    assert torch.equal(cbc.cpu(), E.aes_cbc_multistream(ms, ivs, rk))


def test_hll_on_the_card_matches_the_cpu(card):
    from repro_torch.apps import hll as H
    items = torch.from_numpy(np.random.RandomState(2).randint(
        -2 ** 31, 2 ** 31 - 1, size=1 << 20).astype(np.int32))
    regs = H.hll_sketch(items.to(card))
    assert torch.equal(regs.cpu(), H.hll_sketch(items))
    assert float(H.hll_estimate(regs)) == pytest.approx(
        float(H.hll_estimate(regs.cpu())), rel=1e-6)


# -------------------------------------------------- migration and recovery
def _migrate_and_recover(cfg, device):
    """Reduced smollm fp32 on two shells of ``device``: four requests
    (one sampled) moved by ``migrate`` after 3 steps, the destination's
    slot recovered in place after 3 more, then decoded to the end."""
    from repro_torch.core import Shell, ShellConfig, migrate
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         dtype=torch.float32, device=device)
    shells, engines = [], []
    for base in (0, 100):
        sh = Shell(ShellConfig.make(services={"mmu": MMUConfig(
            page_size=16, n_pages=64)}, n_vfpgas=1), device=device)
        sh.build()
        shells.append(sh)
        engines.append(ServingEngine(
            cfg, params, sh.services.get("mmu"), max_batch=4, max_len=96,
            shell=sh, slot=0, tenant="gold", rid_base=base, device=device))
    for i, n in enumerate((5, 37, 16, 60)):
        engines[0].submit(list(range(3, 3 + n)), max_new_tokens=12,
                          temperature=0.9 if i == 2 else 0.0)
    for _ in range(3):
        engines[0].step()
    assert migrate(shells[0], shells[1], "gold").n_requests == 4
    for _ in range(3):
        engines[1].step()
    assert shells[1].recover_slot(0).n_requests == 4
    while engines[1].pending():
        engines[1].step()
    for sh in shells:
        sh.close()
    return {r.rid: r.out_tokens for r in engines[1].completed}


def test_migrate_and_recover_slot_on_the_card_match_the_cpu(card):
    """The same moves on the card (every decode on the paged kernel) and
    on the CPU give the same streams, sampled row included."""
    cfg = get_config("smollm-135m").reduced()
    before = pa.LAUNCHES
    got = _migrate_and_recover(cfg, "cuda")
    assert pa.LAUNCHES > before
    assert got == _migrate_and_recover(cfg, "cpu")


# ------------------------------------------------ MoE and hybrid, on card
def test_moe_apply_on_the_card_matches_the_cpu(card):
    """One granite-width MoE layer (d_model 1024, 32 experts, top-8), fp32,
    on 512 tokens: the routing's expert sets equal the CPU's but for
    near-ties at the k-th place; given the card's routing, dispatch, the
    expert products and the combine on the card give the CPU's output
    within atol 1e-4; the aux loss within 1e-6."""
    from repro_torch.models import moe
    cfg = get_config("granite-moe-1b-a400m")
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.tensor(np.random.RandomState(1).randn(4, 128, 1024)
                     .astype(np.float32))
    k, n_e = cfg.moe.top_k, cfg.moe.n_experts
    outs = {}
    for name, dev in (("cpu", "cpu"), ("card", card)):
        pd = {n: v.to(dev) for n, v in p.items()}
        outs[name] = moe.route(pd, cfg, x.reshape(-1, 1024).to(dev))
    (_, ci, ca), (gg, gi, ga) = outs["cpu"], outs["card"]
    probs = torch.softmax(x.reshape(-1, 1024) @ p["router"], -1)
    top = probs.topk(k + 1, dim=-1).values
    near = (top[:, k - 1] - top[:, k]).abs() <= 1e-5
    same = (ci.sort(-1).values == gi.cpu().sort(-1).values).all(-1)
    assert bool((same | near).all())
    assert abs(float(ca) - float(ga)) <= 1e-6
    cap = moe._capacity(512, k, n_e, cfg.moe.capacity_factor)
    res = {}
    for name, dev in (("cpu", "cpu"), ("card", card)):
        pd = {n: v.to(dev) for n, v in p.items()}
        buf, dest, g = moe.dispatch(x.reshape(1, 512, 1024).to(dev),
                                    gg.reshape(1, 512, k).to(dev),
                                    gi.reshape(1, 512, k).to(dev), n_e, cap)
        eout = moe.experts(pd, buf[:, :-1].reshape(1, n_e, cap, 1024))
        res[name] = (dest.cpu(), moe.combine(eout, dest, g).cpu())
    assert torch.equal(res["cpu"][0], res["card"][0])
    torch.testing.assert_close(res["card"][1], res["cpu"][1], atol=1e-4,
                               rtol=0)


def test_granite_engine_on_the_card_matches_the_cpu(card):
    """Reduced granite-moe-1b-a400m, fp32, through the engine: greedy
    streams equal on the card (paged kernel) and on the CPU."""
    cfg = get_config("granite-moe-1b-a400m").reduced()
    modes = [{}] * 5
    before = pa.LAUNCHES
    got = _serve(cfg, card, modes)
    assert pa.LAUNCHES > before
    assert got == _serve(cfg, "cpu", modes)


def test_zamba2_prefill_on_the_card_launches_and_matches_the_cpu(card):
    """Reduced zamba2, fp32: one prefill runs the SSD kernel once per
    mamba slot and cycle (10) and the flash forward once per cycle (2);
    decode launches neither; logits and caches of the prefill and 6
    teacher-forced decode steps equal the CPU's within atol 1e-4."""
    cfg = get_config("zamba2-2.7b").reduced()
    params = _params(cfg, "cpu")
    toks = torch.tensor(np.random.RandomState(7).randint(
        0, cfg.vocab_size, size=(2, 46)))
    runs = {}
    for name, dev in (("cpu", "cpu"), ("card", card)):
        p = T.ssm.cast(params, dev, torch.float32)
        s0, f0 = ssd_k.LAUNCHES, fa.LAUNCHES
        logits, cache = T.prefill(p, cfg, toks[:, :40].to(dev), 46,
                                  cache_dtype=torch.float32)
        if name == "card":
            assert (ssd_k.LAUNCHES - s0, fa.LAUNCHES - f0) == (10, 2)
        out = [logits.cpu()]
        s0, f0 = ssd_k.LAUNCHES, fa.LAUNCHES
        for t in range(40, 46):
            logits, cache = T.decode_step(p, cfg, cache,
                                          toks[:, t:t + 1].to(dev),
                                          torch.full((2,), t, device=dev))
            out.append(logits.cpu())
        assert (ssd_k.LAUNCHES - s0, fa.LAUNCHES - f0) == (0, 0)
        runs[name] = (out, cache)
    for a, g in zip(runs["cpu"][0], runs["card"][0]):
        torch.testing.assert_close(g, a, atol=1e-4, rtol=0)
        assert torch.equal(g[:, :cfg.vocab_size].argmax(-1),
                           a[:, :cfg.vocab_size].argmax(-1))
    (_, cc), (_, gc) = runs["cpu"], runs["card"]
    for got, want in ((gc["k"], cc["k"]), (gc["v"], cc["v"]),
                      (gc["mamba"]["conv"], cc["mamba"]["conv"]),
                      (gc["mamba"]["ssm"], cc["mamba"]["ssm"])):
        torch.testing.assert_close(got.cpu(), want, atol=1e-4, rtol=0)


def _device_events(prof):
    """(name, start ns, end ns) of the trace's device events after its pad
    of spin kernels, in start order."""
    ev = sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                 for e in prof.profiler.kineto_results.events()
                 if str(e.device_type()).endswith("CUDA")),
                key=lambda x: x[1])
    pads = [i for i, x in enumerate(ev) if "spin_kernel" in x[0]]
    assert pads, "the trace dropped its whole pad"
    return ev[pads[-1] + 1:]


def test_engine_spans_share_the_profilers_clock_on_the_card(card):
    """Under a CUDA profiler the engine records its spans on the profiler's
    clock: every decode step's device-to-host copy of its tokens lies
    inside that step's read-back ``engine.wait`` span, to 50 us, and no
    span is drawn on the device's timeline."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.telemetry import spans
    cfg = get_config("smollm-135m").reduced()
    eng = ServingEngine(cfg, _params(cfg, card),
                        MMU(MMUConfig(page_size=8, n_pages=128)),
                        max_batch=3, max_len=96, prefill_chunk=16,
                        device=card)
    rs = np.random.RandomState(2)
    for _ in range(3):
        eng.submit(rs.randint(0, cfg.vocab_size, 30).tolist(),
                   max_new_tokens=12)
    while not eng.decode_step_times:         # builds the decode kernel
        eng.step()
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(4000):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        while eng.pending():
            eng.step()
        torch.cuda.synchronize()
    recs = spans.snapshot()
    dev = _device_events(prof)
    assert not [n for n, _, _ in dev if n.startswith("engine.")]
    copies = [(s, e) for n, s, e in dev if "Memcpy DtoH" in n]
    decodes = [r for r in recs if r.name == "engine.decode"]
    assert len(decodes) >= 5
    slack = 50_000
    for d in decodes:
        (wait,) = [r for r in recs if r.parent == d.id
                   and r.name == "engine.wait"]
        mine = [(s, e) for s, e in copies
                if d.start_ns <= s <= d.end_ns + slack]
        assert len(mine) == 1, (d, mine)
        s, e = mine[0]
        assert wait.start_ns - slack <= s and e <= wait.end_ns + slack


def test_device_spans_time_the_card(card, tmp_path):
    """A span given the card records CUDA events, read once they have
    completed; the Trainer's three phases carry them."""
    from repro_torch.telemetry import spans
    spans.reset()
    a = torch.randn(1024, 1024, device=card)
    with spans.enable():
        with spans.span("mm", device=card):
            for _ in range(20):
                a = a @ a / 32
        torch.cuda.synchronize()
        (r,) = spans.snapshot()
        assert r.device_ms is not None and 0 < r.device_ms < 1000
        spans.reset()
        cfg = get_config("smollm-135m").reduced()
        Trainer(cfg, ShapeConfig("t", "train", 64, 2), TrainConfig(
            steps=2, log_every=1, ckpt_every=0, ckpt_dir=str(tmp_path)),
            device=card).run()
    torch.cuda.synchronize()
    recs = spans.snapshot()
    spans.reset()
    for phase in ("train.forward", "train.backward", "train.optimizer"):
        got = [r.device_ms for r in recs if r.name == phase]
        assert len(got) == 2 and all(x is not None and x > 0 for x in got)


GRANITE_FA = (1, 32, 8, 1024, 1024, 128, True, 0)   # granite-4.0-h-small


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernels_at_granites_softmax_scale(card, dtype):
    """The forward, dq and dkv kernels at granite-4.0-h-small's softmax
    scale (``attention_multiplier`` 1/128, not 1/sqrt(128)), D 128, 32 / 8
    heads, causal, against the plain versions at that scale, with the
    tolerances of the tests above; the default scale gives another
    output."""
    scale = 0.0078125
    q, k, v, do = _fa_inputs(GRANITE_FA, 6, getattr(torch, dtype), card, n=4)
    o, lse = fa.flash_attention(q, k, v, causal=True, sm_scale=scale,
                                return_lse=True)
    want_o, want_lse = attention_ref(q.float(), k.float(), v.float(),
                                     causal=True, sm_scale=scale)
    torch.testing.assert_close(o.float(), want_o, atol=ATOL[dtype], rtol=0)
    torch.testing.assert_close(lse, want_lse, atol=ATOL[dtype], rtol=0)
    assert float((fa.flash_attention(q, k, v, causal=True).float()
                  - want_o).abs().max()) > 10 * ATOL[dtype]
    dq, dk, dv = fab.flash_attention_bwd(q, k, v, o, do, lse, causal=True,
                                         sm_scale=scale)
    f32 = [t.float() for t in (q, k, v, o, do)]
    kw = dict(causal=True, sm_scale=scale)
    want = attention_bwd_ref(*f32, lse, **kw)
    bounds = ((None, None, None) if dtype == "float32" else
              (bf16_dq_bound(*f32, lse, **kw), *bf16_dkv_bound(*f32, lse,
                                                                **kw)))
    del f32
    torch.cuda.synchronize()
    for got, ref, bound in zip((dq, dk, dv), want, bounds):
        _close_grad(got, ref, dtype, bound)


@pytest.mark.parametrize("kind", ["mamba_ffn", "attn"])
def test_granite_layer_at_full_width_matches_the_reference(card, kind):
    """One granite-4.0-h-small layer of each kind at its published widths
    (d 4096; Mamba-2 128 heads of 64, d_state 128; attention 32 / 8 heads
    of 128 at scale 1/128; 9 of 72 experts held, top-10, shared expert
    1536) in float32 on the card, through the flash or SSD kernel and the
    dropless expert layer, against the plain reference's block (float32,
    TF32 off) on 2 x 512 tokens: the output within 1e-4 of the
    reference's norm (float32 sums in other orders, the scan's and the
    flash kernel's own), the Switch loss within 1e-5."""
    from perfbench import harness, weights_granite4h
    from perfbench.reference.dense import no_tf32
    from perfbench.reference.mamba2 import flatten
    ref = harness.reference_module("granite4h")
    config = dict(harness.load_config("granite-4.0-h-small"), n_layers=1,
                  block_pattern=[kind], dtype="float32")
    cfg = harness.model_config(config)
    params = weights_granite4h.make(config, 3, torch.float32, card)
    key, keys = ref.STACKS[kind]
    x = torch.randn(2, 512, 4096, device=card,
                    generator=torch.Generator(card).manual_seed(4))
    with no_tf32():
        got, aux = T._mixer_ffn_fwd(T._unstack(params[key], 1)[0], cfg, x,
                                    kind, False)
        flat = flatten(params)
        leaves = [flat[f"{key}/{k}"][0] for k in
                  ("norm1/scale", "norm2/scale") + keys + ref.FFN_KEYS]
        want, want_aux = ref.block(config, False, kind, x, *leaves)
    err = float((got - want).norm() / want.norm())
    assert err < 1e-4, err
    assert abs(float(aux) - float(want_aux)) < 1e-5


def test_dropless_grouped_products_match_the_loop_on_the_card(card):
    """The held experts' grouped GEMMs (``torch._grouped_mm``, bf16) against
    one product per expert, at granite-4.0-h-small's widths (9 experts of
    4096 x 768), on 4096 tokens with uneven loads and a held expert that no
    pair chose: output and gradients of the input and of every expert's
    weights within 2^-8 of the loop's norm (the two sum each product in
    float32 in other orders; both round the same bf16 operands)."""
    from repro_torch.models import moe
    g = torch.Generator(card).manual_seed(11)
    d, f, n_held = 4096, 768, 9
    w = {k: (torch.randn(n_held, a, b, device=card, generator=g)
             / a ** 0.5).requires_grad_(True)
         for k, (a, b) in (("w_gate", (d, f)), ("w_up", (d, f)),
                           ("w_down", (f, d)))}
    local = torch.randint(-3, 12, (4096, 10), device=card, generator=g)
    local[local == 4] = 5                   # expert 4 holds no pair
    gates = torch.rand(4096, 10, device=card, generator=g)
    x = torch.randn(4096, d, device=card, generator=g).bfloat16()
    x.requires_grad_(True)
    res = {}
    for group in (True, False):
        out, sizes, _ = moe.dropless(w, x, gates, local, n_held, group=group)
        grads = torch.autograd.grad(out.float().square().sum(),
                                    [x, *w.values()])
        res[group] = (out, *grads)
    assert sizes[4] == 0 and min(sizes[:4] + sizes[5:]) > 0
    for a, b in zip(res[True], res[False]):
        err = float((a.float() - b.float()).norm() / b.float().norm())
        assert err < 2 ** -8, err
