"""Tests of the port that need the CUDA card (the kernels have no CPU mode).

They skip without a card.  On the machine with the H100, which has no
JAX, run them without the JAX-importing ``conftest.py``:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

This file imports nothing of JAX or of the JAX package.  Tolerances: the
kernel against its plain version in float32 at atol 2e-5 (the JAX
package's kernel tolerance), in bf16 at atol 2e-2 against the plain
version run in float32 on the same bf16 inputs.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.services.mmu import MMU, MMUConfig
from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention import paged_attention as pa
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.models.transformer import init_params
from repro_torch.serve import paged_model as P
from repro_torch.serve.engine import ServingEngine

pytestmark = pytest.mark.cuda

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
CASES = [                                 # b, h, kh, d, page, maxp, npages
    (2, 8, 2, 64, 128, 4, 16),            # tests/test_kernels.py PA_CASES
    (3, 4, 4, 128, 64, 6, 32),
    (1, 16, 8, 64, 256, 3, 8),
    (4, 6, 2, 32, 5, 9, 40),              # D=32, odd page, G=3
    (192, 9, 3, 64, 16, 8, 2048),         # fills the card: one pass
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(case, seed, dtype, card):
    b, h, kh, d, page, maxp, npages = case
    rs = np.random.RandomState(seed)
    lens = np.minimum(rs.randint(0, page * maxp + 1, size=b), page * maxp)
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
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention(q[..., :48].contiguous(),
                           kp[..., :48].contiguous(),
                           vp[..., :48].contiguous(), tables, lens)
    with pytest.raises(ValueError, match="CUDA device"):
        pa.paged_attention(q, kp, vp, tables.cpu(), lens)
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
