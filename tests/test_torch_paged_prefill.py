"""The plain version of paged prefill attention, on the CPU.

``ref.paged_prefill_ref`` is the attention that ``serve/paged_model.py::
_prefill_layers`` computed inline before it called ``ops.paged_prefill``.
``tests/test_torch_paged_model.py`` holds it to the JAX reference through
both prefill entry points (later chunks, ragged and padded rows, unmapped
pages, GQA 4:1 and 3:1, D 120 and 64).  Here: its exact zeros, the CPU
dispatch, and the wrapper's refusals.  The CUDA kernel itself runs only on
the card: ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.paged_attention import ops
from repro_torch.kernels.paged_attention import paged_prefill as pp
from repro_torch.kernels.paged_attention.ref import paged_prefill_ref

torch.set_num_threads(1)


# name: (t, h, kh, d, page, maxp, q_starts, q_lens, unmapped (row, page))
CASES = {
    # a later chunk of two rows, GQA 4:1 at danube's D 120
    "later_chunk": (16, 8, 2, 120, 8, 10, [24, 40], [16, 16], []),
    # padded queries (t >= q_len) attend every visible key
    "padded_queries": (16, 9, 3, 64, 8, 6, [8, 0], [3, 9], []),
    # an unmapped page inside the causal range, a row whose first page is
    # unmapped, so its first queries see no key at all, and a padding row
    "unmapped_page": (16, 8, 2, 64, 4, 12, [20, 4, 0], [12, 12, 0],
                      [(0, 2), (1, 0)]),
}


def _case(spec, seed, n_pages=40):
    t, h, kh, d, page, maxp, q_starts, q_lens, unmapped = spec
    n = len(q_starts)
    rs = np.random.RandomState(seed)
    q = torch.tensor(rs.randn(n, t, h, d).astype(np.float32))
    pools = [torch.tensor(rs.randn(n_pages, page, kh, d).astype(np.float32))
             for _ in range(2)]
    tables = np.full((n, maxp), -1, np.int32)
    for i in range(n):
        if q_lens[i]:
            # pages for the row's whole prompt, past this chunk's keys too
            need = min(maxp, -(-(q_starts[i] + q_lens[i] + page) // page))
            tables[i, :need] = rs.permutation(n_pages)[:need]
    for i, p in unmapped:
        tables[i, p] = -1
    return (q, *pools, torch.tensor(tables),
            torch.tensor(q_starts, dtype=torch.int32),
            torch.tensor(q_lens, dtype=torch.int32))


def test_plain_version_is_exactly_zero_where_no_key_is_visible():
    q, kp, vp, tables, q_starts, q_lens = _case(CASES["unmapped_page"], 3)
    got = paged_prefill_ref(q, kp, vp, tables, q_starts, q_lens)
    page = kp.shape[1]
    kv = q_starts + q_lens
    for i in range(q.shape[0]):
        first = next((j for j in range(int(kv[i]))
                      if tables[i, j // page] >= 0), None)
        for t in range(q.shape[1]):
            blind = first is None or first > int(q_starts[i]) + t
            assert bool((got[i, t] == 0).all()) == blind, (i, t)


def test_paged_prefill_on_cpu_takes_the_plain_version():
    q, *kv, tables, q_starts, q_lens = _case(CASES["padded_queries"], 5)
    before = pp.LAUNCHES
    got = ops.paged_prefill(q, *kv, tables, q_starts, q_lens)
    assert pp.LAUNCHES == before
    torch.testing.assert_close(
        got, paged_prefill_ref(q, *kv, tables, q_starts, q_lens),
        atol=0, rtol=0)


def test_prefill_wrapper_refuses_cpu_tensors_instead_of_falling_back():
    args = _case(CASES["later_chunk"], 1)
    before = pp.LAUNCHES
    with pytest.raises(ValueError, match="CUDA device"):
        pp.paged_prefill(*args)
    assert pp.LAUNCHES == before


def test_paged_prefill_raises_for_other_devices():
    q = torch.zeros(1, 2, 2, 32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        ops.paged_prefill(q, q, q, q, q, q)
