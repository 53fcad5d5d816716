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
