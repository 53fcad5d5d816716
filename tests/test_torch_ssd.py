"""Port SSD scan against the JAX reference, on the CPU.

The same numpy inputs go through the port's plain versions
(``kernels/ssd/ref.py``: ``ssd_sequential``, ``ssd_chunked`` with and
without an initial state; ``ops.ssd``, which takes ``ssd_chunked`` for a
CPU tensor) and through the reference's ``ssd_sequential``,
``models.ssm.ssd_chunked`` and the Pallas kernel ``ssd_chunked_pallas``
in interpret mode, on ``SSD_CASES`` of ``tests/test_kernels.py`` (grouped
B/C with G 1, 2 and 4, a ragged S, chunks 32 to 128).  Then the
chunk-invariance property and the decode continuation, as the reference's
kernel tests state them, on the port.

Tolerance: atol 5e-4 on y and the state, the reference's kernel tests'
own: the chunked and sequential forms sum the same float32 terms in other
orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # offline env: deterministic shim
    from _hypothesis_fallback import given, settings, strategies as st

from repro.kernels.ssd.ref import ssd_sequential as jssd_sequential
from repro.kernels.ssd.ssd import ssd_chunked_pallas
from repro.models.ssm import ssd_chunked as jssd_chunked
from repro_torch.kernels.ssd import ops
from repro_torch.kernels.ssd.ref import ssd_chunked, ssd_sequential
from repro_torch.kernels.ssd.ssd import ssd_scan
from repro_torch.models.ssm import ssd_decode

torch.set_num_threads(1)

ATOL = 5e-4
SSD_CASES = [                       # b, s, h, p, g, n, chunk
    (2, 128, 4, 64, 1, 32, 32),
    (1, 200, 8, 64, 2, 64, 64),     # padded seq
    (2, 256, 4, 32, 4, 16, 128),
]
IDS = [f"ssd{i}" for i in range(len(SSD_CASES))]


def _inputs(b, s, h, p, g, n, seed=4):
    rs = np.random.RandomState(seed)
    x = rs.randn(b, s, h, p).astype(np.float32)
    dt = np.logaddexp(rs.randn(b, s, h), 0.0).astype(np.float32)  # softplus
    A = (-np.exp(rs.randn(h) * 0.5)).astype(np.float32)
    Bm = (rs.randn(b, s, g, n) * 0.3).astype(np.float32)
    C = (rs.randn(b, s, g, n) * 0.3).astype(np.float32)
    return x, dt, A, Bm, C


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("case", SSD_CASES, ids=IDS)
def test_ssd_sequential_matches_reference(case):
    b, s, h, p, g, n, _ = case
    ins = _inputs(b, s, h, p, g, n)
    y, st_ = ssd_sequential(*_t(*ins))
    jy, jst = jssd_sequential(*_j(*ins))
    _close(y, jy)
    _close(st_, jst)


@pytest.mark.parametrize("case", SSD_CASES, ids=IDS)
def test_ssd_chunked_matches_reference_and_sequential(case):
    b, s, h, p, g, n, chunk = case
    ins = _inputs(b, s, h, p, g, n)
    y, st_ = ssd_chunked(*_t(*ins), chunk=chunk)
    jy, jst = jssd_chunked(*_j(*ins), chunk=chunk)
    sy, sst = jssd_sequential(*_j(*ins))
    _close(y, jy)
    _close(st_, jst)
    _close(y, sy)
    _close(st_, sst)


@pytest.mark.parametrize("case", SSD_CASES, ids=IDS)
def test_ssd_chunked_with_init_state_matches_reference(case):
    b, s, h, p, g, n, chunk = case
    ins = _inputs(b, s, h, p, g, n, seed=8)
    init = np.random.RandomState(9).randn(b, h, p, n).astype(np.float32)
    y, st_ = ssd_chunked(*_t(*ins), chunk=chunk,
                         init_state=torch.from_numpy(init))
    jy, jst = jssd_chunked(*_j(*ins), chunk=chunk,
                           init_state=jnp.asarray(init))
    _close(y, jy)
    _close(st_, jst)


@pytest.mark.parametrize("case", SSD_CASES, ids=IDS)
def test_ops_ssd_on_cpu_matches_pallas_kernel_interpreted(case):
    b, s, h, p, g, n, chunk = case
    ins = _inputs(b, s, h, p, g, n)
    y, st_ = ops.ssd(*_t(*ins), chunk=chunk)
    py, pst = ssd_chunked_pallas(*_j(*ins), chunk=chunk, interpret=True)
    _close(y, py)
    _close(st_, pst)


@settings(max_examples=8, deadline=None)
@given(s=st.integers(8, 96), chunk=st.sampled_from([8, 16, 32]))
def test_ssd_chunk_invariance(s, chunk):
    """Property: the chunked algorithm is exact for ANY chunk size."""
    ins = _t(*_inputs(1, s, 2, 16, 1, 8, seed=5))
    y1, st1 = ssd_sequential(*ins)
    y2, st2 = ssd_chunked(*ins, chunk=chunk)
    _close(y2, y1)
    _close(st2, st1)


def test_ssd_decode_continuation():
    """Chunked prefill state + single-token decode == longer sequential."""
    x, dt, A, Bm, C = _t(*_inputs(1, 33, 2, 16, 1, 8, seed=6))
    y_all, _ = ssd_sequential(x, dt, A, Bm, C)
    _, st_ = ssd_chunked(x[:, :-1], dt[:, :-1], A, Bm[:, :-1], C[:, :-1],
                         chunk=16)
    y_last, _ = ssd_decode(x[:, -1], dt[:, -1], A, Bm[:, -1], C[:, -1], st_)
    _close(y_last, y_all[:, -1])


def test_ssd_decode_matches_reference():
    from repro.models.ssm import ssd_decode as jssd_decode
    x, dt, A, Bm, C = _inputs(2, 1, 4, 16, 2, 8, seed=7)
    state = np.random.RandomState(3).randn(2, 4, 16, 8).astype(np.float32)
    args = (x[:, 0], dt[:, 0], A, Bm[:, 0], C[:, 0], state)
    y, new = ssd_decode(*_t(*args))
    jy, jnew = jssd_decode(*_j(*args))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-6)
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew), atol=1e-6)


def test_ops_ssd_refuses_a_device_without_a_kernel():
    ins = [t.to("meta") for t in _t(*_inputs(1, 8, 2, 16, 1, 8))]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.ssd(*ins, chunk=8)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never runs the plain version in its place."""
    with pytest.raises(ValueError, match="CUDA device"):
        ssd_scan(*_t(*_inputs(1, 64, 2, 32, 1, 16)), chunk=32)


@pytest.mark.cuda
def test_ops_ssd_refuses_a_gradient_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card: the kernel has no CPU mode")
    x, dt, A, Bm, C = (t.cuda() for t in _t(*_inputs(1, 64, 2, 32, 1, 16)))
    with pytest.raises(NotImplementedError, match="item 19"):
        ops.ssd(x.requires_grad_(True), dt, A, Bm, C, chunk=32)
