"""Port SSD scan against the JAX reference, on the CPU.

The same numpy inputs go through the port's plain versions
(``kernels/ssd/ref.py``: ``ssd_sequential``, ``ssd_chunked`` with and
without an initial state; ``ops.ssd``, which takes ``ssd_chunked`` for a
CPU tensor) and through the reference's ``ssd_sequential``,
``models.ssm.ssd_chunked`` and the Pallas kernel ``ssd_chunked_pallas``
in interpret mode, on ``SSD_CASES`` of ``tests/test_kernels.py`` (grouped
B/C with G 1, 2 and 4, a ragged S, chunks 32 to 128).  Then the
chunk-invariance property and the decode continuation, as the reference's
kernel tests state them, on the port.  The backward: ``ssd_chunked_bwd``
against ``jax.grad`` of the reference's ``ssd_chunked`` (chunks 32 to
128, ragged S, G 1 and 2, with and without an initial state and a
dfinal_state), against autograd of the token-by-token recurrence where
the reference's gradient overflows, and ``ops.ssd``'s autograd Function
against autograd of ``ssd_chunked``.

Tolerance: atol 5e-4 on y and the state, the reference's kernel tests'
own: the chunked and sequential forms sum the same float32 terms in other
orders.  The bf16 tensor-core kernels' arithmetic (the chunk-parallel split
with every float32 operand as bf16 hi + lo) is emulated in plain torch and
held to the card's tolerances (``tests/test_torch_cuda.py``: atol 5e-4
plus rtol 2^-12 on the state, 2^-8 on the bf16 y).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
try:
    from hypothesis import given, settings, strategies as st
except ImportError:          # offline env: deterministic shim
    from _hypothesis_fallback import given, settings, strategies as st

from repro.kernels.ssd.ref import ssd_sequential as jssd_sequential
from repro.kernels.ssd.ssd import ssd_chunked_pallas
from repro.models.ssm import ssd_chunked as jssd_chunked
from repro_torch.kernels.ssd import ops
from repro_torch.kernels.ssd import ssd as ssd_k
from repro_torch.kernels.ssd.ref import (ssd_chunked, ssd_chunked_bwd,
                                        ssd_sequential)
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
def test_ops_ssd_gradient_on_the_card_launches_the_backward_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card: the kernel has no CPU mode")
    x, dt, A, Bm, C = (t.cuda() for t in _t(*_inputs(1, 64, 2, 32, 1, 16)))
    before = ssd_k.BWD_LAUNCHES
    y, _ = ops.ssd(x.requires_grad_(True), dt, A, Bm, C, chunk=32)
    y.sum().backward()
    assert ssd_k.BWD_LAUNCHES == before + 1
    assert x.grad.shape == x.shape


# ---------------------------------------------------------------- backward
BWD_CASES = [                       # b, s, h, p, g, n, chunk
    (2, 128, 4, 32, 1, 16, 32),
    (1, 200, 8, 16, 2, 8, 64),      # ragged S, G 2
    (2, 77, 4, 32, 2, 16, 32),      # ragged S inside the first chunk's pad
    (1, 256, 4, 16, 1, 8, 128),
]
BWD_IDS = [f"bwd{i}" for i in range(len(BWD_CASES))]


def _bwd_inputs(b, s, h, p, g, n, seed):
    """The forward's inputs with dt in mamba2's own range (its dt_bias
    spans softplus 1e-3 to 1e-1; here 0.1 x softplus of a normal), a dy
    and a dfinal_state.  Within a chunk of 128 the decays' exponents stay
    far below float32's exp overflow at 88, so ``jax.grad`` of the
    reference's scan, whose masked upper triangle holds exp of positive
    sums (0 x inf is NaN in its gradient), is finite; the port's backward
    masks before the exp (``test_ssd_chunked_bwd_stays_finite...``)."""
    x, dt, A, Bm, C = _inputs(b, s, h, p, g, n, seed=seed)
    rs = np.random.RandomState(seed + 1)
    return (x, (0.1 * dt).astype(np.float32), A, Bm, C,
            rs.randn(b, h, p, n).astype(np.float32),
            rs.randn(b, s, h, p).astype(np.float32),
            rs.randn(b, h, p, n).astype(np.float32))


@pytest.mark.parametrize("with_init", [False, True],
                         ids=["zeros", "init_dfinal"])
@pytest.mark.parametrize("case", BWD_CASES, ids=BWD_IDS)
def test_ssd_chunked_bwd_matches_jax_grad(case, with_init):
    """Every gradient of the plain backward against ``jax.grad`` of the
    reference's ``ssd_chunked`` on the same numpy inputs, atol 5e-4."""
    b, s, h, p, g, n, chunk = case
    x, dt, A, Bm, C, init, dy, dfin = _bwd_inputs(b, s, h, p, g, n, seed=3)

    def loss(x, dt, A, Bm, C, init):
        y, fin = jssd_chunked(x, dt, A, Bm, C, chunk=chunk,
                              init_state=init if with_init else None)
        return jnp.sum(y * dy) + (jnp.sum(fin * dfin) if with_init else 0.0)

    want = jax.grad(loss, argnums=tuple(range(6)))(*_j(x, dt, A, Bm, C,
                                                       init))
    got = ssd_chunked_bwd(*_t(x, dt, A, Bm, C, dy), chunk=chunk,
                          init_state=torch.from_numpy(init) if with_init
                          else None,
                          dfinal_state=torch.from_numpy(dfin) if with_init
                          else None)
    assert [t.dtype for t in got] == [torch.float32] * 6
    for mine, ref in zip(got[:5] + (got[5] if with_init else None,),
                         want):
        if mine is not None:
            _close(mine, ref)


def test_ssd_chunked_bwd_keeps_the_input_dtypes():
    x, dt, A, Bm, C, _, dy, _ = _bwd_inputs(1, 40, 2, 16, 1, 8, seed=4)
    bf = [torch.from_numpy(a).bfloat16() for a in (x, Bm, C, dy)]
    got = ssd_chunked_bwd(bf[0], torch.from_numpy(dt), torch.from_numpy(A),
                          bf[1], bf[2], bf[3], chunk=32)
    assert [t.dtype for t in got] == [torch.bfloat16, torch.float32,
                                      torch.float32, torch.bfloat16,
                                      torch.bfloat16, torch.float32]


def test_ssd_chunked_bwd_stays_finite_where_the_reference_overflows():
    """dt of softplus(normal), chunk 64: some decays' masked exponents pass
    88, where the reference's gradient turns NaN.  The port's backward
    masks before the exp and equals autograd of the token-by-token
    recurrence (whose decays are each at most 1), atol 5e-4."""
    b, s, h, p, g, n = 1, 200, 8, 16, 2, 8
    x, dt, A, Bm, C = _t(*_inputs(b, s, h, p, g, n, seed=4))
    dy = torch.from_numpy(np.random.RandomState(5).randn(b, s, h, p)
                          .astype(np.float32))
    got = ssd_chunked_bwd(x, dt, A, Bm, C, dy, chunk=64)
    ins = [t.clone().requires_grad_(True) for t in (x, dt, A, Bm, C)]
    y, _ = ssd_sequential(*ins)
    want = torch.autograd.grad((y * dy).sum(), ins)
    for mine, ref in zip(got, want):
        assert bool(torch.isfinite(mine).all())
        _close(mine, ref)


def test_ops_ssd_autograd_matches_autograd_of_chunked():
    """The autograd Function on the CPU (``ssd_chunked`` forward,
    ``ssd_chunked_bwd`` backward) against torch.autograd of
    ``ssd_chunked``, with an initial state and both outputs used, on
    strided views of one tensor as ``mamba_apply`` passes them."""
    b, s, h, p, g, n, chunk = 2, 77, 4, 32, 2, 16, 32
    x, dt, A, Bm, C, init, dy, dfin = (torch.from_numpy(a) for a in
                                       _bwd_inputs(b, s, h, p, g, n, 6))
    xbc = torch.cat([x.reshape(b, s, -1), Bm.reshape(b, s, -1),
                     C.reshape(b, s, -1)], dim=-1)
    grads = []
    for fn in (ops.ssd, ssd_chunked):
        leaf = [t.clone().requires_grad_(True) for t in (xbc, dt, A, init)]
        xp, bp, cp = torch.split(leaf[0], [h * p, g * n, g * n], dim=-1)
        y, fin = fn(xp.reshape(b, s, h, p), leaf[1], leaf[2],
                    bp.reshape(b, s, g, n), cp.reshape(b, s, g, n),
                    chunk=chunk, init_state=leaf[3])
        grads.append(torch.autograd.grad(
            (y * dy).sum() + (fin * dfin).sum(), leaf))
    for mine, ref in zip(*grads):
        _close(mine, ref)


def _bf16(v):
    return v.to(torch.bfloat16).float()


def _hi_lo(v, two=True):
    """What a float32 operand brings to the kernels' bf16 products: hi + lo
    (both bf16), or hi alone (``two=False``, the design not taken)."""
    hi = _bf16(v)
    return hi + _bf16(v - hi) if two else hi


def _emulate_bf16_ssd(x, dt, A, Bm, C, chunk, init=None, two=True):
    """The bf16 SSD kernels' arithmetic in plain torch: C B^T per group;
    each chunk's state X^T (w B) with w B split into bf16 hi + lo; the
    state passed from chunk to chunk in float32; y = exp(cum) C . state^T
    with the entering state split, plus (C B^T o decay o dt) X with the
    decayed scores split; products of bf16 values summed in float32; y
    rounded to bf16."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    pad = (-s) % chunk
    xf, dtf, Bf, Cf = x.float(), dt.float(), Bm.float(), C.float()
    if pad:                       # dt = 0 past S, as the kernels read it
        xf, Bf, Cf = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xf, Bf, Cf))
        dtf = F.pad(dtf, (0, 0, 0, pad))
    nc = xf.shape[1] // chunk
    xc = xf.reshape(b, nc, chunk, g, rep, p)
    dtc = dtf.reshape(b, nc, chunk, h)
    Bc, Cc = (t.reshape(b, nc, chunk, g, n) for t in (Bf, Cf))
    cum = torch.cumsum(dtc * A[None, None, None, :], 2)
    seg = cum[:, :, -1]
    cb = torch.einsum("bclgn,bcmgn->bclmg", Cc, Bc)             # once per g
    w = (torch.exp(seg[:, :, None, :] - cum) * dtc).reshape(
        b, nc, chunk, g, rep)
    wb = _hi_lo(w[..., None] * Bc[:, :, :, :, None, :], two)
    states = torch.einsum("bclgrp,bclgrn->bcgrpn", xc, wb).reshape(
        b, nc, h, p, n)
    st_ = torch.zeros(b, h, p, n) if init is None else init.float()
    prevs = []
    for c in range(nc):
        prevs.append(st_)
        st_ = torch.exp(seg[:, c])[:, :, None, None] * st_ + states[:, c]
    prev = _hi_lo(torch.stack(prevs, 1), two).reshape(b, nc, g, rep, p, n)
    y_off = (torch.einsum("bclgn,bcgrpn->bclgrp", Cc, prev)
             * torch.exp(cum).reshape(b, nc, chunk, g, rep)[..., None])
    tril = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    decay = torch.where(tril[None, None, :, :, None],
                        torch.exp(cum[:, :, :, None] - cum[:, :, None]),
                        torch.zeros(()))                       # (B,nc,L,L,H)
    scores = cb[..., None] * (decay * dtc[:, :, None]).reshape(
        b, nc, chunk, chunk, g, rep)
    y_diag = torch.einsum("bclmgr,bcmgrp->bclgrp", _hi_lo(scores, two), xc)
    y = (y_diag + y_off).reshape(b, nc * chunk, h, p)[:, :s]
    return _bf16(y), st_


def _excess(got, want, rtol):
    return float(((got - want).abs() - ATOL - rtol * want.abs()).max())


@pytest.mark.parametrize("with_init", [False, True], ids=["zeros", "init"])
@pytest.mark.parametrize("case", SSD_CASES + [(2, 77, 8, 32, 1, 16, 32)],
                         ids=IDS + ["ragged"])
def test_bf16_kernel_arithmetic_keeps_the_tolerances(case, with_init):
    """The bf16 tensor-core SSD's split and roundings, emulated, stay inside
    the card's check against the float32 chunked scan on the same bf16
    values (state atol 5e-4 + rtol 2^-12, y + rtol 2^-8), and inside the
    same bounds against the sequential recurrence and the reference's
    chunked scan; one bf16 rounding of each float32 operand (hi alone)
    would break them, which is why the kernels run hi + lo."""
    b, s, h, p, g, n, chunk = case
    x, dt, A, Bm, C = _t(*_inputs(b, s, h, p, g, n, seed=10))
    x, Bm, C = (t.bfloat16() for t in (x, Bm, C))
    init = (torch.from_numpy(np.random.RandomState(11).randn(
        b, h, p, n).astype(np.float32)) if with_init else None)
    y, st_ = _emulate_bf16_ssd(x, dt, A, Bm, C, chunk, init)
    f32 = (x.float(), dt, A, Bm.float(), C.float())
    wy, wst = ssd_chunked(*f32, chunk=chunk, init_state=init)
    assert _excess(y, wy, 2.0 ** -8) <= 0
    assert _excess(st_, wst, 2.0 ** -12) <= 0
    jy, jst = jssd_chunked(*_j(*(t.numpy() for t in f32)), chunk=chunk,
                           init_state=None if init is None
                           else jnp.asarray(init.numpy()))
    assert _excess(y, torch.tensor(np.asarray(jy)), 2.0 ** -8) <= 0
    assert _excess(st_, torch.tensor(np.asarray(jst)), 2.0 ** -12) <= 0
    if init is None:
        sy, sst = ssd_sequential(*f32)
        assert _excess(y, sy, 2.0 ** -8) <= 0
        assert _excess(st_, sst, 2.0 ** -12) <= 0
    y1, st1 = _emulate_bf16_ssd(x, dt, A, Bm, C, chunk, init, two=False)
    assert max(_excess(y1, wy, 2.0 ** -8),
               _excess(st1, wst, 2.0 ** -12)) > 0
