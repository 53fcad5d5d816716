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
plus rtol 2^-12 on the state, 2^-8 on the bf16 y).  So is the bf16
tensor-core backward's (its five stages, float32 operands as bf16 hi + lo
and the decayed scores as hi + mid + lo), against ``ssd_chunked_bwd`` at
the card's limits and ``jax.grad`` of the reference's scan.
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
    """A device with neither a kernel nor the plain version raises.
    ``meta`` tensors (the dry run's) take the plain version, which on
    them computes shapes only: the CPU run's shapes and dtypes."""
    import types
    with pytest.raises(ValueError, match="no kernel for device xpu"):
        ops._device(types.SimpleNamespace(device=torch.device("xpu")))
    cpu = _t(*_inputs(1, 8, 2, 16, 1, 8))
    want = ops.ssd(*cpu, chunk=8)
    got = ops.ssd(*[t.to("meta") for t in cpu], chunk=8)
    for g, w in zip(got, want):
        assert g.is_meta and (g.shape, g.dtype) == (w.shape, w.dtype)


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


# ----------------------------------------- the bf16 backward's arithmetic
def _hi_mid_lo(v, split=True):
    """A float32 operand as bf16 hi + mid + lo (each the nearest bf16 of
    what the ones before leave), or hi alone (``split=False``)."""
    hi = _bf16(v)
    if not split:
        return hi
    mid = _bf16(v - hi)
    return hi + mid + _bf16(v - hi - mid)


def _emulate_bf16_ssd_bwd(x, dt, A, Bm, C, dy, chunk, init=None,
                          dfinal=None, two=True, rounded=True, three=True):
    """The bf16 tensor-core backward's stages and roundings in plain torch
    (``csrc/ssd_bwd.cu``), products of bf16 values summed in float32:
    stage 1 the forward's (C B^T per group; each chunk's own state X^T
    (w B) with w B split into bf16 hi + lo; the states passed in float32);
    stage 2 each chunk's share of dh_in, dy^T (exp(cum) C), exp(cum) C
    split; stage 3 the reverse pass in float32, with <dh_out, h_out>;
    stage 4 the key side (g and dB from dh_out split, the decayed scores
    split in three and x dy^T o decay split) and the query side (y and dC
    from h_in split, the decayed scores o dt split in three and dy x^T o
    decay o dt split); stage 5 the suffix sums of dcum.  dx, dB and dC
    are rounded to bf16 at the end where ``rounded``; ``two=False``
    leaves every float32 operand at hi alone, ``three=False`` splits the
    scores in two as well."""
    b, s, h, p = x.shape
    g, n = Bm.shape[2], Bm.shape[3]
    rep = h // g
    pad = (-s) % chunk
    xf, Bf, Cf, dyf = (t.float() for t in (x, Bm, C, dy))
    dtf = dt.float()
    if pad:                       # dt = 0 past S, as the kernels read it
        xf, Bf, Cf, dyf = (F.pad(t, (0, 0, 0, 0, 0, pad))
                           for t in (xf, Bf, Cf, dyf))
        dtf = F.pad(dtf, (0, 0, 0, pad))
    nc = xf.shape[1] // chunk
    xc, dyc = (t.reshape(b, nc, chunk, h, p) for t in (xf, dyf))
    dtc = dtf.reshape(b, nc, chunk, h)
    Bg, Cg = (t.reshape(b, nc, chunk, g, n) for t in (Bf, Cf))
    Bh, Ch = (t.repeat_interleave(rep, dim=3) for t in (Bg, Cg))

    def hl(v):
        return _hi_lo(v, two)

    def hml(v):
        return _hi_mid_lo(v, two) if three else hl(v)

    # stage 1: the forward's C B^T, cum, dt and states
    cum = torch.cumsum(dtc * A, 2)                            # (B,nc,L,H)
    seg = cum[:, :, -1]
    cb = torch.einsum("bctgn,bcsgn->bctsg", Cg, Bg).repeat_interleave(
        rep, dim=4)                                           # [t, s]
    tail = torch.exp(seg[:, :, None] - cum)
    own = torch.einsum("bcshp,bcshn->bchpn", xc,
                       hl((tail * dtc)[..., None] * Bh))
    st_ = torch.zeros(b, h, p, n) if init is None else init.float()
    h_in = []
    for c in range(nc):
        h_in.append(st_)
        st_ = torch.exp(seg[:, c])[..., None, None] * st_ + own[:, c]
    h_in = torch.stack(h_in, 1)                               # (B,nc,H,P,N)
    h_out = torch.cat([h_in[:, 1:], st_[:, None]], 1)
    # stage 2: the shares; stage 3: the reverse pass
    share = torch.einsum("bcthp,bcthn->bchpn", dyc,
                         hl(torch.exp(cum)[..., None] * Ch))
    dh = torch.zeros(b, h, p, n) if dfinal is None else dfinal.float()
    dh_out = [None] * nc
    for c in reversed(range(nc)):
        dh_out[c] = dh
        dh = torch.exp(seg[:, c])[..., None, None] * dh + share[:, c]
    dinit, dh_out = dh, torch.stack(dh_out, 1)
    carry = (dh_out * h_out).sum((-2, -1))                    # (B,nc,H)
    # stage 4: the key side (rows s) and the query side (rows t)
    tril = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool))
    tril = tril[None, None, :, :, None]
    diff = cum[:, :, :, None] - cum[:, :, None]               # [t, s]
    decay = torch.where(tril, torch.exp(torch.where(tril, diff, 0.0)), 0.0)
    dyx = torch.einsum("bcthp,bcshp->bctsh", dyc, xc) * decay
    dhs, hins = hl(dh_out), hl(h_in)
    gk = (tail[..., None] * torch.einsum("bcshn,bchpn->bcshp", Bh, dhs)
          + torch.einsum("bctsh,bcthp->bcshp", hml(cb * decay), dyc))
    dB = dtc[..., None] * (
        tail[..., None] * torch.einsum("bcshp,bchpn->bcshn", xc, dhs)
        + torch.einsum("bctsh,bcthn->bcshn", hl(dyx), Ch))
    dx = dtc[..., None] * gk
    xg = (xc * gk).sum(-1)
    ecum = torch.exp(cum)[..., None]
    dts = dtc[:, :, None]                                     # dt_s
    y = (ecum * torch.einsum("bcthn,bchpn->bcthp", Ch, hins)
         + torch.einsum("bctsh,bcshp->bcthp", hml(cb * decay * dts), xc))
    dC = (ecum * torch.einsum("bcthp,bchpn->bcthn", dyc, hins)
          + torch.einsum("bctsh,bcshn->bcthn", hl(dyx * dts), Bh))
    # stage 5: dcum's suffix sums
    dcum = (dyc * y).sum(-1) - dtc * xg
    dcum[:, :, -1] += carry
    rsum = torch.flip(torch.cumsum(torch.flip(dcum, [2]), 2), [2])
    ddt = xg + A * rsum
    dA = (dtc * rsum).sum((0, 1, 2))

    def out(t):
        return t.reshape(b, nc * chunk, *t.shape[3:])[:, :s]

    def grouped(t):
        return out(t.reshape(b, nc, chunk, g, rep, n).sum(4))

    got = [out(dx), out(ddt), dA, grouped(dB), grouped(dC), dinit]
    if rounded:
        for k in (0, 3, 4):
            got[k] = _bf16(got[k])
    return got


def _bwd_excess(got, want):
    """The worst excess of each gradient over the card's limits for bf16
    (``chip_smoke.py::ssd_bwd_limits``): dx atol + 2^-8 of each element,
    dinit atol + 2^-12; ddt, dA, dB and dC atol + 2^-12 of the tensor's
    largest |value|, dB and dC also + 2^-8 of each element."""
    out = []
    for k, (a, w) in enumerate(zip(got, want)):
        w = w.float().abs()
        lim = ATOL + {0: 2.0 ** -8 * w, 5: 2.0 ** -12 * w}.get(
            k, 2.0 ** -12 * float(w.max())
            + (2.0 ** -8 * w if k in (3, 4) else 0.0))
        out.append(float(((a.float() - want[k].float()).abs() - lim).max()))
    return out


BF16_BWD_CASES = [                  # b, s, h, p, g, n, chunk
    (2, 128, 4, 64, 1, 32, 32),
    (1, 200, 4, 64, 2, 64, 64),     # ragged S, G 2
    (1, 256, 2, 64, 1, 128, 128),   # mamba2's (P, N)
    (1, 300, 4, 32, 2, 16, 256),    # chunk 256, ragged S
    (2, 77, 4, 32, 1, 16, 32),      # ragged S inside the first tile
]
BF16_BWD_IDS = [f"tc{i}" for i in range(len(BF16_BWD_CASES))]


def _bf16_bwd_inputs(case, with_init, seed=12):
    b, s, h, p, g, n, chunk = case
    x, dt, A, Bm, C, init, dy, dfin = (torch.from_numpy(a) for a in
                                       _bwd_inputs(b, s, h, p, g, n, seed))
    x, Bm, C, dy = (_bf16(t) for t in (x, Bm, C, dy))
    return (x, dt, A, Bm, C, dy, init if with_init else None,
            dfin if with_init else None)


@pytest.mark.parametrize("with_init", [False, True],
                         ids=["zeros", "init_dfinal"])
@pytest.mark.parametrize("case", BF16_BWD_CASES, ids=BF16_BWD_IDS)
def test_bf16_bwd_arithmetic_keeps_the_tolerances(case, with_init):
    """The bf16 tensor-core backward's stages and hi + lo splits, emulated
    on bf16 values: with its bf16 roundings inside the card's limits
    against ``ref.ssd_chunked_bwd`` (phase 3's ``ssd_bwd_limits``), and
    before them within atol 5e-4 of ``jax.grad`` of the reference's
    ``ssd_chunked`` (dt in mamba2's range, as the plain backward's twin).
    dA alone is held as the card holds it, atol 5e-4 plus 2^-12 of its
    largest |value|: it sums dt_u R_u over every position of every row,
    terms far larger than the result (|dA| 8-300 here), and each split
    term is up to 2^-17 of its size off, so elementwise it misses atol
    5e-4 by up to 1.2e-3 (tc2, |dA| 17) where the float32 plain version
    stays within 1.1e-4."""
    chunk = case[6]
    x, dt, A, Bm, C, dy, init, dfin = _bf16_bwd_inputs(case, with_init)
    want = ssd_chunked_bwd(x, dt, A, Bm, C, dy, chunk=chunk,
                           init_state=init, dfinal_state=dfin)
    got = _emulate_bf16_ssd_bwd(x, dt, A, Bm, C, dy, chunk, init, dfin)
    assert max(_bwd_excess(got, want)) <= 0

    def loss(x, dt, A, Bm, C, init):
        y, fin = jssd_chunked(x, dt, A, Bm, C, chunk=chunk,
                              init_state=init if with_init else None)
        return jnp.sum(y * jnp.asarray(dy.numpy())) + (
            jnp.sum(fin * jnp.asarray(dfin.numpy())) if with_init else 0.0)

    init0 = init if with_init else torch.zeros(case[0], case[2], case[3],
                                               case[5])
    jgrad = jax.grad(loss, argnums=tuple(range(6)))(
        *_j(*(t.numpy() for t in (x, dt, A, Bm, C, init0))))
    raw = _emulate_bf16_ssd_bwd(x, dt, A, Bm, C, dy, chunk, init, dfin,
                                rounded=False)
    for k, (mine, ref) in enumerate(zip(raw, jgrad)):
        if k < 5 or with_init:
            assert bool(np.isfinite(np.asarray(ref)).all())
            ref = np.asarray(ref)
            np.testing.assert_allclose(
                np.asarray(mine), ref,
                atol=ATOL + (2.0 ** -12 * np.abs(ref).max() if k == 2
                             else 0.0))


def test_bf16_bwd_without_the_split_misses():
    """One bf16 rounding of each float32 operand (hi alone) takes the
    emulated backward outside the card's limits, which is why the kernels
    run hi + lo."""
    case = BF16_BWD_CASES[2]
    x, dt, A, Bm, C, dy, init, dfin = _bf16_bwd_inputs(case, True)
    want = ssd_chunked_bwd(x, dt, A, Bm, C, dy, chunk=case[6],
                           init_state=init, dfinal_state=dfin)
    got = _emulate_bf16_ssd_bwd(x, dt, A, Bm, C, dy, case[6], init, dfin,
                                two=False)
    assert max(_bwd_excess(got, want)) > 0


def test_bf16_bwd_scores_split_in_three_hold_where_two_miss():
    """The card test's inputs (``tests/test_torch_cuda.py`` SSD_CASES[2]:
    dt = softplus(normal), chunk 128 of two 64-row tiles): with the
    decayed scores of g and y split in two, dA misses the card's limit
    (the card's first version missed it by 1.6x at the ragged main
    shape); split in three, as the kernels do, every gradient holds."""
    b, s, h, p, g, n, chunk = 2, 256, 4, 32, 4, 16, 128
    rs = np.random.RandomState(8)
    x = _bf16(torch.from_numpy(rs.randn(b, s, h, p).astype(np.float32)))
    dt = torch.from_numpy(np.logaddexp(rs.randn(b, s, h), 0.0).astype(
        np.float32))
    A = torch.from_numpy((-np.exp(rs.randn(h) * 0.5)).astype(np.float32))
    Bm, C = (_bf16(torch.from_numpy((rs.randn(b, s, g, n) * 0.3).astype(
        np.float32))) for _ in range(2))
    dy = _bf16(torch.from_numpy(np.random.RandomState(9).randn(
        b, s, h, p).astype(np.float32)))
    want = ssd_chunked_bwd(x, dt, A, Bm, C, dy, chunk=chunk)
    got = _emulate_bf16_ssd_bwd(x, dt, A, Bm, C, dy, chunk)
    assert max(_bwd_excess(got, want)) <= 0
    two = _emulate_bf16_ssd_bwd(x, dt, A, Bm, C, dy, chunk, three=False)
    assert _bwd_excess(two, want)[2] > 0
