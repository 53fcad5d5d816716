"""Port flash attention against the JAX reference, on the CPU.

The port's plain versions (the CPU path of ``ops.mha_fused`` and
``ops.mha``) are held to the reference's ``attention_ref`` and to its
Pallas kernels run in interpret mode, on the cases of
``tests/test_kernels.py``; ``attend_chunked`` is held to the reference's
on the same numpy inputs.  Tolerances are the reference's own kernel
tests': forward float32 atol 2e-5 (bf16 2e-2: one rounding of the bf16
output apart), backward float32 atol 5e-4, ``mha_fused`` gradients atol
1e-3.  The CUDA kernels themselves run only on the card:
``tests/test_torch_cuda.py``.
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

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention.flash_attention import \
    flash_attention as pallas_flash_attention
from repro.kernels.flash_attention.flash_attention_bwd import \
    flash_attention_bwd as pallas_flash_attention_bwd
from repro.kernels.flash_attention.ref import attention_ref as jref
from repro.models import attention as JA
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import flash_attention_bwd as fab
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref,
                                                     bf16_dkv_bound,
                                                     bf16_dq_bound)
from repro_torch.models import attention

# small shapes: one intra-op thread is faster and leaves the cores to
# the other test workers
torch.set_num_threads(1)

FA_CASES = [                    # tests/test_kernels.py FA_CASES
    (2, 4, 2, 256, 256, 64, True, 0, "float32"),
    (1, 8, 8, 128, 384, 128, True, 0, "float32"),
    (2, 4, 1, 200, 200, 64, True, 0, "float32"),    # pad path
    (1, 4, 2, 256, 256, 64, True, 128, "float32"),  # SWA
    (1, 2, 2, 128, 256, 64, False, 0, "float32"),   # cross-attn
    (1, 4, 2, 128, 128, 64, True, 0, "bfloat16"),   # low precision
    (2, 4, 2, 128, 128, 80, True, 0, "float32"),    # D 80: zamba2's block
    (1, 4, 1, 130, 130, 120, True, 64, "float32"),  # D 120: h2o-danube
    (1, 8, 2, 96, 96, 120, True, 0, "bfloat16"),
]
BWD_CASES = [                   # tests/test_kernels.py BWD_CASES
    (1, 4, 2, 128, 128, 64, True, 0),
    (2, 2, 1, 96, 160, 64, True, 0),     # padded + MHA-as-GQA
    (1, 4, 4, 128, 128, 64, False, 0),   # non-causal
    (1, 2, 2, 128, 128, 64, True, 64),   # sliding window
    (1, 4, 2, 128, 128, 80, True, 0),    # head dim 80
    (1, 4, 1, 100, 100, 120, True, 0),   # head dim 120, ragged
]
ATOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _np_inputs(b, h, kh, sq, sk, d, seed, n=3):
    rs = np.random.RandomState(seed)
    shapes = [(b, h, sq, d), (b, kh, sk, d), (b, kh, sk, d)]
    shapes += [(b, h, sq, d)] * (n - 3)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("case", FA_CASES,
                         ids=[f"fa{i}" for i in range(len(FA_CASES))])
def test_plain_forward_matches_reference_and_pallas(case):
    b, h, kh, sq, sk, d, causal, window, dtype = case
    arrs = _np_inputs(b, h, kh, sq, sk, d, 0)
    jx = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs]
    tx = [torch.tensor(a).to(getattr(torch, dtype)) for a in arrs]
    o, lse = attention_ref(*tx, causal=causal, window=window)
    assert o.dtype == tx[0].dtype and lse.dtype == torch.float32
    o_p, lse_p = pallas_flash_attention(*jx, causal=causal, window=window,
                                        interpret=True, return_lse=True)
    o_r = jref(*jx, causal=causal, window=window)
    for want in (o_p, o_r):
        np.testing.assert_allclose(o.float().numpy(), _f32(want),
                                   atol=ATOL[dtype])
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_p), atol=2e-5)


@pytest.mark.parametrize("case", BWD_CASES,
                         ids=[f"fabwd{i}" for i in range(len(BWD_CASES))])
def test_plain_backward_matches_pallas_and_grad_of_reference(case):
    b, h, kh, sq, sk, d, causal, window = case
    q, k, v, do = _np_inputs(b, h, kh, sq, sk, d, 7, n=4)
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    o, lse = pallas_flash_attention(jq, jk, jv, causal=causal, window=window,
                                    interpret=True, return_lse=True)
    want_p = pallas_flash_attention_bwd(jq, jk, jv, o, jdo, lse,
                                        causal=causal, window=window,
                                        interpret=True)
    want_g = jax.grad(lambda q, k, v: jnp.sum(
        jref(q, k, v, causal=causal, window=window) * jdo),
        argnums=(0, 1, 2))(jq, jk, jv)
    got = attention_bwd_ref(*(torch.tensor(np.asarray(x)) for x in
                              (q, k, v, o, do, lse)),
                            causal=causal, window=window)
    for g, wp, wg in zip(got, want_p, want_g):
        np.testing.assert_allclose(g.numpy(), np.asarray(wp), atol=5e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(wg), atol=5e-4)


@pytest.mark.parametrize("heads", [(2, 2), (4, 2)], ids=["mha", "gqa"])
def test_mha_fused_on_cpu_matches_grad_of_jax_mha_fused(heads):
    """The port's autograd.Function (plain versions on CPU tensors) against
    jax.grad of the reference's custom_vjp (Pallas, interpret mode)."""
    h, kh = heads
    arrs = _np_inputs(1, h, kh, 128, 128, 64, 8)
    jv, jg = jax.value_and_grad(
        lambda q, k, v: jnp.sum(jops.mha_fused(q, k, v, True, 0, True) ** 2),
        argnums=(0, 1, 2))(*map(jnp.asarray, arrs))
    tx = [torch.tensor(a, requires_grad=True) for a in arrs]
    before = (fa.LAUNCHES, fab.DQ_LAUNCHES, fab.DKV_LAUNCHES)
    val = (ops.mha_fused(*tx) ** 2).sum()
    grads = torch.autograd.grad(val, tx)
    assert (fa.LAUNCHES, fab.DQ_LAUNCHES, fab.DKV_LAUNCHES) == before
    np.testing.assert_allclose(val.item(), float(jv), rtol=1e-5)
    for g, w in zip(grads, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3)


def test_mha_matches_reference_mha():
    rs = np.random.RandomState(3)
    q = rs.randn(2, 70, 4, 32).astype(np.float32)
    k, v = (rs.randn(2, 70, 2, 32).astype(np.float32) for _ in range(2))
    want = jops.mha(*map(jnp.asarray, (q, k, v)), causal=True, window=16)
    got = ops.mha(*map(torch.tensor, (q, k, v)), causal=True, window=16)
    assert got.shape == (2, 70, 4, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


ATTEND_CASES = [       # b, sq, sk, h, kh, hd, causal, window, q_offset, chunk
    (2, 40, 40, 4, 2, 32, True, 0, 0, 16),       # chunks, ragged last
    (1, 33, 50, 4, 1, 32, True, 8, 17, 8),       # window + q_offset
    (1, 24, 24, 2, 2, 32, False, 0, 0, 512),     # one chunk, no mask
    (2, 64, 64, 4, 2, 32, True, 20, 0, 32),      # window, GQA
]


@pytest.mark.parametrize("case", ATTEND_CASES,
                         ids=[f"att{i}" for i in range(len(ATTEND_CASES))])
def test_attend_chunked_matches_reference(case):
    b, sq, sk, h, kh, hd, causal, window, q_offset, chunk = case
    rs = np.random.RandomState(11)
    q = rs.randn(b, sq, h, hd).astype(np.float32)
    k, v = (rs.randn(b, sk, kh, hd).astype(np.float32) for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset, chunk=chunk)
    want = JA.attend_chunked(*map(jnp.asarray, (q, k, v)), **kw)
    got = attention.attend_chunked(*map(torch.tensor, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_attend_chunked_gradient_matches_reference():
    """The CPU training path differentiates the chunked plain attention."""
    rs = np.random.RandomState(12)
    q = rs.randn(2, 48, 4, 32).astype(np.float32)
    k, v = (rs.randn(2, 48, 2, 32).astype(np.float32) for _ in range(2))
    w = rs.randn(2, 48, 4, 32).astype(np.float32)
    jg = jax.grad(lambda q, k, v: jnp.sum(JA.attend_chunked(
        q, k, v, chunk=16) * w), argnums=(0, 1, 2))(
            *map(jnp.asarray, (q, k, v)))
    tx = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    tg = torch.autograd.grad(
        (attention.attend_chunked(*tx, chunk=16) * torch.tensor(w)).sum(),
        tx)
    for g, want in zip(tg, jg):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=1e-5)


@settings(max_examples=10, deadline=None)
@given(sq=st.integers(17, 192), chunk=st.sampled_from([16, 32, 64, 512]),
       window=st.sampled_from([0, 24]))
def test_attend_chunked_chunk_size_invariance(sq, chunk, window):
    """Twin of test_flash_attention_block_size_invariance: the output does
    not depend on the query chunking, and equals the plain ``ops.mha``."""
    rs = np.random.RandomState(sq)
    q = torch.tensor(rs.randn(1, sq, 4, 32).astype(np.float32))
    k, v = (torch.tensor(rs.randn(1, sq, 2, 32).astype(np.float32))
            for _ in range(2))
    got = attention.attend_chunked(q, k, v, window=window, chunk=chunk)
    want = ops.mha(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=3e-5)


def _emulate_bf16_dkv(q, k, v, o, do, lse, causal, window):
    """dk, dv as the bf16 tensor-core dkv kernel rounds them: P and dS cast
    to bf16 and back before the products, the sums in float32, the stored
    gradients in bf16."""
    b, h, sq, d = q.shape
    kh = k.shape[1]
    g, scale = h // kh, 1.0 / np.sqrt(d)
    s = torch.einsum("bkgqd,bksd->bkgqs", q.float().reshape(b, kh, g, sq, d),
                     k.float()) * scale
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(k.shape[2])[None, :]
    vis = torch.ones_like(s[0, 0, 0], dtype=torch.bool)
    if causal:
        vis &= kpos <= qpos
    if window > 0:
        vis &= kpos > qpos - window
    p = torch.where(vis, torch.exp(s - lse.reshape(b, kh, g, sq, 1)), 0.0)
    dof = do.float().reshape(b, kh, g, sq, d)
    dcap = (dof * o.float().reshape(b, kh, g, sq, d)).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bkgqd,bksd->bkgqs", dof, v.float()) - dcap)
    rnd = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    dk = torch.einsum("bkgqs,bkgqd->bksd", rnd(ds),
                      q.float().reshape(b, kh, g, sq, d)) * scale
    dv = torch.einsum("bkgqs,bkgqd->bksd", rnd(p), dof)
    return rnd(dk), rnd(dv)


@pytest.mark.parametrize("case", BWD_CASES,
                         ids=[f"fabwd{i}" for i in range(len(BWD_CASES))])
def test_bf16_dkv_bound_holds_the_kernels_rounding(case):
    """The restated bf16 dk/dv tolerance (``ref.bf16_dkv_bound``): the
    kernel's rounding of P and dS to bf16, emulated in plain torch, stays
    inside it (and breaks the check it replaces, atol 5e-4 + rtol 2^-8),
    and the float32 plain version sits well inside it against the
    reference's Pallas backward (interpret mode) on the same values."""
    b, h, kh, sq, sk, d, causal, window = case
    q, k, v, do = (torch.tensor(a).bfloat16() for a in
                   _np_inputs(b, h, kh, sq, sk, d, 9, n=4))
    o, lse = attention_ref(q, k, v, causal=causal, window=window)
    kw = dict(causal=causal, window=window)
    bound = bf16_dkv_bound(q, k, v, o, do, lse, **kw)
    _, want_k, want_v = attention_bwd_ref(
        *(t.float() for t in (q, k, v, o, do)), lse, **kw)
    emu = _emulate_bf16_dkv(q, k, v, o, do, lse, causal, window)
    jx = [jnp.asarray(t.float().numpy()) for t in (q, k, v, o, do)]
    _, jdk, jdv = pallas_flash_attention_bwd(
        *jx, jnp.asarray(lse.numpy()), causal=causal, window=window,
        interpret=True)
    old_excess = []
    for got, want, pallas, lim in zip(emu, (want_k, want_v), (jdk, jdv),
                                      bound):
        assert lim.shape == want.shape
        assert bool(((got - want).abs() <= lim).all())
        assert bool(((torch.tensor(np.asarray(pallas)) - want).abs()
                     <= 0.1 * lim).all())
        old_excess.append(float(((got - want).abs() - 5e-4
                                 - 2.0 ** -8 * want.abs()).max()))
    assert max(old_excess) > 0


def _emulate_bf16_dq(q, k, v, o, do, lse, causal, window):
    """dq as the bf16 tensor-core dq kernel rounds it: dS cast to bf16 and
    back before dq += dS k, the sums in float32, dq stored in bf16."""
    b, h, sq, d = q.shape
    kh = k.shape[1]
    g, scale = h // kh, 1.0 / np.sqrt(d)
    s = torch.einsum("bkgqd,bksd->bkgqs", q.float().reshape(b, kh, g, sq, d),
                     k.float()) * scale
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(k.shape[2])[None, :]
    vis = torch.ones_like(s[0, 0, 0], dtype=torch.bool)
    if causal:
        vis &= kpos <= qpos
    if window > 0:
        vis &= kpos > qpos - window
    p = torch.where(vis, torch.exp(s - lse.reshape(b, kh, g, sq, 1)), 0.0)
    dof = do.float().reshape(b, kh, g, sq, d)
    dcap = (dof * o.float().reshape(b, kh, g, sq, d)).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bkgqd,bksd->bkgqs", dof, v.float()) - dcap)
    rnd = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    dq = torch.einsum("bkgqs,bksd->bkgqd", rnd(ds), k.float()) * scale
    return rnd(dq.reshape(b, h, sq, d))


@pytest.mark.parametrize("case", BWD_CASES,
                         ids=[f"fabwd{i}" for i in range(len(BWD_CASES))])
def test_bf16_dq_bound_holds_the_kernels_rounding(case):
    """The restated bf16 dq tolerance (``ref.bf16_dq_bound``): the tensor-core
    dq kernel's rounding of dS to bf16, emulated in plain torch, stays
    inside it and breaks the check it replaces (atol 5e-4 + rtol 2^-8,
    written for the float32 FMA dq kernel), and the float32 plain version
    sits well inside it against the reference's Pallas backward
    (interpret mode) on the same values."""
    b, h, kh, sq, sk, d, causal, window = case
    q, k, v, do = (torch.tensor(a).bfloat16() for a in
                   _np_inputs(b, h, kh, sq, sk, d, 9, n=4))
    o, lse = attention_ref(q, k, v, causal=causal, window=window)
    kw = dict(causal=causal, window=window)
    bound = bf16_dq_bound(q, k, v, o, do, lse, **kw)
    want, _, _ = attention_bwd_ref(*(t.float() for t in (q, k, v, o, do)),
                                   lse, **kw)
    got = _emulate_bf16_dq(q, k, v, o, do, lse, causal, window)
    jx = [jnp.asarray(t.float().numpy()) for t in (q, k, v, o, do)]
    jdq, _, _ = pallas_flash_attention_bwd(
        *jx, jnp.asarray(lse.numpy()), causal=causal, window=window,
        interpret=True)
    assert bound.shape == want.shape == got.shape
    assert bool(((got - want).abs() <= bound).all())
    assert bool(((torch.tensor(np.asarray(jdq)) - want).abs()
                 <= 0.1 * bound).all())
    assert float(((got - want).abs() - 5e-4
                  - 2.0 ** -8 * want.abs()).max()) > 0


def test_readable_keeps_model_views_and_copies_misaligned_bf16():
    """The wrappers' stride rule, no card needed: the model's (B, S, H, D)
    bf16 activations at D 64 go to the kernels as the transposed view
    itself; a bf16 view whose s-stride is not a multiple of 8 elements (16
    bytes, as TMA needs) is copied; the same stride in float32 (16-byte
    multiples) is not."""
    x = torch.randn(2, 130, 9, 64).bfloat16()
    view = x.transpose(1, 2)
    assert fa.readable(view) is view
    padded = torch.randn(2, 130, 3 * 64 + 4).bfloat16()
    odd = padded[..., :192].unflatten(-1, (3, 64)).transpose(1, 2)
    assert odd.stride(2) % 8 != 0
    copy = fa.readable(odd)
    assert copy is not odd and copy.is_contiguous()
    assert torch.equal(copy, odd)
    odd32 = padded.float()[..., :192].unflatten(-1, (3, 64)).transpose(1, 2)
    assert fa.readable(odd32) is odd32
