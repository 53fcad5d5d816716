"""Port sampler against the JAX reference and its own invariants.

Greedy decisions and filter masks must equal the reference exactly.  The
port draws its noise from Philox4x32-10 rather than threefry, so sampled
tokens are held to the port's own invariants (same key -> same token
whatever the batch) and to a chi-square test of the distribution.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro.serve import sampler as J
from repro_torch.serve import sampler as S

# small shapes: one intra-op thread is faster and leaves the cores to
# the other test workers
torch.set_num_threads(1)


def _logits(b, v, seed=0, scale=3.0):
    return (np.random.RandomState(seed).randn(b, v) * scale).astype(
        np.float32)


@pytest.mark.parametrize("key,want", [
    ((0, 0, 0, 0, 0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 6, (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344, 0xa4093822,
      0x299f31d0), (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
], ids=["zeros", "ones", "pi"])
def test_philox_known_answers(key, want):
    """Random123's known-answer vectors for philox4x32-10:
    (ctr0..3, key0, key1) -> four output words."""
    got = S.philox4x32(*(torch.tensor([x], dtype=torch.long) for x in key))
    assert tuple(int(x) for x in got) == want


def test_greedy_equals_reference():
    logits = _logits(6, 97)
    temps = np.array([0.0, -1.0, 0.0, 0.0, 0.0, 0.0], np.float32)
    keys = S.fold_row_keys(0, torch.arange(6), torch.arange(6))
    got = S.sample_per_row(keys, torch.tensor(logits), torch.tensor(temps))
    want = J.sample_per_row(jax.random.PRNGKey(0), jnp.asarray(logits),
                            jnp.asarray(temps))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


def _nucleus_mids(z, top_k, rs):
    """top_p per row halfway between two consecutive cumulative
    probabilities of the top-k-filtered sorted row: no cumsum lies within
    1e-6 of it, so the frameworks' summation orders cannot disagree."""
    out = []
    for row, k in zip(z.astype(np.float64), top_k):
        srt = np.sort(row)[::-1]
        if k > 0:
            srt = srt[:min(k, len(srt))]
        p = np.exp(srt - srt[0])
        cum = np.cumsum(p / p.sum())
        j = rs.randint(0, max(len(cum) - 1, 1))
        mid = (cum[j] + cum[j + 1]) / 2 if j + 1 < len(cum) else 0.5
        assert np.abs(cum - mid).min() > 1e-6
        out.append(mid)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filter_masks_equal_reference_bit_for_bit(seed):
    rs = np.random.RandomState(seed)
    b, v = 8, 64
    z = _logits(b, v, seed=seed + 10)
    top_k = np.array([0, 1, 5, 20, 0, v, v + 3, 7], np.int32)
    top_p = _nucleus_mids(z, top_k, rs)
    top_p[[0, 3]] = 1.0                       # filter off on two rows
    got = S._filter_per_row(torch.tensor(z), torch.tensor(top_k),
                            torch.tensor(top_p)).numpy()
    want = np.asarray(J._filter_per_row(jnp.asarray(z), jnp.asarray(top_k),
                                        jnp.asarray(top_p)))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(got[np.isfinite(got)],
                                  want[np.isfinite(want)])
    assert np.isfinite(got).any(axis=1).all()  # one token always survives


def test_single_row_filters_equal_reference():
    z = _logits(4, 50, seed=7)
    rs = np.random.RandomState(3)
    for k in (0, 1, 9):
        np.testing.assert_array_equal(
            S._apply_top_k(torch.tensor(z), k).numpy(),
            np.asarray(J._apply_top_k(jnp.asarray(z), k)))
    for row in range(4):
        p = float(_nucleus_mids(z[row:row + 1], [0], rs)[0])
        np.testing.assert_array_equal(
            S._apply_top_p(torch.tensor(z[row]), p).numpy(),
            np.asarray(J._apply_top_p(jnp.asarray(z[row]), p)))
    np.testing.assert_array_equal(
        S._apply_min_p(torch.tensor(z), 0.05).numpy(),
        np.asarray(J._apply_min_p(jnp.asarray(z), 0.05)))


def test_same_key_draws_same_token_whatever_the_batch():
    v = 300
    logits = _logits(7, v, seed=4, scale=0.5)     # flat: noise decides
    temps = torch.full((7,), 0.8)
    sids = torch.tensor([11, 12, 13, 14, 15, 16, 17])
    pos = torch.tensor([3, 9, 9, 40, 2, 5, 6])
    top_k = torch.tensor([0, 40, 0, 0, 3, 0, 0], dtype=torch.int32)
    top_p = torch.tensor([1.0, 0.9, 1.0, 0.7, 1.0, 1.0, 1.0])
    full = S.sample_per_row(S.fold_row_keys(5, sids, pos),
                            torch.tensor(logits), temps, top_k, top_p)
    for i in range(7):
        one = S.sample_per_row(S.fold_row_keys(5, sids[i:i + 1],
                                               pos[i:i + 1]),
                               torch.tensor(logits[i:i + 1]), temps[i:i + 1],
                               top_k[i:i + 1], top_p[i:i + 1])
        assert int(one[0]) == int(full[i])
    # the key is what matters: another position or seed draws afresh
    moved = S.sample_per_row(S.fold_row_keys(5, sids, pos + 1),
                             torch.tensor(logits), temps, top_k, top_p)
    reseeded = S.sample_per_row(S.fold_row_keys(6, sids, pos),
                                torch.tensor(logits), temps, top_k, top_p)
    assert not torch.equal(moved, full) and not torch.equal(reseeded, full)


def test_filters_on_flag_is_only_a_shortcut():
    logits = torch.tensor(_logits(4, 80, seed=8, scale=1.0))
    keys = S.fold_row_keys(1, torch.arange(4), torch.zeros(4))
    temps = torch.full((4,), 1.0)
    off_k = torch.zeros(4, dtype=torch.int32)
    off_p = torch.ones(4)
    a = S.sample_per_row(keys, logits, temps, off_k, off_p, filters_on=False)
    b = S.sample_per_row(keys, logits, temps, off_k, off_p, filters_on=True)
    c = S.sample_per_row(keys, logits, temps, off_k, off_p)
    assert torch.equal(a, b) and torch.equal(a, c)
    k1 = S.sample_per_row(keys, logits, torch.full((4,), 50.0),
                          torch.ones(4, dtype=torch.int32), off_p,
                          filters_on=True)
    assert torch.equal(k1, logits.argmax(-1).int())  # top_k=1 == greedy


def test_temperature_draws_follow_softmax_chi_square():
    """20000 draws at T=0.8 over 8 tokens (one key each) against
    softmax(z/T).  The noise is deterministic, so this cannot flake: it
    either always passes or always fails."""
    n, t = 20000, 0.8
    z = np.array([1.0, 0.5, 0.0, -0.5, 2.0, -1.0, 0.3, 1.2], np.float32)
    logits = torch.tensor(np.tile(z, (n, 1)))
    keys = S.fold_row_keys(123, torch.arange(n), torch.full((n,), 7))
    toks = S.sample_per_row(keys, logits, torch.full((n,), t)).numpy()
    counts = np.bincount(toks, minlength=len(z))
    p = np.exp(z / t - (z / t).max())
    p /= p.sum()
    _, pval = stats.chisquare(counts, n * p)
    assert pval > 1e-3, (counts, n * p)


def test_gumbel_noise_is_standard_gumbel():
    keys = S.fold_row_keys(9, torch.arange(64), torch.zeros(64))
    g = S.gumbel_rows(keys, 4096).double().numpy().ravel()
    assert abs(g.mean() - 0.5772) < 0.01          # Euler-Mascheroni
    assert abs(g.var() - np.pi ** 2 / 6) < 0.05
    assert np.isfinite(g).all()


def test_sample_with_sampler_config():
    logits = torch.tensor(_logits(3, 40, seed=2))
    greedy = S.sample(0, logits)
    assert torch.equal(greedy, logits.argmax(-1).int())
    hot_k1 = S.sample(0, logits, S.SamplerConfig(temperature=5.0, top_k=1))
    assert torch.equal(hot_k1, greedy)
    drawn = S.sample(0, logits[None], S.SamplerConfig(temperature=1.0,
                                                      top_p=0.9, min_p=0.01))
    assert drawn.shape == (1, 3) and ((drawn >= 0) & (drawn < 40)).all()


def test_fold_row_keys_layout():
    keys = S.fold_row_keys((7 << 32) | 5, torch.tensor([1, 2]),
                           torch.tensor([10, 20]))
    assert keys.dtype == torch.long
    assert keys.tolist() == [[5, 7, 1, 10], [5, 7, 2, 20]]
