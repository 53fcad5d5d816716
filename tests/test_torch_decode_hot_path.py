"""``write_prefill`` and ``prefill_paged`` of the port's paged model
against the reference's (twin of ``tests/test_decode_hot_path.py``'s
drop-mode scatter test).  The port's pools carry one extra trailing
sink slot: every write the reference drops lands there, so the port's
``pools[:-1]`` must equal the reference's pools.  Tolerances: the
scatter is exact (the same values are written); prefill KV and pools
atol 1e-5 (fp32, two frameworks' matmuls), first greedy tokens
identical.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import transformer as JT
from repro.serve import paged_model as JP
from repro_torch.configs import get_config
from repro_torch.models.params import from_reference
from repro_torch.serve import paged_model as P

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def served():
    jcfg = jget("smollm-135m").reduced()
    jparams = JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    params = from_reference(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, get_config("smollm-135m").reduced(), params


def _pools_with_sink(ref_pools):
    """The reference's pools plus the port's sink slot (zeros)."""
    return {s: torch.cat([torch.as_tensor(np.array(p)),
                          torch.zeros((1,) + p.shape[1:])])
            for s, p in ref_pools.items()}


@pytest.mark.parametrize("lens", [(10, 3), (0, 12), (16, 16)],
                         ids=["mixed", "empty-row", "full"])
def test_write_prefill_drops_invalid_writes(served, lens):
    cfg = served[2]
    n_pages, page, b, s = 8, 4, 2, max(lens)
    hd, kh, L = cfg.resolved_head_dim, cfg.n_kv_heads, cfg.n_layers
    sentinel = 7.5
    jpools = {k: jnp.full((L * n_pages, page, kh, hd), sentinel)
              for k in ("k", "v")}
    ks = np.random.RandomState(0).standard_normal(
        (L, b, s, kh, hd)).astype(np.float32)
    vs = ks + 1.0
    tables = np.asarray([[2, 5, 1, -1], [6, -1, 3, 0]], np.int32)
    want = JP.write_prefill(jpools, (jnp.asarray(ks), jnp.asarray(vs)),
                            jnp.asarray(tables), jnp.asarray(lens), page)
    pools = _pools_with_sink(jpools)
    got = P.write_prefill(pools, (torch.as_tensor(ks), torch.as_tensor(vs)),
                          torch.as_tensor(tables), torch.as_tensor(lens),
                          page)
    assert got is pools                      # written in place
    for side in ("k", "v"):
        np.testing.assert_array_equal(got[side][:-1].numpy(),
                                      np.asarray(want[side]))
    # the reference test's own pins, on the port's pools
    outk = got["k"][:-1].numpy().reshape(L, n_pages, page, kh, hd)
    if lens == (10, 3):
        np.testing.assert_array_equal(outk[:, 2], ks[:, 0, 0:4])
        np.testing.assert_array_equal(outk[:, 1, :2], ks[:, 0, 8:10])
        assert (outk[:, 1, 2:] == sentinel).all()
        for pg in (0, 3, 4, 7):
            assert (outk[:, pg] == sentinel).all(), f"page {pg} clobbered"


def test_prefill_paged_matches_reference(served):
    """One padded forward for a batch: the pools the reference writes
    and its greedy first tokens; padding rows write nothing."""
    jcfg, jparams, cfg, params = served
    page, n_pages, maxp = 8, 32, 6
    rs = np.random.RandomState(1)
    lens = np.asarray([13, 40, 0, 7], np.int32)        # row 2: padding
    tokens = rs.randint(0, cfg.vocab_size, size=(4, 40)).astype(np.int32)
    tables = np.full((4, maxp), -1, np.int32)
    perm = rs.permutation(n_pages)
    tables[0, :2], tables[1, :5], tables[3, :1] = perm[:2], perm[2:7], \
        perm[7:8]
    temps = np.zeros(4, np.float32)
    jpools = JP.make_pools(jcfg, n_pages, page)
    first_j, jpools, _ = JP.prefill_paged(
        jparams, jpools, jnp.asarray(tokens), jnp.asarray(lens),
        jnp.asarray(tables), jax.random.PRNGKey(0), jnp.asarray(temps),
        cfg=jcfg, page_size=page)
    pools = P.make_pools(cfg, n_pages, page, device="cpu")
    first = P.prefill_paged(params, pools, torch.as_tensor(tokens),
                            torch.as_tensor(lens), torch.as_tensor(tables),
                            0, torch.as_tensor(temps), cfg=cfg,
                            page_size=page)
    live = lens > 0
    np.testing.assert_array_equal(first.numpy()[live],
                                  np.asarray(first_j)[live])
    for side in ("k", "v"):
        np.testing.assert_allclose(pools[side][:-1].numpy(),
                                   np.asarray(jpools[side]), atol=1e-5)
    # the same prompts through the suffix-prefill path the engine runs
    pools2 = P.make_pools(cfg, n_pages, page, device="cpu")
    zero = torch.zeros(4, dtype=torch.int32)
    first2 = P.prefill_shared_paged(
        params, pools2, torch.as_tensor(tokens), torch.as_tensor(lens),
        zero, zero, torch.as_tensor(tables), 0, torch.as_tensor(temps),
        cfg=cfg, page_size=page)
    np.testing.assert_array_equal(first2.numpy()[live], first.numpy()[live])
    for side in ("k", "v"):
        np.testing.assert_allclose(pools2[side][:-1].numpy(),
                                   pools[side][:-1].numpy(), atol=1e-5)
