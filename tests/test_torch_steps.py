"""The port's step bundles (``repro_torch.launch.steps``) against the
reference's (``repro.launch.steps``).

* Bundles: for every arch (reduced config) and a train, prefill and
  decode shape, the abstract arguments' shapes and dtypes (meta tensors
  against ``ShapeDtypeStruct`` s) and the in and out sharding specs equal
  the reference's leaf for leaf.  The reference is built in-process on
  ``make_host_mesh(1, 1)`` (one CPU device), the port in one gloo rank
  (a ``DeviceMesh`` needs a process group).
* Serving: the prefill bundle on a prompt, then greedy steps of the decode
  bundle, float32, on gloo ranks: heads split (1, 2), data split (2, 1),
  and a cache sequence-sharded on ``model`` decoding context-parallel
  (``decode_step(cp_mesh=...)``) on (1, 2) (one KV head) and (1, 4)
  (two), and without ``context_parallel`` on (1, 4) (each step gathers
  the layers' blocks).  Logits of the prefill and every step within 1e-4
  of the JAX ``prefill`` / ``decode_step`` (the reference's own CP
  tolerance) and greedy tokens identical.
* The sharded app: a prefill ``StepBundle`` loaded as a vFPGA app on a (2,
  1) mesh (weights through the sharded ``migrate_tree``, the build on the
  rank's shard shapes) gives the unsharded computation's logits.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import PartitionSpec

from repro.configs import ARCHS
from repro.configs import get_config as jget
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.launch.mesh import make_host_mesh as jmake_host_mesh
from repro.launch.steps import make_bundle as jmake_bundle
from repro.models import transformer as JT
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch.mesh import run_ranks

import _torch_mesh_train_ranks as R

RUN = dict(device="cpu", backend="gloo", timeout_s=60.0, deadline_s=120.0)
SHAPES = [("train", 32, 2), ("prefill", 32, 2), ("decode", 32, 2)]


def _flat(tree, prefix=""):
    if isinstance(tree, (PartitionSpec, jax.ShapeDtypeStruct)) or not \
            isinstance(tree, (dict, tuple, list)):
        return {prefix[:-1]: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_flat(v, f"{prefix}{k}/"))
    return out


@pytest.fixture(scope="module")
def port_bundles():
    shapes = [ShapeConfig(k, k, s, b) for k, s, b in SHAPES]
    return run_ranks(R.describe_bundles, 1, sorted(ARCHS), shapes, **RUN)[0]


@pytest.mark.parametrize("kind", [k for k, _, _ in SHAPES])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_bundle_args_and_shardings_equal_the_reference(port_bundles, arch,
                                                        kind):
    _, s, b = next(x for x in SHAPES if x[0] == kind)
    jb = jmake_bundle(jget(arch).reduced(), JShapeConfig(kind, kind, s, b),
                      jmake_host_mesh(1, 1))
    args, ins, outs, name, donate = port_bundles[(arch, kind)]
    ref_args = {k: (tuple(x.shape), str(x.dtype))
                for k, x in _flat(jb.abstract_args).items()}
    assert args == ref_args
    assert ins == {k: tuple(x.spec) for k, x in
                   _flat(jb.in_shardings).items()}
    assert outs == {k: tuple(x.spec) for k, x in
                    _flat(jb.out_shardings).items()}
    assert (name, donate) == (jb.name, jb.donate_argnums)


# ---------------------------------------------------------------- serving --
PROMPT = np.random.RandomState(7).randint(3, 500, size=(2, 16)).astype(
    np.int32)
N_DECODE = 8
SERVE = {   # name -> (config overrides, (data, model), context_parallel)
    "tp_heads_1x2": ({}, (1, 2), False),
    "data_2x1": ({}, (2, 1), False),
    "cp_1x2": ({"n_kv_heads": 1}, (1, 2), True),
    "cp_1x4": ({}, (1, 4), True),
    "seq_gather_1x4": ({}, (1, 4), False),
}


def _reference_serving(jcfg, params):
    logits, cache = JT.prefill(params, jcfg, jnp.asarray(PROMPT),
                               PROMPT.shape[1] + N_DECODE,
                               cache_dtype=jnp.float32)
    out = [np.asarray(logits)]
    pos = jnp.full((PROMPT.shape[0],), PROMPT.shape[1], jnp.int32)
    step = jax.jit(JT.decode_step, static_argnums=(1,))
    for _ in range(N_DECODE):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        logits, cache = step(params, jcfg, cache, tok, pos)
        out.append(np.asarray(logits))
        pos = pos + 1
    out = np.stack(out)
    return out, out.argmax(-1)


@pytest.mark.parametrize("case", sorted(SERVE))
def test_serving_bundles_match_the_reference(case):
    overrides, (data, model), cp = SERVE[case]
    jcfg = dataclasses.replace(jget("smollm-135m").reduced(), **overrides)
    params = JT.init_params(jax.random.PRNGKey(3), jcfg, dtype=jnp.float32)
    want, greedy = _reference_serving(jcfg, params)
    np_params = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    outs = run_ranks(R.serve_bundles, data * model, "smollm-135m", np_params,
                     overrides, (data, model), PROMPT, N_DECODE, cp, **RUN)
    for o in outs:
        assert o["cp"] == cp
        np.testing.assert_allclose(o["logits"], want, atol=1e-4)
        np.testing.assert_array_equal(o["greedy"], greedy)
    if model > 1:                   # the model split moved data
        assert any(op == "all-reduce" for op, _ in outs[0]["traffic"])


def test_step_bundle_runs_as_a_sharded_app():
    jcfg = jget("smollm-135m").reduced()
    params = JT.init_params(jax.random.PRNGKey(4), jcfg, dtype=jnp.float32)
    want, _ = JT.prefill(params, jcfg, jnp.asarray(PROMPT), PROMPT.shape[1],
                         cache_dtype=jnp.float32)
    np_params = jax.tree.map(lambda x: np.asarray(x, np.float32), params)
    outs = run_ranks(R.sharded_app, 2, "smollm-135m", np_params, PROMPT,
                     **RUN)
    got = np.concatenate([o["logits"] for o in outs])
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    for o in outs:
        assert o["built_on"] == (1, PROMPT.shape[1])     # its rows
        vocab = jcfg.padded_vocab
        assert o["embed_rows"] == (vocab // 2, jcfg.d_model)
        whole = sum(x.nbytes for x in jax.tree.leaves(np_params))
        assert o["hbm_used"] < whole
