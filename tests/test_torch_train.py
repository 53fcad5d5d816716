"""Port training path against the JAX reference, on the CPU.

Same weights (the reference's ``init_params`` converted with numpy) and
the same numpy data go through both packages: the loss and every
parameter's gradient of ``loss_fn`` on reduced smollm-135m and reduced
qwen2-72b (which carries ``qkv_bias``), and under each ``remat`` policy
on reduced smollm-135m, mamba2-1.3b and whisper-medium, AdamW's update
and schedule, the synthetic corpus, the on-disk checkpoint format, and a
few ``Trainer`` steps, with and without gradient compression.  Then the
port's twins of the reference's substrate tests
(``tests/test_substrate.py``): restart bit-identical (also with
compression's error feedback in the optimizer state), restore into a new
trainer, straggler skip, checkpoint roundtrip, retention, fingerprint and
atomicity.

Tolerances, float32: loss atol 1e-5 and gradients atol 2e-5 — the two
frameworks sum matrix products in other orders, which moves O(1) float32
results by ~1e-6 and sums of many such terms by a few times that; AdamW
states rtol 1e-5 (elementwise float32, bias corrections by ``pow``);
Trainer losses atol 1e-4 over 4 steps, where AdamW's m/sqrt(v) can turn a
last-bit difference of a near-zero gradient into a different update of
size lr.  With compression, each step's gradients entering it agree
within 2e-5 and its error feedback ``ef`` within 1e-5, except at the
elements whose int8 levels differ between the packages (the gradient sat
on a rounding tie, and a last-bit difference rounds the other way in one
package) or whose incoming residuals already differed.  Those differ by
at most one quantum of their block of 256 (the scale the quantizer takes
from the block's gradient plus residual), and they stay under 0.1% of
every leaf (at most 5 of a leaf's 32,768 on this case); the params end
within 2 lr a step, the most that a flipped rounding moves AdamW's update.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import get_config as jget
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.core.services.compression import \
    CompressionConfig as JCompressionConfig
from repro.core.services.compression import \
    GradCompression as JGradCompression
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticCorpus as JSyntheticCorpus
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import Trainer as JTrainer
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.services.compression import (CompressionConfig,
                                                   GradCompression)
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticCorpus
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.models.params import from_reference
from repro_torch.optim import adamw
from repro_torch.train.loop import SimulatedFailure, TrainConfig, Trainer

# small shapes: one intra-op thread is faster and leaves the cores to
# the other test workers
torch.set_num_threads(1)

ARCHS = ["smollm-135m", "qwen2-72b"]          # qwen2 carries qkv_bias


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in
            jadamw._flatten_with_path(tree).items()}


def _tokens(cfg, b, s, seed):
    return np.random.RandomState(seed).randint(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = jget(request.param).reduced()
    ref = _np_tree(JT.init_params(jax.random.PRNGKey(0), cfg,
                                  dtype=jnp.float32))
    if cfg.qkv_bias:           # reference init zeroes biases: exercise them
        rs = np.random.RandomState(5)
        for b in ("bq", "bk", "bv"):
            ref["layers"]["attn"][b] = rs.randn(
                *ref["layers"]["attn"][b].shape).astype(np.float32)
    return cfg, get_config(request.param).reduced(), ref


# ============================================================ model / loss ==
def test_forward_and_collected_kv_match_reference(model):
    jcfg, cfg, ref = model
    toks = _tokens(cfg, 2, 24, 1)
    jh, _, (jk, jv), _ = JT.forward(ref, jcfg, jnp.asarray(toks),
                                    collect_kv=True)
    h, aux, (k, v), rest = T.forward(from_reference(ref, device="cpu"), cfg,
                                     torch.tensor(toks), collect_kv=True)
    assert float(aux) == 0.0 and rest == (None, None, None)
    assert k.shape == (cfg.n_layers, 2, 24, cfg.n_kv_heads,
                       cfg.resolved_head_dim)
    for got, want in ((h, jh), (k, jk), (v, jv)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=1e-5)


def test_loss_and_every_gradient_match_value_and_grad(model):
    jcfg, cfg, ref = model
    toks = _tokens(cfg, 2, 32, 2)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, {"tokens": jnp.asarray(toks)}),
        has_aux=True)(jax.tree.map(jnp.asarray, ref))
    params = Trainer._trainable(from_reference(ref, device="cpu"))
    loss, metrics = T.loss_fn(params, cfg, {"tokens": torch.tensor(toks)})
    leaves = adamw.flatten(params)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    np.testing.assert_allclose(loss.item(), float(jl), atol=1e-5)
    assert float(metrics["tokens"]) == float(jm["tokens"]) == 2 * 31
    want = _flat_np(jg)
    assert set(grads) == set(want)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[path], atol=2e-5,
                                   err_msg=path)


@pytest.mark.parametrize("s_len", [256, 96, 40], ids=["s256", "s96", "s40"])
def test_xent_loss_chunking_matches_reference(s_len):
    """Chunks of 256 halved until they divide S, as the reference does."""
    cfg, jcfg = get_config("smollm-135m").reduced(), \
        jget("smollm-135m").reduced()
    rs = np.random.RandomState(s_len)
    table = rs.randn(cfg.padded_vocab, cfg.d_model).astype(np.float32) * 0.1
    hid = rs.randn(1, s_len, cfg.d_model).astype(np.float32)
    lab = rs.randint(0, cfg.vocab_size, (1, s_len)).astype(np.int32)
    mask = (rs.rand(1, s_len) > 0.2).astype(np.float32)
    jl, jn = JT.xent_loss({"embed": {"table": jnp.asarray(table)}}, jcfg,
                          jnp.asarray(hid), jnp.asarray(lab),
                          jnp.asarray(mask))
    tl, tn = T.xent_loss({"embed": {"table": torch.tensor(table)}}, cfg,
                         torch.tensor(hid), torch.tensor(lab),
                         torch.tensor(mask))
    np.testing.assert_allclose(tl.item(), float(jl), atol=1e-5)
    assert tn.item() == float(jn)


REMAT_ARCHS = ["smollm-135m", "mamba2-1.3b", "whisper-medium"]
REMATS = ["none", "full", "dots"]


def _remat_case(arch):
    jcfg = jget(arch).reduced()
    ref = _np_tree(JT.init_params(jax.random.PRNGKey(1), jcfg,
                                  dtype=jnp.float32))
    rs = np.random.RandomState(7)
    batch = {"tokens": rs.randint(0, jcfg.vocab_size,
                                  (2, 32)).astype(np.int32)}
    if jcfg.n_encoder_layers:
        batch["frames"] = rs.randn(2, jcfg.encoder_seq_len,
                                   jcfg.d_model).astype(np.float32)
    return jcfg, get_config(arch).reduced(), ref, batch


def _port_loss_and_grads(ref, cfg, batch, remat):
    params = Trainer._trainable(from_reference(ref, device="cpu"))
    loss, _ = T.loss_fn(params, cfg, {k: torch.as_tensor(v)
                                      for k, v in batch.items()},
                        remat=remat)
    leaves = adamw.flatten(params)
    return loss, dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()))))


@pytest.mark.parametrize("remat", REMATS)
@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_loss_fn_under_remat_matches_reference(arch, remat):
    """``loss_fn(remat=r)``'s loss and every gradient against the JAX
    ``loss_fn(remat=r)`` (``jax.checkpoint`` with the reference's policy)."""
    jcfg, cfg, ref, batch = _remat_case(arch)
    (jl, _), jg = jax.value_and_grad(
        lambda p: JT.loss_fn(p, jcfg, {k: jnp.asarray(v)
                                       for k, v in batch.items()},
                             remat=remat),
        has_aux=True)(jax.tree.map(jnp.asarray, ref))
    loss, grads = _port_loss_and_grads(ref, cfg, batch, remat)
    np.testing.assert_allclose(loss.item(), float(jl), atol=1e-5)
    want = _flat_np(jg)
    assert set(grads) == set(want)
    for path, g in grads.items():
        np.testing.assert_allclose(g.numpy(), want[path], atol=2e-5,
                                   err_msg=path)


@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_changes_no_value(arch):
    """Recomputation moves no number: the loss and every gradient under
    "full" and "dots" equal those of "none" bit for bit (on the CPU the
    recomputed products are the same products)."""
    _, cfg, ref, batch = _remat_case(arch)
    base_loss, base = _port_loss_and_grads(ref, cfg, batch, "none")
    for remat in ("full", "dots"):
        loss, grads = _port_loss_and_grads(ref, cfg, batch, remat)
        assert torch.equal(loss, base_loss), remat
        for path, g in grads.items():
            assert torch.equal(g, base[path]), (remat, path)


# ============================================================== optimizer ===
def test_adamw_update_matches_reference_over_three_steps():
    """Warmup (2 steps) into the cosine, clipping on, decayed and no-decay
    paths (norm scale, a bias, a plain matrix)."""
    rs = np.random.RandomState(0)
    tree = {"layers": {"norm1": {"scale": rs.randn(8)},
                       "attn": {"wq": rs.randn(8, 4), "bq": rs.randn(4)}},
            "head": {"bias": rs.randn(3)}, "w": rs.randn(5, 5)}
    tree = jax.tree.map(lambda x: x.astype(np.float32), tree)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=2.0)
    jp, jst = jax.tree.map(jnp.asarray, tree), jadamw.init(tree)
    tp = from_reference(tree, device="cpu")
    tst = adamw.init(tp)
    for i in range(3):
        g = jax.tree.map(lambda x: rs.randn(*x.shape).astype(np.float32)
                         * (3.0 if i == 1 else 0.1), tree)
        jp, jst, jm = jadamw.update(jax.tree.map(jnp.asarray, g), jst, jp,
                                    jadamw.AdamWConfig(**cfg))
        tp, tst, tm = adamw.update(from_reference(g, device="cpu"), tst, tp,
                                   adamw.AdamWConfig(**cfg))
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)
        for got, want in ((tp, jp), (tst["m"], jst["m"]),
                          (tst["v"], jst["v"])):
            want = _flat_np(want)
            for path, t in adamw.flatten(got).items():
                np.testing.assert_allclose(t.numpy(), want[path], rtol=1e-5,
                                           atol=1e-7, err_msg=path)
        assert int(tst["step"]) == int(jst["step"]) == i + 1


def test_schedule_matches_reference():
    cfg = dict(lr=3e-4, warmup_steps=100, total_steps=1000, min_lr_frac=0.1)
    for step in (0, 1, 50, 99, 100, 101, 550, 999, 1000, 5000):
        want = float(jadamw.schedule(jadamw.AdamWConfig(**cfg),
                                     jnp.int32(step)))
        got = float(adamw.schedule(adamw.AdamWConfig(**cfg), step))
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=str(step))


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0], requires_grad=True)}
    opt = adamw.init(params)
    cfg = adamw.AdamWConfig(lr=0.2, weight_decay=0.0, warmup_steps=0,
                            total_steps=200)
    for _ in range(150):
        g, = torch.autograd.grad((params["w"] ** 2).sum(), params["w"])
        params, opt, _ = adamw.update({"w": g}, opt, params, cfg)
    assert float(params["w"].detach().abs().max()) < 0.05


def test_adamw_clips_global_norm():
    params = {"w": torch.zeros(4)}
    opt = adamw.init(params)
    cfg = adamw.AdamWConfig(lr=1e-3, clip_norm=1.0)
    _, _, m = adamw.update({"w": torch.full((4,), 1e6)}, opt, params, cfg)
    assert float(m["grad_norm"]) > 1e6 - 1     # reported pre-clip


# =================================================================== data ===
@pytest.mark.parametrize("kw", [dict(seq_len=64, global_batch=2,
                                     vocab_size=1000, seed=3),
                                dict(seq_len=300, global_batch=3,
                                     vocab_size=49152, seed=0,
                                     mean_doc_len=40),
                                dict(seq_len=16, global_batch=2,
                                     vocab_size=512, seed=7,
                                     with_frames=True, frame_len=4,
                                     d_model=8)],
                         ids=["small", "smollm-vocab", "frames"])
def test_corpus_batches_equal_the_reference(kw):
    mine, ref = SyntheticCorpus(DataConfig(**kw)), \
        JSyntheticCorpus(JDataConfig(**kw))
    for step in (0, 5, 17, 123456):
        a, b = mine.batch(step), ref.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(mine.batch(0)["tokens"],
                              mine.batch(1)["tokens"])


def test_prefetcher_stages_batches_in_order_on_the_device():
    corpus = SyntheticCorpus(DataConfig(seq_len=8, global_batch=2,
                                        vocab_size=100, seed=1))
    pf = Prefetcher(corpus, start_step=3, device="cpu")
    try:
        for step in (3, 4, 5):
            got_step, batch = pf.get(timeout=10)
            assert got_step == step
            assert batch["tokens"].dtype == torch.int32
            np.testing.assert_array_equal(batch["tokens"].numpy(),
                                          corpus.batch(step)["tokens"])
    finally:
        pf.stop()
    assert not pf._thread.is_alive()


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    corpus = SyntheticCorpus(DataConfig(seq_len=8, global_batch=1,
                                        vocab_size=100))
    with pytest.raises(RuntimeError, match="CUDA"):
        Prefetcher(corpus)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(get_config("smollm-135m").reduced(),
                ShapeConfig("t", "train", 8, 1), TrainConfig(ckpt_every=0))


# ============================================================= checkpoint ===
def test_checkpoint_roundtrip_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    state = {"a": torch.arange(8.0), "n": {"b": torch.ones(3, 3),
                                           "h": torch.ones(2).bfloat16()}}
    for step in (10, 20, 30):
        mgr.save(step, {"a": state["a"] + step,
                        "n": {"b": state["n"]["b"] * step,
                              "h": state["n"]["h"] * step}})
    assert mgr.all_steps() == [20, 30]            # retention
    restored, at = mgr.restore(state)
    assert at == 30
    np.testing.assert_allclose(restored["a"].numpy(), np.arange(8.0) + 30)
    assert restored["n"]["h"].dtype == torch.bfloat16
    assert restored["n"]["h"].tolist() == [30.0, 30.0]


def test_checkpoint_fingerprint_mismatch(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(1, {"a": torch.zeros(2)}, fingerprint="modelA")
    with pytest.raises(ValueError, match="fingerprint"):
        mgr.restore({"a": torch.zeros(2)}, expect_fingerprint="modelB")


def test_checkpoint_atomicity_no_partial_dirs(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(5, {"a": torch.zeros(256, 256)})
    mgr.wait()
    assert not list(tmp_path.glob(".tmp_*"))
    assert mgr.all_steps() == [5]


def test_async_checkpoint_holds_the_state_of_its_step(tmp_path,
                                                      monkeypatch):
    """An asynchronous save holds the state as it was when ``save``
    returned, though the caller goes on to update the tensors in place
    (as ``adamw.update`` does) while the writer runs.  On the CPU
    ``.cpu().numpy()`` shares the live storage, so the snapshot must be a
    copy; a slow writer (as under a loaded test run) shows it."""
    import repro_torch.checkpoint.manager as mgr_mod
    save = mgr_mod.np.save
    go = __import__("threading").Event()

    class SlowNp:
        def __getattr__(self, name):
            return getattr(np, name)

        @staticmethod
        def save(*a, **k):
            go.wait(5.0)                # the step's update lands first
            return save(*a, **k)

    monkeypatch.setattr(mgr_mod, "np", SlowNp())
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    p = torch.arange(6.0)
    h = torch.ones(3).bfloat16()
    mgr.save(4, {"p": p, "h": h})
    with torch.no_grad():
        p.copy_(p * 10 + 1)
        h.copy_(h * 3)
    go.set()
    got, at = mgr.restore({"p": torch.zeros(6), "h": h})
    assert at == 4
    assert torch.equal(got["p"], torch.arange(6.0))
    assert torch.equal(got["h"], torch.ones(3).bfloat16())


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_between_the_packages(tmp_path, writer):
    """Same layout on disk: each package restores the other's files."""
    rs = np.random.RandomState(4)
    state = {"params": {"embed": {"table": rs.randn(6, 4)},
                        "layers": {"attn": {"wq": rs.randn(2, 4, 4)}}},
             "step": np.int32(7)}
    state = jax.tree.map(lambda x: np.asarray(x, (
        np.int32 if np.asarray(x).dtype == np.int32 else np.float32)), state)
    if writer == "reference":
        JCheckpointManager(str(tmp_path), async_save=False).save(
            7, jax.tree.map(jnp.asarray, state), fingerprint="f")
        like = jax.tree.map(lambda x: torch.zeros(x.shape, dtype=(
            torch.int32 if x.dtype == np.int32 else torch.float32)), state)
        got, at = CheckpointManager(str(tmp_path)).restore(
            like, expect_fingerprint="f")
        got = jax.tree.map(lambda t: t.numpy(), got)
    else:
        CheckpointManager(str(tmp_path), async_save=False).save(
            7, jax.tree.map(torch.tensor, state), fingerprint="f")
        got, at = JCheckpointManager(str(tmp_path)).restore(
            jax.tree.map(jnp.asarray, state), expect_fingerprint="f")
    assert at == 7
    for path, want in _flat_np(state).items():
        np.testing.assert_array_equal(np.asarray(_flat_np(got)[path]), want)


# ================================================================ trainer ====
@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("smollm-135m").reduced()
    shape = ShapeConfig("t", "train", 32, 2)
    return cfg, shape


def test_trainer_losses_track_the_reference_trainer(tmp_path):
    """4 steps from the same weights and data: the port's losses, learning
    rates and gradient norms track the JAX Trainer's."""
    jcfg, cfg = jget("smollm-135m").reduced(), get_config(
        "smollm-135m").reduced()
    kw = dict(steps=4, log_every=1, ckpt_every=0, seed=2)
    jt = JTrainer(jcfg, JShapeConfig("t", "train", 32, 2),
                  JTrainConfig(ckpt_dir=str(tmp_path / "j"), **kw))
    pt = Trainer(cfg, ShapeConfig("t", "train", 32, 2),
                 TrainConfig(ckpt_dir=str(tmp_path / "p"), **kw),
                 device="cpu")
    pt.params = Trainer._trainable(from_reference(_np_tree(jt.params),
                                                  device="cpu"))
    pt.opt_state = adamw.init(pt.params)
    jt.run()
    pt.run()
    assert [m["step"] for m in pt.metrics_log] == [1, 2, 3, 4]
    for mine, ref in zip(pt.metrics_log, jt.metrics_log):
        np.testing.assert_allclose(mine["loss"], ref["loss"], atol=1e-4)
        np.testing.assert_allclose(mine["lr"], ref["lr"], rtol=1e-6)
        np.testing.assert_allclose(mine["grad_norm"], ref["grad_norm"],
                                   rtol=1e-4)


def _compression():
    return GradCompression(CompressionConfig(bits=8, error_feedback=True))


class _RecordedCompression(GradCompression):
    """The port's int8 compression with error feedback, keeping each
    step's gradients and incoming residuals ``{path: (g, ef)}`` (flat)."""

    def __init__(self):
        super().__init__(CompressionConfig(bits=8, error_feedback=True))
        self.steps = []

    def apply(self, grads, state):
        ef = adamw.flatten(state)
        self.steps.append({
            path: (g.detach().float().reshape(-1).numpy().copy(),
                   ef[path].reshape(-1).numpy().copy())
            for path, g in adamw.flatten(grads).items()})
        return super().apply(grads, state)


class _JRecordedCompression(JGradCompression):
    """The reference's, keeping the same from inside its jitted step."""

    def __init__(self):
        super().__init__(JCompressionConfig(bits=8, error_feedback=True))
        self.steps = []

    def apply(self, grads, state):
        g = jadamw._flatten_with_path(grads)
        ef = jadamw._flatten_with_path(state)
        jax.debug.callback(self._record, {
            path: (g[path].astype(jnp.float32).reshape(-1),
                   ef[path].reshape(-1)) for path in g})
        return super().apply(grads, state)

    def _record(self, leaves):
        self.steps.append({path: (np.asarray(g), np.asarray(e))
                           for path, (g, e) in leaves.items()})


def _int8_levels(x, block=256, qmax=127):
    """The quantizer's integer levels of x (flat float32) and the quantum
    (scale) of each element's block: max |x| of the block / 127."""
    n = x.size
    xb = np.pad(x, (0, (-n) % block)).reshape(-1, block)
    scale = np.maximum(np.abs(xb).max(1, keepdims=True) / np.float32(qmax),
                       np.float32(1e-12))
    levels = np.clip(np.round(xb / scale), -qmax, qmax)
    return levels.reshape(-1)[:n], np.repeat(scale[:, 0], block)[:n]


def _assert_compression_step_close(mine, ref, ef_mine, ef_ref):
    """One step of compression in both packages: the gradients entering it
    agree within 2e-5, and the residuals leaving it within 1e-5, except at
    elements whose levels differ between the packages (a rounding tie of
    the gradients) or whose incoming residuals already differed; those
    stay within one quantum of their block and under 0.1% of their leaf
    (module docstring)."""
    assert set(mine) == set(ref) == set(ef_mine) == set(ef_ref)
    for path, (g, e) in mine.items():
        gj, ej = ref[path]
        np.testing.assert_allclose(g, gj, atol=2e-5, err_msg=path)
        levels, quantum = _int8_levels(g + e)
        explained = (levels != _int8_levels(gj + ej)[0]) | (
            np.abs(e - ej) > 1e-5)
        diff = np.abs(np.asarray(ef_mine[path]).reshape(-1)
                      - np.asarray(ef_ref[path]).reshape(-1))
        far = diff > 1e-5
        assert not (far & ~explained).any(), (path, np.flatnonzero(
            far & ~explained)[:8], diff[far & ~explained][:8])
        assert (diff[far] <= quantum[far] + 1e-5).all(), path
        assert far.sum() <= g.size // 1000, (path, int(far.sum()), g.size)


def test_trainer_with_compression_tracks_the_reference_trainer(tmp_path):
    """3 steps with int8 compression and error feedback, from the same
    weights and data: the losses track the JAX Trainer's, so do the
    gradients entering compression and the ``ef`` state it keeps in the
    optimizer state at every step, and so do the params at the end."""
    jcfg, cfg = jget("smollm-135m").reduced(), get_config(
        "smollm-135m").reduced()
    kw = dict(steps=3, log_every=1, ckpt_every=0, seed=2)
    jcomp = _JRecordedCompression()
    jt = JTrainer(jcfg, JShapeConfig("t", "train", 32, 2), JTrainConfig(
        ckpt_dir=str(tmp_path / "j"), compression=jcomp, **kw))
    comp = _RecordedCompression()
    pt = Trainer(cfg, ShapeConfig("t", "train", 32, 2),
                 TrainConfig(ckpt_dir=str(tmp_path / "p"), compression=comp,
                             **kw), device="cpu")
    assert set(adamw.flatten(pt.opt_state["ef"])) == set(
        adamw.flatten(pt.params))
    pt.params = Trainer._trainable(from_reference(_np_tree(jt.params),
                                                  device="cpu"))
    pt.opt_state = adamw.init(pt.params)
    pt.opt_state["ef"] = comp.init_state(pt.params)
    jt.run()
    pt.run()
    assert [m["step"] for m in pt.metrics_log] == [1, 2, 3]
    for mine, ref in zip(pt.metrics_log, jt.metrics_log):
        np.testing.assert_allclose(mine["loss"], ref["loss"], atol=1e-4)
    assert len(comp.steps) == len(jcomp.steps) == 3
    want = _flat_np(jt.opt_state["ef"])
    assert any(np.abs(w).max() > 0 for w in want.values())
    ef_out = [({k: e for k, (_, e) in comp.steps[i].items()},
               {k: e for k, (_, e) in jcomp.steps[i].items()})
              for i in (1, 2)]
    ef_out.append((adamw.flatten(pt.opt_state["ef"]), want))
    for i, (ef_mine, ef_ref) in enumerate(ef_out):
        _assert_compression_step_close(comp.steps[i], jcomp.steps[i],
                                       ef_mine, ef_ref)
    # a rounding that flips changes one element's AdamW update by at most
    # 2 lr a step (its sign), as on the card (chip_smoke.py phase 6)
    bound = 2 * sum(m["lr"] for m in pt.metrics_log) + 1e-6
    params = _flat_np(jt.params)
    for path, p in adamw.flatten(pt.params).items():
        np.testing.assert_allclose(p.detach().numpy(), params[path],
                                   atol=bound, err_msg=path)


# The restart tests are about restarts: a batch that the loaded test run's
# prefetch thread takes past the default 5 s would be logged as a straggler
# skip (test_trainer_straggler_skip covers those), so they wait longer.
_NO_SKIP_S = 120.0


def test_trainer_restart_bit_identical_with_compression(tiny, tmp_path):
    """An injected failure restores ``ef`` with the rest of the optimizer
    state: the run ends bit-identical to an uninterrupted one."""
    cfg, shape = tiny
    kw = dict(steps=8, log_every=2, ckpt_every=4, seed=11,
              batch_timeout_s=_NO_SKIP_S)
    runs = []
    for name, fail in (("a", -1), ("b", 6)):
        t = Trainer(cfg, shape, TrainConfig(
            ckpt_dir=str(tmp_path / name), fail_at_step=fail,
            compression=_compression(), **kw), device="cpu")
        runs.append((t, t.run()))
    (t1, r1), (t2, r2) = runs
    assert r1["skipped_steps"] == r2["skipped_steps"] == []
    assert (r1["restarts"], r2["restarts"]) == (0, 1)
    assert r1["final_loss"] == r2["final_loss"]
    for tree in ("params", "ef"):
        a = adamw.flatten(t1.params if tree == "params"
                          else t1.opt_state["ef"])
        b = adamw.flatten(t2.params if tree == "params"
                          else t2.opt_state["ef"])
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), (tree, k)


def test_trainer_restart_bit_identical(tiny, tmp_path):
    """A failure at step 6 restores the asynchronous checkpoint of step 4
    (written while steps 5 and 6 update the parameters in place) and ends
    bit-identical to an uninterrupted run."""
    cfg, shape = tiny
    kw = dict(steps=8, log_every=2, ckpt_every=4, seed=11,
              batch_timeout_s=_NO_SKIP_S)
    t1 = Trainer(cfg, shape, TrainConfig(ckpt_dir=str(tmp_path / "a"), **kw),
                 device="cpu")
    r1 = t1.run()
    t2 = Trainer(cfg, shape, TrainConfig(ckpt_dir=str(tmp_path / "b"),
                                         fail_at_step=6, **kw), device="cpu")
    r2 = t2.run()
    assert r1["skipped_steps"] == r2["skipped_steps"] == []
    assert (r1["restarts"], r2["restarts"]) == (0, 1)
    assert r1["final_loss"] == r2["final_loss"]   # bitwise identical
    for a, b in zip(adamw.flatten(t1.params).values(),
                    adamw.flatten(t2.params).values()):
        assert torch.equal(a, b)


def test_trainer_elastic_restore_across_instances(tiny, tmp_path):
    """A NEW trainer restores the old checkpoint (same topology, fresh
    instance) and carries on from its step."""
    cfg, shape = tiny
    d = str(tmp_path / "c")
    t1 = Trainer(cfg, shape, TrainConfig(steps=4, ckpt_every=4, seed=11,
                                         ckpt_dir=d), device="cpu")
    t1.run()
    t2 = Trainer(cfg, shape, TrainConfig(steps=8, ckpt_every=8, seed=11,
                                         ckpt_dir=d), device="cpu")
    t2.restore()
    assert t2.step == 4
    for a, b in zip(adamw.flatten(t1.params).values(),
                    adamw.flatten(t2.params).values()):
        assert torch.equal(a, b) and b.requires_grad
    t2.prefetch.stop()
    t2._start_prefetch(t2.step)
    assert t2.run()["final_step"] == 8


def test_trainer_straggler_skip(tiny, tmp_path):
    cfg, shape = tiny
    t = Trainer(cfg, shape, TrainConfig(
        steps=4, ckpt_every=0, seed=1, ckpt_dir=str(tmp_path / "d"),
        straggler_steps=(2, 3), straggler_delay_s=3.0,
        batch_timeout_s=0.05), device="cpu")
    r = t.run()
    assert r["final_step"] == 4
    assert len(r["skipped_steps"]) >= 1           # waited-out straggler


def test_trainer_restarts_on_a_fault_plan(tiny, tmp_path):
    from repro_torch.core.faults import FaultKind, FaultPlan
    cfg, shape = tiny
    plan = FaultPlan.single(FaultKind.NODE_FAILURE, after=3)
    t = Trainer(cfg, shape, TrainConfig(
        steps=5, ckpt_every=2, seed=1, ckpt_dir=str(tmp_path / "e"),
        fault_plan=plan), device="cpu")
    r = t.run()
    assert (r["restarts"], r["final_step"]) == (1, 5)
    assert plan.exhausted()
    assert isinstance(SimulatedFailure("x"), RuntimeError)


@pytest.mark.parametrize("change", [dict(microbatches=2)],
                         ids=["microbatches"])
def test_trainer_levers_of_later_slices_raise(tiny, tmp_path, change):
    cfg, shape = tiny
    with pytest.raises(NotImplementedError):
        Trainer(cfg, shape, TrainConfig(ckpt_dir=str(tmp_path), **change),
                device="cpu")


def test_trainer_steps_the_hybrid_and_restarts_bit_identical(tmp_path):
    """Reduced zamba2: the ``slots`` tuple and ``shared_attn`` go through
    ``adamw.flatten`` and the checkpoint and come back the same tree, and a
    run with an injected failure ends bit-identical to an uninterrupted
    one."""
    cfg = get_config("zamba2-2.7b").reduced()
    shape = ShapeConfig("t", "train", 32, 2)
    kw = dict(steps=4, log_every=1, ckpt_every=2, seed=3,
              batch_timeout_s=_NO_SKIP_S)
    runs = []
    for name, fail in (("a", -1), ("b", 3)):
        t = Trainer(cfg, shape, TrainConfig(ckpt_dir=str(tmp_path / name),
                                            fail_at_step=fail, **kw),
                    device="cpu")
        runs.append((t, t.run()))
    (t1, r1), (t2, r2) = runs
    assert r1["skipped_steps"] == r2["skipped_steps"] == []
    assert (r1["restarts"], r2["restarts"]) == (0, 1)
    assert np.isfinite(r1["final_loss"])
    assert r1["final_loss"] == r2["final_loss"]
    assert isinstance(t1.params["slots"], tuple)
    assert len(t1.params["slots"]) == sum(
        k != "shared_attn" for k in cfg.block_pattern)
    assert "shared_attn" in t1.params
    for tree in ("params", "m", "v"):
        a, b = ((t.params if tree == "params" else t.opt_state[tree])
                for t in (t1, t2))
        a, b = adamw.flatten(a), adamw.flatten(b)
        assert list(a) == list(b)
        for k in a:
            assert torch.equal(a[k], b[k]), (tree, k)
    back = adamw.unflatten(adamw.flatten(t1.params))
    assert isinstance(back["slots"], tuple)
    assert list(adamw.flatten(back)) == list(adamw.flatten(t1.params))


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "zamba2-2.7b",
                                  "granite-moe-1b-a400m"])
def test_ssm_hybrid_and_moe_trainer_losses_track_the_reference(arch,
                                                               tmp_path):
    """3 steps from the same weights and data: the port's Trainer on
    reduced mamba2 (the SSD scan's backward), the zamba2 hybrid and
    granite's MoE (its aux loss in the loss) tracks the JAX Trainer's
    losses, learning rates and gradient norms, as
    ``test_trainer_losses_track_the_reference_trainer``."""
    jcfg, cfg = jget(arch).reduced(), get_config(arch).reduced()
    kw = dict(steps=3, log_every=1, ckpt_every=0, seed=2)
    jt = JTrainer(jcfg, JShapeConfig("t", "train", 32, 2),
                  JTrainConfig(ckpt_dir=str(tmp_path / "j"), **kw))
    pt = Trainer(cfg, ShapeConfig("t", "train", 32, 2),
                 TrainConfig(ckpt_dir=str(tmp_path / "p"), **kw),
                 device="cpu")
    pt.params = Trainer._trainable(from_reference(_np_tree(jt.params),
                                                  device="cpu"))
    pt.opt_state = adamw.init(pt.params)
    jt.run()
    pt.run()
    assert [m["step"] for m in pt.metrics_log] == [1, 2, 3]
    for mine, ref in zip(pt.metrics_log, jt.metrics_log):
        np.testing.assert_allclose(mine["loss"], ref["loss"], atol=1e-4)
        np.testing.assert_allclose(mine["lr"], ref["lr"], rtol=1e-6)
        np.testing.assert_allclose(mine["grad_norm"], ref["grad_norm"],
                                   rtol=1e-4)


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    assert launch_train.main([
        "--reduced", "--steps", "2", "--seq-len", "16", "--batch", "2",
        "--ckpt-every", "2", "--ckpt-dir", str(tmp_path), "--device",
        "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["result"]["final_step"] == 2
    assert np.isfinite(out["result"]["final_loss"])
    assert launch_train.main([
        "--reduced", "--steps", "2", "--seq-len", "16", "--batch", "2",
        "--compress", "--remat", "dots", "--ckpt-every", "0",
        "--ckpt-dir", str(tmp_path / "c"), "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["result"]["final_step"] == 2
    assert np.isfinite(out["result"]["final_loss"])
