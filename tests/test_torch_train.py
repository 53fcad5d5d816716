"""Port training path against the JAX reference, on the CPU.

Same weights (the reference's ``init_params`` converted with numpy) and
the same numpy data go through both packages: the loss and every
parameter's gradient of ``loss_fn`` on reduced smollm-135m and reduced
qwen2-72b (which carries ``qkv_bias``), AdamW's update and schedule, the
synthetic corpus, the on-disk checkpoint format, and a few ``Trainer``
steps.  Then the port's twins of the reference's substrate tests
(``tests/test_substrate.py``): restart bit-identical, restore into a new
trainer, straggler skip, checkpoint roundtrip, retention, fingerprint and
atomicity.

Tolerances, float32: loss atol 1e-5 and gradients atol 2e-5 — the two
frameworks sum matrix products in other orders, which moves O(1) float32
results by ~1e-6 and sums of many such terms by a few times that; AdamW
states rtol 1e-5 (elementwise float32, bias corrections by ``pow``);
Trainer losses atol 1e-4 over 4 steps, where AdamW's m/sqrt(v) can turn a
last-bit difference of a near-zero gradient into a different update of
size lr.
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
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticCorpus as JSyntheticCorpus
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import Trainer as JTrainer
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
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


@pytest.mark.parametrize("arch", ["whisper-medium"])
def test_forward_raises_for_models_of_later_slices(arch):
    cfg = get_config(arch).reduced()
    with pytest.raises(NotImplementedError):
        T.forward({}, cfg, torch.zeros(1, 4, dtype=torch.int32))


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


def test_trainer_restart_bit_identical(tiny, tmp_path):
    cfg, shape = tiny
    kw = dict(steps=8, log_every=2, ckpt_every=4, seed=11)
    t1 = Trainer(cfg, shape, TrainConfig(ckpt_dir=str(tmp_path / "a"), **kw),
                 device="cpu")
    r1 = t1.run()
    t2 = Trainer(cfg, shape, TrainConfig(ckpt_dir=str(tmp_path / "b"),
                                         fail_at_step=6, **kw), device="cpu")
    r2 = t2.run()
    assert r2["restarts"] == 1
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


@pytest.mark.parametrize("change", [
    dict(remat="full"), dict(microbatches=2), dict(compression=object())],
    ids=["remat", "microbatches", "compression"])
def test_trainer_levers_of_later_slices_raise(tiny, tmp_path, change):
    cfg, shape = tiny
    with pytest.raises(NotImplementedError):
        Trainer(cfg, shape, TrainConfig(ckpt_dir=str(tmp_path), **change),
                device="cpu")


def test_trainer_refuses_the_hybrid_until_its_slice(tmp_path):
    cfg = get_config("zamba2-2.7b").reduced()
    with pytest.raises(NotImplementedError, match="item 19"):
        Trainer(cfg, ShapeConfig("t", "train", 32, 2),
                TrainConfig(ckpt_dir=str(tmp_path)), device="cpu")


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    assert launch_train.main([
        "--reduced", "--steps", "2", "--seq-len", "16", "--batch", "2",
        "--ckpt-every", "2", "--ckpt-dir", str(tmp_path), "--device",
        "cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["result"]["final_step"] == 2
    assert np.isfinite(out["result"]["final_loss"])
    with pytest.raises(NotImplementedError, match="compress"):
        launch_train.main(["--compress", "--device", "cpu"])
