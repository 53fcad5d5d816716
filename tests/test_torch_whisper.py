"""The port's encoder-decoder pieces against the JAX reference, on the CPU.

Reduced whisper-medium (2 encoder and 2 decoder layers, d 128, 4 query
and 2 KV heads of 32, 32 frames), fp32, on the reference's
``init_params`` weights bridged by ``from_reference`` and the same numpy
frames and tokens: the sinusoidal positions, ``encode``, the
cross-attention branch of ``_attn_block_fwd`` and the cross KV it
returns, the per-row absolute positions of ``_embed_tokens_decode``,
``init_cache``'s layout with ``enc_seq``, and a few ``Trainer`` steps
(frames in every batch) against the reference's ``Trainer``.  The whole
model (forward, loss, every gradient, serving) is held in
``tests/test_torch_archs_smoke.py``.

Tolerances: positions atol 1e-6 (one float32 sine or cosine of the same
angle) up to 32 positions; at 1500 frames the frequencies' last bits
(float32 ``pow``) times the position, derived in
``test_sinusoidal_positions_at_whisper_frames``; one block or the
encoder 1e-5 (float32 sums in other orders);
Trainer losses 1e-4, as ``tests/test_torch_train.py``'s.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train.loop import TrainConfig as JTrainConfig
from repro.train.loop import Trainer as JTrainer
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.models.params import from_reference
from repro_torch.optim import adamw
from repro_torch.train.loop import TrainConfig, Trainer

torch.set_num_threads(1)

ARCH = "whisper-medium"


def _np(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


@pytest.fixture(scope="module")
def model():
    jcfg = jget(ARCH).reduced()
    ref = _np(JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32))
    # the reference's LayerNorms start at (1, 0): move them off it
    rs = np.random.RandomState(9)
    for tree in (ref["layers"], ref["encoder"]["layers"]):
        for norm in ("norm1", "norm2", "norm_x"):
            if norm in tree:
                tree[norm]["bias"] = rs.randn(
                    *tree[norm]["bias"].shape).astype(np.float32) * 0.1
    frames = rs.randn(2, jcfg.encoder_seq_len,
                      jcfg.d_model).astype(np.float32)
    return jcfg, get_config(ARCH).reduced(), ref, \
        from_reference(ref, device="cpu"), frames


def _layer(tree, i):
    return jax.tree.map(lambda a: a[i], tree)


@pytest.mark.parametrize("n_pos,dim", [(32, 128), (7, 6)])
def test_sinusoidal_positions_match_reference(n_pos, dim):
    want = np.asarray(JL.sinusoidal_positions(n_pos, dim))
    got = layers.sinusoidal_positions(n_pos, dim)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_sinusoidal_positions_at_whisper_frames():
    """At 1500 frames of width 1024.  The frequencies 10000^(-2i/d) come
    from float32 ``pow`` and a reciprocal, whose last bits differ between
    XLA and PyTorch for a few i (4 of 512 here, by up to 2 ulp); position p
    multiplies them, so the angle may differ by 2 p ulp(freq) <= 2 * 1500 *
    2^-24 (every frequency is at most 1) and the embedding by as much
    (|d sin| <= |d angle|), plus 1e-6 for the sine itself."""
    n_pos, dim = 1500, 1024
    exps = np.arange(0, dim, 2, dtype=np.float32) / dim
    jf = np.asarray(1.0 / (10_000.0 ** jnp.asarray(exps)))
    tf = (1.0 / (10_000.0 ** torch.as_tensor(exps))).numpy()
    assert (np.abs(jf.view(np.int32).astype(np.int64)
                   - tf.view(np.int32).astype(np.int64)) <= 2).all()
    want = np.asarray(JL.sinusoidal_positions(n_pos, dim))
    got = layers.sinusoidal_positions(n_pos, dim).numpy()
    bound = 2 * n_pos * 2.0 ** -24 + 1e-6
    np.testing.assert_allclose(got, want, atol=bound)
    # rows whose every angle is below one radian carry no amplification
    np.testing.assert_allclose(got[:2], want[:2], atol=1e-6)


def test_encode_matches_reference(model):
    jcfg, cfg, ref, params, frames = model
    want = JT.encode(ref, jcfg, jnp.asarray(frames))
    got = T.encode(params, cfg, torch.as_tensor(frames))
    assert tuple(got.shape) == frames.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("layer", [0, 1])
def test_cross_attention_block_matches_reference(model, layer):
    """One decoder layer with ``enc_out``: its output and the
    cross-attention's (k, v) of every frame, Sq (24) != Sk (32)."""
    jcfg, cfg, ref, params, frames = model
    rs = np.random.RandomState(layer)
    x = rs.randn(2, 24, cfg.d_model).astype(np.float32)
    enc = rs.randn(*frames.shape).astype(np.float32)
    jx, _, (jk, jv), (jxk, jxv) = JT._attn_block_fwd(
        _layer(ref["layers"], layer), jcfg, jnp.asarray(x), causal=True,
        q_offset=0, enc_out=jnp.asarray(enc))
    lp = T._unstack(params["layers"], cfg.n_layers)[layer]
    x_out, aux, (k, v), (xk, xv) = T._attn_block_fwd(
        lp, cfg, torch.as_tensor(x), causal=True, q_offset=0,
        enc_out=torch.as_tensor(enc))
    assert aux is None
    assert tuple(xk.shape) == (2, frames.shape[1], cfg.n_kv_heads,
                               cfg.resolved_head_dim)
    for got, want in ((x_out, jx), (k, jk), (v, jv), (xk, jxk), (xv, jxv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # without enc_out the block has no cross branch
    *_, none = T._attn_block_fwd(lp, cfg, torch.as_tensor(x), causal=True,
                                 q_offset=0)
    assert none is None


def test_embed_tokens_decode_at_ragged_positions(model):
    jcfg, cfg, ref, params, _ = model
    toks = np.array([[3], [77], [500], [0]], np.int32)
    pos = np.array([0, 5, 447, 1499], np.int32)
    want = JT._embed_tokens_decode(ref, jcfg, jnp.asarray(toks),
                                   jnp.asarray(pos))
    got = T._embed_tokens_decode(params, cfg, torch.as_tensor(toks),
                                 torch.as_tensor(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    # row r is the full-sequence embedding at position pos[r]
    full = T._embed_tokens(params, cfg, torch.as_tensor(
        np.repeat(toks, 1500, axis=1)))
    np.testing.assert_allclose(got[:, 0].numpy(),
                               full[np.arange(4), pos].numpy(), atol=1e-6)


def test_init_cache_layout_with_enc_seq(model):
    jcfg, cfg, *_ = model
    want = JT.init_cache(jcfg, 3, 40, dtype=jnp.float32, enc_seq=32)
    got = T.init_cache(cfg, 3, 40, dtype=torch.float32, device="cpu",
                       enc_seq=32)
    assert set(got) == set(want) == {"k", "v", "xk", "xv"}
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].dtype == torch.float32 and not got[k].any()
    assert tuple(got["xk"].shape) == (cfg.n_layers, 3, 32, cfg.n_kv_heads,
                                      cfg.resolved_head_dim)


def test_trainer_tracks_the_reference_trainer(tmp_path):
    """3 steps on frames and tokens from the corpus, from the same weights:
    the port's losses track the JAX Trainer's."""
    jcfg, cfg = jget(ARCH).reduced(), get_config(ARCH).reduced()
    kw = dict(steps=3, log_every=1, ckpt_every=0, seed=3)
    jt = JTrainer(jcfg, JShapeConfig("t", "train", 32, 2),
                  JTrainConfig(ckpt_dir=str(tmp_path / "j"), **kw))
    pt = Trainer(cfg, ShapeConfig("t", "train", 32, 2),
                 TrainConfig(ckpt_dir=str(tmp_path / "p"), **kw),
                 device="cpu")
    assert "frames" in pt.corpus.batch(0)
    pt.params = Trainer._trainable(from_reference(_np(jt.params),
                                                  device="cpu"))
    pt.opt_state = adamw.init(pt.params)
    jt.run()
    pt.run()
    assert [m["step"] for m in pt.metrics_log] == [1, 2, 3]
    for mine, ref in zip(pt.metrics_log, jt.metrics_log):
        np.testing.assert_allclose(mine["loss"], ref["loss"], atol=1e-4)
