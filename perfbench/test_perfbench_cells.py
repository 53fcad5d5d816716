"""The cells at a CPU size (``smallcells``), driven through the whole of a
run but the look for a card: a sound run of the program is correct; with
the timed path broken underneath (a token altered where it is produced, a
step that leaves its state unchanged, half the batch left out) the check
says not correct; the plain references agree with the port's CPU path on
the same weights; the control (the reference in fp8) and, for training,
half the batch left out, judged as the calibration judges them, come out
not correct.  The card test runs the small cells through the port's kernels."""
import math

import pytest
import torch

from perfbench import calibrate, harness, smallcells, weights

SEED = 3_000_000_007


def _run(kind, seed=SEED, seconds=1.0):
    name = {"serve": "danube-longdoc", "train": "mamba2-train"}[kind]
    cell, config = (smallcells.serve_cell() if kind == "serve"
                    else smallcells.train_cell())
    return smallcells.run(name, cell, config, seed=seed, seconds=seconds)


@pytest.mark.parametrize("kind", ["serve", "train"])
def test_a_sound_run_is_correct(kind):
    line = _run(kind)
    assert line["correct"], line["compared"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "compared"


def _altered_decode(real):
    def step(*args, **kw):
        toks, lens = real(*args, **kw)
        return (toks + 1) % kw["cfg"].vocab_size, lens
    return step


def _unchanged_decode(real):
    def step(params, pools, tables, lens, *args, **kw):
        toks, _ = real(params, pools, tables, lens, *args, **kw)
        return toks, lens
    return step


def _altered_prefill(real):
    def prefill(*args, **kw):
        return (real(*args, **kw) + 1) % kw["cfg"].vocab_size
    return prefill


@pytest.mark.parametrize("name, attr, fault", [
    ("token altered in decode", "decode_step_paged", _altered_decode),
    ("decode state unchanged", "decode_step_paged", _unchanged_decode),
    ("first token altered in prefill", "prefill_shared_paged",
     _altered_prefill),
])
def test_serving_faults_are_not_correct(monkeypatch, name, attr, fault):
    from repro_torch.serve import engine
    monkeypatch.setattr(engine, attr, fault(getattr(engine, attr)))
    line = _run("serve")
    assert not line["correct"], (name, line["compared"])


def _no_update(grads, state, params, cfg, **kw):
    return params, state, {"grad_norm": torch.zeros(()),
                           "lr": torch.zeros(())}


def _half_batch(real):
    def loss_fn(params, cfg, batch, **kw):
        rows = batch["tokens"].shape[0] // 2
        return real(params, cfg, {"tokens": batch["tokens"][:rows]}, **kw)
    return loss_fn


@pytest.mark.parametrize("name", ["state unchanged", "half the batch"])
def test_training_faults_are_not_correct(monkeypatch, name):
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    if name == "state unchanged":
        monkeypatch.setattr(adamw, "update", _no_update)
    else:
        monkeypatch.setattr(transformer, "loss_fn",
                            _half_batch(transformer.loss_fn))
    line = _run("train")
    assert not line["correct"], (name, line["compared"])


# ------------------------------------------- the references and the port
def test_dense_reference_matches_the_ports_forward():
    from repro_torch.models import transformer
    _, config = smallcells.serve_cell()
    ref = harness.reference_module("dense")
    params = weights.make(config, 5, torch.float32, "cpu")
    cfg = harness.model_config(config)
    tokens = torch.randint(0, config["vocab_size"], (100,),
                           generator=torch.Generator().manual_seed(5))
    hidden, _, _, _ = transformer.forward(params, cfg, tokens[None])
    want = transformer.lm_logits(params, cfg, hidden)[0, :, :cfg.vocab_size]
    got = ref.logits(params, config, tokens.tolist(), list(range(100)))
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    # the gap of each token served after a 60-token prompt, read where the
    # reference stood when it came
    served = tokens[60:]
    lg = want[59:99]
    gap = (lg.max(-1).values - lg.gather(1, served[:, None])[:, 0]).max()
    assert ref.served_gap(params, config, tokens[:60].tolist(),
                          served.tolist()) == pytest.approx(float(gap),
                                                            abs=1e-4)


def test_mamba2_reference_matches_the_ports_loss_gradients_and_adamw():
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    cell, config = smallcells.train_cell()
    ref = harness.reference_module("mamba2")
    cfg = harness.model_config(config)
    params = weights.make(config, 9, torch.float32, "cpu")
    tokens = torch.randint(0, config["vocab_size"], (2, 64),
                           generator=torch.Generator().manual_seed(9))
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in adamw.flatten(params).items()}
    port_loss, _ = transformer.loss_fn(adamw.unflatten(leaves), cfg,
                                       {"tokens": tokens})
    port_grads = torch.autograd.grad(port_loss, list(leaves.values()))
    P = {k: v.detach().clone().requires_grad_(True)
         for k, v in leaves.items()}
    ref_loss = ref.loss(P, config, tokens)
    ref_grads = torch.autograd.grad(ref_loss, list(P.values()))
    torch.testing.assert_close(ref_loss, port_loss, atol=1e-5, rtol=1e-5)
    for k, a, b in zip(leaves, ref_grads, port_grads):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=1e-4, msg=k)
    # one AdamW step of each side from the same gradients' weights
    opt = dict(cell["traffic"]["opt"], warmup_steps=1)
    got = ref.train(params, config, [tokens], opt)
    state = adamw.init(params)
    new = {k: v.clone() for k, v in adamw.flatten(params).items()}
    adamw.update(adamw.unflatten(dict(zip(leaves, port_grads))), state,
                 adamw.unflatten(new), adamw.AdamWConfig(**opt))
    for k, v in adamw.flatten(params).items():
        change = float((new[k] - v).norm())
        assert got["change"][k] == pytest.approx(change, rel=1e-3, abs=1e-7)
        first = float(adamw.flatten(state["m"])[k].norm()) / (1 - opt["b1"])
        assert got["first_grad"][k] == pytest.approx(first, rel=1e-4,
                                                     abs=1e-9)


# ------------------------------------------------------------ the control
def test_the_serving_control_reads_above_the_limit():
    cell, config = smallcells.serve_cell()
    rec = calibrate.seed_record(cell, config, SEED, 1.0, True, device="cpu")
    assert rec["program"]["correct"], rec["program"]
    assert set(rec) - {"program", "attempted", "e2e"} == {"fp8_reference"}
    assert not rec["fp8_reference"]["correct"], rec["fp8_reference"]


def test_the_training_control_reads_above_the_limits():
    cell, config = smallcells.train_cell()
    rec = calibrate.seed_record(cell, config, SEED, 0.5, True, device="cpu")
    assert rec["program"]["correct"], rec["program"]
    for name in ("fp8_reference", "half_batch"):
        assert not rec[name]["correct"], (name, rec[name])


def test_judge_needs_every_number_within_its_limit():
    ok = harness.Window({}, {}, attempted=3, failed=0)
    assert harness.judge({"a": (1.0, 1.0), "b": (0.0, 2.0)}, ok)
    assert not harness.judge({"a": (1.0, 1.0), "b": (2.5, 2.0)}, ok)
    assert not harness.judge({"a": (math.inf, 1.0)}, ok)
    assert not harness.judge({}, ok)
    assert not harness.judge({"a": (0.0, 1.0)},
                             harness.Window({}, {}, attempted=3, failed=1))
    assert not harness.judge({"a": (0.0, 1.0)},
                             harness.Window({}, {}, attempted=0, failed=0))


# ------------------------------------------------------------- on a card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card: the paged and SSD kernels have no "
                    "CPU mode")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["serve", "train"])
def test_small_cells_through_the_kernels(card, kind):
    name = {"serve": "danube-longdoc", "train": "mamba2-train"}[kind]
    cell, config = (smallcells.serve_cell() if kind == "serve"
                    else smallcells.train_cell())
    line = harness.run_cell(name, SEED, 2.0, True, device=card, cell=cell,
                            config=config)
    assert line["correct"], line["compared"]
    assert line["device"]["busy_s"] > 0
    assert line["metrics"] and all(
        math.isfinite(v["value"]) for v in line["metrics"].values())
