"""The granite4h-train cell at a CPU size (``smallcells_extra``), driven
through the whole of a run but the look for a card, as
``test_perfbench_cells.py`` drives the first two: a sound run is correct;
with the timed path broken underneath (the optimizer's update skipped,
half the batch left out) the check says not correct; the controls, judged
as the calibration judges them, come out not correct.  Then the parts of
the cell: the hybrid's counts by hand, the new readers on synthetic
traces and spans, and the refusal of a program that cannot run the
hybrid."""
import dataclasses
import math

import pytest
import torch

from perfbench import (calibrate, flops, flops_hybrid, harness,
                       smallcells_extra)
from perfbench.test_perfbench_spans import _Spans
from perfbench.test_perfbench_units import synthetic

SEED = 3_000_000_007
MOE = harness.load_module(harness.BENCH / "traffic" / "train_moe.py",
                          "traffic_train_moe")
NAME = "granite4h-train"


def _run(seed=SEED):
    cell, config = smallcells_extra.train_cell()
    return harness.run_cell(NAME, seed, 1.0, False, device="cpu",
                            cell=cell, config=config)


def test_a_sound_run_is_correct():
    line = _run()
    assert line["correct"], line["compared"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert list(line)[-1] == "compared"


def _no_update(grads, state, params, cfg, **kw):
    return params, state, {"grad_norm": torch.zeros(()),
                           "lr": torch.zeros(())}


def _half_batch(real):
    def loss_fn(params, cfg, batch, **kw):
        rows = batch["tokens"].shape[0] // 2
        return real(params, cfg, {"tokens": batch["tokens"][:rows]}, **kw)
    return loss_fn


@pytest.mark.parametrize("fault", ["update skipped", "half the batch"])
def test_hybrid_training_faults_are_not_correct(monkeypatch, fault):
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    if fault == "update skipped":
        monkeypatch.setattr(adamw, "update", _no_update)
    else:
        monkeypatch.setattr(transformer, "loss_fn",
                            _half_batch(transformer.loss_fn))
    line = _run()
    assert not line["correct"], (fault, line["compared"])


def test_the_controls_read_above_the_limits():
    cell, config = smallcells_extra.train_cell()
    rec = calibrate.seed_record(cell, config, SEED, 0.5, True, device="cpu")
    assert rec["program"]["correct"], rec["program"]
    for name in ("fp8_reference", "half_batch"):
        assert not rec[name]["correct"], (name, rec[name])


# ------------------------------------------------------------- the parts
def test_hybrid_counts_by_hand():
    cfg = {"n_layers": 2, "block_pattern": ["mamba_ffn", "attn"],
           "d_model": 4, "n_heads": 2, "n_kv_heads": 1, "head_dim": 2,
           "vocab_size": 10,
           "moe": {"n_experts": 3, "d_ff_expert": 5, "d_ff_shared": 6},
           "ssm": {"expand": 2, "head_dim": 4, "n_groups": 1, "d_state": 3,
                   "chunk_size": 4}}
    assert flops_hybrid.attn_matmul_params(cfg) == 2 * 4 * 4 + 2 * 4 * 2
    assert flops_hybrid.moe_dense_params(cfg) == 4 * (3 + 18)
    assert flops_hybrid.expert_params(cfg) == 60
    case = flops_hybrid.flash_case(cfg, 1, 4)
    assert case == (1, 2, 1, 4, 2)
    f, b = flops_hybrid.flash_fwd_flops_bytes(case, 2)
    assert f == 4 * 2 * 2 * 10
    assert b == (2 * 2 * 4 * 2 + 2 * 1 * 4 * 2) * 2 + 2 * 4 * 4
    f, b = flops_hybrid.flash_bwd_flops_bytes(case, 2)
    assert f == 10 * 2 * 2 * 10
    assert b == (3 * 2 * 4 * 2 + 4 * 1 * 4 * 2) * 2 + 2 * 4 * 4
    ssd = flops.ssd_case(cfg, 1, 4)
    scan = (flops.ssd_fwd_flops_bytes(ssd, 2)[0]
            + flops.ssd_bwd_flops_bytes(ssd, 2)[0])
    weights = 128 + 48 + 2 * 84 + 40
    assert flops_hybrid.hybrid_train_flops(cfg, 1, 4, 7) == (
        6 * weights * 4 + 6 * 60 * 7 + 3 * 160 + scan)


def _granite_run(t, counters):
    cfg = harness.load_config("granite-4.0-h-small")
    return harness.Run({}, cfg, counters, t), cfg


def test_the_flash_backward_counts_autograds_work_and_the_scores():
    """10 D a visible pair: autograd's backward of plain attention (P^T
    dO, dO v^T, dS k, dS^T q: 8 D) plus q k^T recomputed (2 D), in the
    forward's units (q k^T and P v: 4 D)."""
    from torch.utils.flop_counter import FlopCounterMode
    b, h, s, d = 1, 2, 16, 8
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(b, h, s, d, generator=g).requires_grad_()
               for _ in range(3))
    with FlopCounterMode(display=False) as fwd:
        out = torch.softmax(q @ k.transpose(-1, -2), dim=-1) @ v
    with FlopCounterMode(display=False) as bwd:
        out.backward(torch.ones_like(out))
    case = (b, h, h, s, d)
    f_fwd = flops_hybrid.flash_fwd_flops_bytes(case, 2)[0]
    f_bwd = flops_hybrid.flash_bwd_flops_bytes(case, 2)[0]
    scores = fwd.get_total_flops() // 2
    assert bwd.get_total_flops() == 2 * fwd.get_total_flops()
    assert fwd.get_total_flops() * f_bwd == \
        (bwd.get_total_flops() + scores) * f_fwd


def test_flash_rooflines_read_their_kernels():
    counters = {"traced_steps": 2, "batch": 2, "seq_len": 4096}
    t = synthetic([("void fa_fwd_wgmma_kernel<128>(...)", 1_000, 400_000),
                   ("void fa_fwd_wgmma_kernel<128>(...)", 500_000, 400_000),
                   ("void fa_dq_wgmma_kernel<128>(...)", 1_000_000, 500_000),
                   ("void fa_dkv_wgmma_kernel<128>(...)", 2_000_000,
                    700_000),
                   ("void fa_dq_wgmma_kernel<128>(...)", 3_000_000, 500_000),
                   ("void fa_dkv_wgmma_kernel<128>(...)", 4_000_000,
                    700_000)])
    run, cfg = _granite_run(t, counters)
    case = (2, 32, 8, 4096, 128)
    fwd = flops.least_seconds(*flops_hybrid.flash_fwd_flops_bytes(case, 2),
                              "bfloat16")
    bwd = flops.least_seconds(*flops_hybrid.flash_bwd_flops_bytes(case, 2),
                              "bfloat16")
    assert harness.metric_reader("flash_fwd_roofline")(run) == \
        pytest.approx(100 * 2 * fwd / 800e-6)
    assert harness.metric_reader("flash_bwd_roofline")(run) == \
        pytest.approx(100 * 2 * bwd / 2.4e-3)
    assert 0 < harness.metric_reader("flash_fwd_roofline")(run) < 100
    none = synthetic([("gemm", 1_000, 10)])
    for m in ("flash_fwd_roofline", "flash_bwd_roofline"):
        assert harness.metric_reader(m)(_granite_run(none, counters)[0]) \
            is None


def test_hybrid_mfu_and_expert_load_read_the_counters():
    counters = {"traced_steps": 2, "batch": 2, "seq_len": 4096,
                "moe_pairs_held": 22_000, "moe_pairs_held_max": 5_000,
                "experts_held": 9}
    t = synthetic([("gemm", 1_000, 10)], wall_s=1.0)
    run, cfg = _granite_run(t, counters)
    want = 2 * flops_hybrid.hybrid_train_flops(cfg, 2, 4096, 11_000)
    assert harness.metric_reader("mfu.train_hybrid")(run) == \
        pytest.approx(100 * want / 989e12)
    assert harness.metric_reader("expert_load_max.train")(run) == \
        pytest.approx(100 * 5_000 * 9 / 22_000)
    bare = dict(counters, moe_pairs_held=0)
    for m in ("mfu.train_hybrid", "expert_load_max.train"):
        assert harness.metric_reader(m)(_granite_run(t, bare)[0]) is None


@pytest.fixture
def recorded(monkeypatch):
    harness.use_program()
    from repro_torch.telemetry import spans

    def put(recs):
        monkeypatch.setattr(spans, "snapshot", lambda: list(recs))
    return put


def test_layer_span_readers_sum_each_step(recorded):
    sp = _Spans()
    for i in range(2):
        st = sp.add("train.step", 100 * i, 100 * i + 90)
        fw = sp.add("train.forward", 100 * i, 100 * i + 40, st,
                    device_ms=30.0)
        for j in range(3):
            sp.add("train.mamba", 100 * i + j, 100 * i + j + 1, fw,
                   device_ms=2.0 + i)
            sp.add("train.moe", 100 * i + j, 100 * i + j + 1, fw,
                   device_ms=1.0)
        sp.add("train.attn", 100 * i + 5, 100 * i + 6, fw, device_ms=4.0)
    recorded(sp.recs)
    run = harness.Run({}, {}, {"traced_steps": 2}, None)
    got = {m: harness.metric_reader(m)(run) for m in
           ("mamba_fwd_ms.train", "moe_fwd_ms.train", "attn_fwd_ms.train")}
    assert got == {"mamba_fwd_ms.train": 7.5, "moe_fwd_ms.train": 3.0,
                   "attn_fwd_ms.train": 4.0}
    recorded([r for r in sp.recs if r.name != "train.attn"])
    assert harness.metric_reader("attn_fwd_ms.train")(run) is None


def test_a_program_without_the_hybrids_fields_is_refused(monkeypatch):
    from repro_torch.configs import base

    @dataclasses.dataclass(frozen=True)
    class OldMoE:
        n_experts: int
        top_k: int
        d_ff_expert: int

    config = harness.load_config("granite-4.0-h-small")
    MOE.program_runs(config)
    monkeypatch.setattr(base, "MoEConfig", OldMoE)
    with pytest.raises(RuntimeError, match="MoEConfig.dropless"):
        MOE.program_runs(config)


def test_the_traced_hybrid_run_reads_its_counters():
    cell, config = smallcells_extra.train_cell()
    cell["traffic"]["trace_at"] = 0.0
    drv = MOE.Runner(cell, config, SEED, "cpu")
    drv.setup()

    class Tracer:                       # traces from the window's start
        enabled, active, done = True, False, False

        def start(self):
            self.active = not self.done

        def stop(self):
            self.done = self.done or self.active
            self.active = False

    win = drv.window(0.5, Tracer())
    drv.release()
    c = win.counters
    pairs = c["traced_steps"] * 10 * 2 * 64 * 2     # layers x tokens x k
    assert c["moe_pairs"] == pairs
    assert 0 < c["moe_pairs_held_max"] <= c["moe_pairs_held"] < pairs
    assert c["experts_held"] == 2
    assert c["traced_steps"] >= 1
    assert math.isfinite(win.e2e["train_tokens_per_s"])


# ------------------------------------------------------------- on a card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs the CUDA card: the flash, SSD and paged kernels "
                    "have no CPU mode")
    return "cuda"


@pytest.mark.cuda
def test_small_new_cell_through_the_kernels(card):
    cell, config = smallcells_extra.train_cell()
    line = harness.run_cell(NAME, SEED, 2.0, True, device=card, cell=cell,
                            config=config)
    assert line["correct"], line["compared"]
    assert line["device"]["busy_s"] > 0
    assert line["metrics"] and all(
        math.isfinite(v["value"]) for v in line["metrics"].values())
