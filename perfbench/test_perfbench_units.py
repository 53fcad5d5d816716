"""CPU tests of the benchmark's parts: the traffic generators (the same
for a seed, the same lengths for every seed), the FLOP and byte counts
against hand-worked shapes, and the per-layer readers on synthetic
traces (the pad dropped, a missing kernel reading None)."""
import collections
import types

import pytest
import torch

from perfbench import flops, harness, trace

SERVE = harness.load_module(harness.BENCH / "traffic" / "serve_closed.py",
                            "traffic_serve_closed")
TRAIN = harness.load_module(harness.BENCH / "traffic" / "train.py",
                            "traffic_train")


def _mix(name):
    return harness.load_cell(name)["traffic"]


# ---------------------------------------------------------------- traffic
def test_lengths_are_fixed_quantiles_within_bounds():
    spec = _mix("danube-longdoc")["prompt"]
    a = SERVE.lengths(256, spec)
    assert a == SERVE.lengths(256, spec)
    assert min(a) >= spec["min"] and max(a) <= spec["max"]
    assert a == sorted(a)
    assert abs(a[128] - spec["median"]) < 0.01 * spec["median"]
    out = SERVE.lengths(49, {"dist": "uniform", "min": 16, "max": 64})
    assert out == list(range(16, 65))


def test_serve_requests_repeat_for_a_seed_and_share_lengths_across_seeds():
    mix = dict(_mix("danube-longdoc"), requests=32,
               prompt={"dist": "lognormal", "median": 64, "sigma": 0.35,
                       "min": 40, "max": 120})
    a = SERVE.requests(mix, 512, 3_000_000_001)
    b = SERVE.requests(mix, 512, 3_000_000_001)
    c = SERVE.requests(mix, 512, 5)
    assert a == b
    assert a != c

    def shape(reqs):
        return (sorted(len(r["prompt"]) for r in reqs),
                sorted(r["max_new_tokens"] for r in reqs),
                sum(r["sampled"] for r in reqs))
    assert shape(a) == shape(c)
    assert shape(a)[2] == 16
    assert all(0 <= t < 512 for r in a for t in r["prompt"])
    # every run of ``clients`` requests holds one length of each stratum
    for reqs in (a, c):
        lens = sorted(len(r["prompt"]) for r in reqs)
        for block in (reqs[:16], reqs[16:]):
            got = sorted(len(r["prompt"]) for r in block)
            assert all(lens[2 * i] <= got[i] <= lens[2 * i + 1]
                       for i in range(16))
            assert sum(r["sampled"] for r in block) == 8


def test_training_batches_repeat_for_a_seed_and_differ_by_step():
    mix = dict(_mix("mamba2-train"), batch=2, seq_len=64)
    probs = TRAIN.zipf_probs(mix, 512, 11, "cpu")
    assert torch.allclose(probs, TRAIN.zipf_probs(mix, 512, 11, "cpu"))
    a = TRAIN.batch_tokens(mix, probs, 11, 0)
    assert a.shape == (2, 64) and a.dtype == torch.int32
    assert torch.equal(a, TRAIN.batch_tokens(mix, probs, 11, 0))
    assert not torch.equal(a, TRAIN.batch_tokens(mix, probs, 11, 1))
    assert not torch.equal(a[0], a[1])
    assert int(a.max()) < 512


def test_kv_written_follows_prefill_and_decode():
    req = types.SimpleNamespace(prefill_pos=96, out_tokens=[], prompt=[0] * 200)
    assert SERVE.kv_written(req) == 96
    req.prefill_pos, req.out_tokens = -1, [5]
    assert SERVE.kv_written(req) == 200
    req.out_tokens = [5, 6, 7]
    assert SERVE.kv_written(req) == 202
    req.out_tokens = []
    assert SERVE.kv_written(req) == 0


# ------------------------------------------------------------------ flops
TINY = {"n_layers": 2, "d_model": 8, "n_heads": 4, "n_kv_heads": 2,
        "head_dim": 2, "d_ff": 16, "vocab_size": 100}


def test_causal_pairs_by_hand():
    assert flops.causal_pairs(0, 3) == 1 + 2 + 3
    assert flops.causal_pairs(2, 4) == 3 + 4
    assert flops.causal_pairs(5, 5) == 0


def test_dense_flops_by_hand():
    # per layer: wq 8x8, wk 8x4, wv 8x4, wo 8x8, SwiGLU 3 x 8x16 = 576
    assert flops.dense_layer_matmul_params(TINY) == 64 + 32 + 32 + 64 + 384
    # two positions (0, 1): pairs 1 + 2; per pair 4 * 4 heads * 2 = 32
    want = 2 * (2 * 576 * 2 + 32 * 3) + 2 * 8 * 100 * 1
    assert flops.dense_flops(TINY, [(0, 2)], 1) == want


def test_pa_decode_bytes_by_hand():
    # K and V: 2 x 20 tokens x 2 heads x 2 x 2 bytes; q and out: 2 x 4 x 2
    # x 2; table: ceil(20 / 16) = 2 entries of 4 bytes
    assert flops.pa_decode_bytes(TINY, 20, 16, 2) == 320 + 32 + 8


def test_ssd_counts_by_hand():
    case = (1, 4, 1, 2, 1, 3, 4)           # B S H P G N chunk
    f, b = flops.ssd_fwd_flops_bytes(case, 2)
    assert f == 2 * 10 * (3 + 2) + 4 * 4 * 2 * 3
    assert b == 2 * 4 * 2 * 2 + 2 * 4 * 3 * 2 + 4 * 4 + 4 + 2 * 3 * 4
    f, b = flops.ssd_bwd_flops_bytes(case, 2)
    assert f == 2 * 10 * (9 + 6) + 12 * 4 * 2 * 3
    assert b == 3 * 4 * 2 * 2 + 4 * 4 * 3 * 2 + 2 * 4 * 4 + 2 * 4
    assert flops.least_seconds(989, 0, "bfloat16") == pytest.approx(1e-12)


def test_mamba2_train_flops_by_hand():
    cfg = {"n_layers": 1, "d_model": 4, "vocab_size": 10,
           "ssm": {"expand": 2, "head_dim": 4, "n_groups": 1, "d_state": 3,
                   "chunk_size": 4}}
    # d_inner 8, 2 heads: 4 * (16 + 6 + 2) + 8 * 4 = 128, head 40
    assert flops.mamba_layer_matmul_params(cfg) == 128
    case = flops.ssd_case(cfg, 1, 4)
    assert case == (1, 4, 2, 4, 1, 3, 4)
    scan = (flops.ssd_fwd_flops_bytes(case, 2)[0]
            + flops.ssd_bwd_flops_bytes(case, 2)[0])
    assert flops.mamba2_train_flops(cfg, 1, 4) == 6 * 168 * 4 + scan


# ------------------------------------------------------------ the readers
Ev = collections.namedtuple("Ev", "name dev start dur")


class _Kineto:
    def __init__(self, ev):
        self._ev = ev

    def name(self):
        return self._ev.name

    def device_type(self):
        return "DeviceType.CUDA" if self._ev.dev else "DeviceType.CPU"

    def start_ns(self):
        return self._ev.start

    def duration_ns(self):
        return self._ev.dur


def fake_profile(events):
    res = types.SimpleNamespace(events=lambda: [_Kineto(e) for e in events])
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=res))


def synthetic(kernels, host=(), pad=True, wall_s=1e-3):
    ev = [Ev("early_kernel", True, 0, 100)]
    if pad:
        ev += [Ev("spin_kernel", True, 200 + 10 * i, 5) for i in range(3)]
    ev += [Ev(n, True, s, d) for n, s, d in kernels]
    ev += [Ev(n, False, s, d) for n, s, d in host]
    return trace.parse(fake_profile(ev), wall_s)


def _run(t, counters, config=None, cell=None):
    return harness.Run(cell or {}, config or TINY, counters, t)


def test_parse_drops_the_pad_and_what_came_before():
    t = synthetic([("pa_decode_kernel", 1_000, 500),
                   ("gemm", 1_200, 1_000), ("gemm", 5_000, 1_000)])
    assert [e[0] for e in t.device] == ["pa_decode_kernel", "gemm", "gemm"]
    # union: [1000, 2200) and [5000, 6000)
    assert trace.busy_seconds(t) == pytest.approx(2_200e-9)
    assert trace.idle_share(t) == pytest.approx(100 * (1 - 2.2e-6 / 1e-3))
    assert trace.kernel_seconds(t, [r"\bgemm\b"]) == (pytest.approx(2e-6), 2)


def test_a_trace_whose_pad_was_dropped_reads_nothing():
    t = synthetic([("gemm", 1_000, 500)], pad=False)
    assert t.empty
    assert trace.idle_share(t) is None
    reader = harness.metric_reader("idle_share.serve")
    assert reader(_run(t, {})) is None
    assert harness.metric_reader("mfu.serve")(
        _run(t, {"traced_steps": [([(0, 2)], 1, [])]})) is None


def test_pa_decode_roofline_reads_the_kernel_and_none_without_it():
    counters = {"traced_steps": [([(9, 10)], 1, [10])], "page_size": 16,
                "kv_bytes": 2}
    read = harness.metric_reader("pa_decode_roofline")
    t = synthetic([("pa_decode_kernel(...)", 1_000, 1_000),
                   ("pa_decode_kernel(...)", 3_000, 1_000)])
    want = 100 * 2 * flops.pa_decode_bytes(TINY, 10, 16, 2) / 3.35e12 / 2e-6
    assert read(_run(t, counters)) == pytest.approx(want)
    renamed = synthetic([("paged_decode_v2", 1_000, 1_000)])
    assert read(_run(renamed, counters)) is None


def test_mfu_serve_counts_the_traced_steps():
    counters = {"traced_steps": [([(0, 2)], 1, []), ([(2, 3)], 1, [3])]}
    t = synthetic([("gemm", 1_000, 10)], wall_s=2.0)
    want = (flops.dense_flops(TINY, [(0, 2)], 1)
            + flops.dense_flops(TINY, [(2, 3)], 1)) / (2.0 * 989e12) * 100
    assert harness.metric_reader("mfu.serve")(
        _run(t, counters)) == pytest.approx(want)


def test_ssd_roofline_and_training_readers():
    cfg = harness.load_config("mamba2-1.3b")
    counters = {"traced_steps": 1, "batch": 4, "seq_len": 2048,
                "ssd_fwd_calls": 48, "ssd_bwd_calls": 48,
                "peak_bytes_window": 69_270_000_000}
    t = synthetic([("ssd_cb_kernel", 1_000, 10_000_000),
                   ("void ssd_bwd_key_kernel<128>", 20_000_000, 30_000_000),
                   ("elementwise", 60_000_000, 1_000)], wall_s=0.8)
    case = flops.ssd_case(cfg, 4, 2048)
    least = 48 * (flops.least_seconds(*flops.ssd_fwd_flops_bytes(case, 2),
                                      "bfloat16")
                  + flops.least_seconds(*flops.ssd_bwd_flops_bytes(case, 2),
                                        "bfloat16"))
    run = _run(t, counters, config=cfg)
    assert harness.metric_reader("ssd_roofline")(run) == pytest.approx(
        100 * least / 0.04)
    assert harness.metric_reader("mfu.train")(run) == pytest.approx(
        100 * flops.mamba2_train_flops(cfg, 4, 2048) / (0.8 * 989e12))
    assert harness.metric_reader("peak_mem_gb.train")(run) == 69.27
    none = synthetic([("elementwise", 1_000, 10)])
    assert harness.metric_reader("ssd_roofline")(
        _run(none, counters, config=cfg)) is None


def test_counter_readers():
    c = {"decode_step_ms": [50.0, 70.0], "prefill_s": 0.3,
         "prefill_computed": 2000, "prefill_skipped": 500}
    run = _run(None, c)
    assert harness.metric_reader("decode_step_ms.serve")(run) == 60.0
    assert harness.metric_reader("prefill_ms_per_ktok.serve")(run) == 150.0
    assert harness.metric_reader("prefix_hit_share")(run) == 20.0
    assert harness.metric_reader("decode_step_ms.serve")(
        _run(None, {"decode_step_ms": []})) is None


def test_breakdown_names_device_ops_and_idle_gaps_by_host_activity():
    t = synthetic([("gemm", 1_000, 1_000), ("softmax", 100_000, 50_000),
                   ("perfbench.serve.step", 900, 150_000)],
                  host=[("perfbench.serve.step", 500, 200_000),
                        ("cudaStreamSynchronize", 10_000, 80_000)])
    b = trace.breakdown(t)
    assert b["device_ops"][0] == ["softmax", pytest.approx(5e-5)]
    assert b["idle_gaps"] == [["perfbench.serve.step: cudaStreamSynchronize",
                               pytest.approx(98e-6)]]
