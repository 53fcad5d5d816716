"""Percent of the card's bf16 peak (989 TFLOP/s) that the model FLOPs of
the traced training steps of the Mamba-2 / attention / MoE hybrid make
over their traced wall (``flops_hybrid.hybrid_train_flops``: 6 x the
matmul weights a token uses, the held experts' routed pairs from the
program's ``moe.pairs_held`` counter, the tied head once, the attention
scores and the SSD scans forward and backward).  None without the
counter (a program that does not count its pairs)."""
from perfbench import flops, flops_hybrid


def read(run):
    t, c = run.trace, run.counters
    if t is None or t.empty or not c.get("traced_steps") \
            or not c.get("moe_pairs_held"):
        return None
    steps = c["traced_steps"]
    total = steps * flops_hybrid.hybrid_train_flops(
        run.config, c["batch"], c["seq_len"], c["moe_pairs_held"] / steps)
    return 100.0 * total / (t.wall_s * flops.PEAK_FLOPS["bfloat16"])
