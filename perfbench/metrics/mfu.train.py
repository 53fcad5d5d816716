"""Percent of the card's bf16 peak (989 TFLOP/s) that the model FLOPs of
the traced training steps make over their traced wall: 6 x the matmul
weights per token (the tied LM head once) plus the SSD scan's forward and
backward."""
from perfbench import flops


def read(run):
    t, c = run.trace, run.counters
    if t is None or t.empty or not c.get("traced_steps"):
        return None
    total = c["traced_steps"] * flops.mamba2_train_flops(
        run.config, c["batch"], c["seq_len"])
    return 100.0 * total / (t.wall_s * flops.PEAK_FLOPS["bfloat16"])
