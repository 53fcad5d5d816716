"""Percent of the card's bf16 peak (989 TFLOP/s) that the model FLOPs of
the traced engine steps make over their traced wall: 2 x the matmul
weights per token through the layers, causal attention over the
positions each token sees (no padding), the LM head for each token
sampled."""
from perfbench import flops


def read(run):
    t, c = run.trace, run.counters
    if t is None or t.empty or not c.get("traced_steps"):
        return None
    total = sum(flops.dense_flops(run.config, spans, head)
                for spans, head, _ in c["traced_steps"])
    return 100.0 * total / (t.wall_s * flops.PEAK_FLOPS["bfloat16"])
