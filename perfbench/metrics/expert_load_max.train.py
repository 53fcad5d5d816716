"""The largest held expert's routed pairs over the mean held expert's, in
percent, over the traced training steps: each MoE layer's largest held
expert's pairs (the program's ``moe.pairs_held_max`` counter, summed over
layers and steps) over its held experts' pairs (``moe.pairs_held``)
divided by the experts held.  100 is an even load; the layer's products
wait on its busiest expert.  None without the counters."""


def read(run):
    c = run.counters
    held, top = c.get("moe_pairs_held"), c.get("moe_pairs_held_max")
    if not held or top is None or not c.get("experts_held"):
        return None
    return 100.0 * top * c["experts_held"] / held
