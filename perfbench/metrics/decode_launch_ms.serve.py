"""Mean host ms of the traced decode steps' enqueue: each ``engine.decode``
span of the traced engine steps less its ``engine.wait`` (the token
read-back).  Program spans; None without them."""
from perfbench import spanread


def read(run):
    recs, steps = spanread.traced_steps(run, "engine.step")
    if steps is None:
        return None
    decodes = [d for ds in spanread.descendants(recs, steps, "engine.decode")
               for d in ds]
    if not decodes:
        return None
    waits = spanread.descendants(recs, decodes, "engine.wait")
    host = sum(b - a for d, w in zip(decodes, waits)
               for a, b in spanread.minus(d, w))
    return host / len(decodes) / 1e6
