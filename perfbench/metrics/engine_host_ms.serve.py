"""Mean host ms of the traced engine steps: each ``engine.step`` span's
length less what its ``engine.wait`` descendants (the points where the
host blocks on the card) cover.  Program spans; None without them."""
from perfbench import spanread


def read(run):
    recs, steps = spanread.traced_steps(run, "engine.step")
    if steps is None:
        return None
    waits = spanread.descendants(recs, steps, "engine.wait")
    host = sum(b - a for st, w in zip(steps, waits)
               for a, b in spanread.minus(st, w))
    return host / len(steps) / 1e6
