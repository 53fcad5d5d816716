"""Ms per traced engine step in which the card ran nothing while the host
was inside the step and not waiting on it: the traced device events' gaps
(no minimum length) inside each ``engine.step`` span and outside its
``engine.wait`` descendants.  Program spans against the device trace."""
from perfbench import spanread


def read(run):
    t = run.trace
    if t is None or t.empty:
        return None
    recs, steps = spanread.traced_steps(run, "engine.step")
    if steps is None:
        return None
    waits = spanread.descendants(recs, steps, "engine.wait")
    regions = [x for st, w in zip(steps, waits)
               for x in spanread.minus(st, w)]
    return spanread.idle_ns(regions, t.device) / len(steps) / 1e6
