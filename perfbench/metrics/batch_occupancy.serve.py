"""Percent of the engine's slots (``engine.max_batch`` of the cell) that
the traced decode steps ran: the mean ``rows`` of the ``engine.decode``
spans of the traced engine steps.  A program counter; None without it."""
from perfbench import spanread


def read(run):
    recs, steps = spanread.traced_steps(run, "engine.step")
    if steps is None:
        return None
    rows = [d.attrs["rows"] for ds in spanread.descendants(
        recs, steps, "engine.decode") for d in ds]
    if not rows:
        return None
    return 100.0 * sum(rows) / len(rows) / run.cell["engine"]["max_batch"]
