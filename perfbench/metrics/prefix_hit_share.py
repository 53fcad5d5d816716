"""Percent of the window's prompt tokens served from shared prefix pages
(``ServingEngine.prefill_skipped`` over skipped plus computed, window
deltas): the MMU's content-keyed page sharing at work."""


def read(run):
    c = run.counters
    total = c.get("prefill_skipped", 0) + c.get("prefill_computed", 0)
    return 100.0 * c["prefill_skipped"] / total if total else None
