"""Wall ms the engine spent in prefill forwards per 1000 prompt tokens it
computed in the window (``ServingEngine.prefill_s`` over
``prefill_computed``, window deltas; host clock after a device sync)."""


def read(run):
    c = run.counters
    if not c.get("prefill_computed"):
        return None
    return 1e6 * c["prefill_s"] / c["prefill_computed"]
