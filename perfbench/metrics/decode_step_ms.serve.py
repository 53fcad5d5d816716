"""Mean wall ms of the engine's decode steps in the window
(``ServingEngine.decode_step_times``, host clock after the token
read-back), leaving out the traced stretch."""


def read(run):
    ms = run.counters.get("decode_step_ms")
    return sum(ms) / len(ms) if ms else None
