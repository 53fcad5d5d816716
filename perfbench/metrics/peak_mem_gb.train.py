"""The allocator's peak over the window's training steps, in GB
(``torch.cuda.max_memory_allocated`` after a reset at the window's
start)."""


def read(run):
    peak = run.counters.get("peak_bytes_window")
    return peak / 1e9 if peak else None
