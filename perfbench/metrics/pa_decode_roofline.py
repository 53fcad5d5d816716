"""Percent of its roofline that ``pa_decode_kernel`` reached in the traced
stretch: the least bytes of the live rows (K and V of each row's cached
tokens, q, the output, the table slice; every layer) over 3.35 TB/s,
divided by the kernel's traced device time.  Reads nothing (None) when
the trace holds no launch of the kernel."""
from perfbench import flops, trace

KERNELS = (r"\bpa_decode_kernel\b",)


def read(run):
    t, c = run.trace, run.counters
    if t is None or t.empty:
        return None
    secs, launches = trace.kernel_seconds(t, KERNELS)
    if not launches:
        return None
    cfg = run.config
    nbytes = sum(flops.pa_decode_bytes(cfg, n, c["page_size"], c["kv_bytes"])
                 for _, _, rows in c["traced_steps"] for n in rows)
    return 100.0 * cfg["n_layers"] * nbytes / flops.HBM_BYTES_PER_S / secs
