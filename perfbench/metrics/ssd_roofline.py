"""Percent of their roofline that the SSD kernels reached in the traced
training steps: the least time of every SSD call (forward and backward,
each the larger of its bytes over 3.35 TB/s and its FLOPs over the bf16
peak, at the cell's shape) over the traced device time of the SSD
kernels, the backward's rerun of the forward's cb, state and pass
kernels included.  Calls are the SSD module's own counters."""
from perfbench import flops, trace

KERNELS = tuple(rf"\bssd_{k}_kernel\b" for k in (
    "cb", "state", "pass", "scan", "dstate", "dpass", "bwd_key",
    "bwd_query", "dcum"))


def read(run):
    t, c = run.trace, run.counters
    if t is None or t.empty or not c.get("ssd_fwd_calls"):
        return None
    secs, launches = trace.kernel_seconds(t, KERNELS)
    if not launches:
        return None
    case = flops.ssd_case(run.config, c["batch"], c["seq_len"])
    elem = flops.DTYPE_BYTES[run.config["dtype"]]
    least = (c["ssd_fwd_calls"] * flops.least_seconds(
        *flops.ssd_fwd_flops_bytes(case, elem), run.config["dtype"])
        + c["ssd_bwd_calls"] * flops.least_seconds(
            *flops.ssd_bwd_flops_bytes(case, elem), run.config["dtype"]))
    return 100.0 * least / secs
