"""Percent of its roofline that the flash backward, ``fa_dq_wgmma_kernel``
and ``fa_dkv_wgmma_kernel`` together, reached in the traced training
steps: the least time of each traced backward at the cell's attention
shape (``flops_hybrid.flash_bwd_flops_bytes``: 10 D FLOPs for every
visible pair, the work the backward needs; the larger of those over the
bf16 peak and the least bytes over 3.35 TB/s) over the two kernels'
traced device time.  None where
the trace holds no launch of them, or unequal counts of the two."""
from perfbench import flops, flops_hybrid, trace


def read(run):
    t, c = run.trace, run.counters
    if t is None or t.empty:
        return None
    dq, n_dq = trace.kernel_seconds(t, (r"\bfa_dq_wgmma_kernel\b",))
    dkv, n_dkv = trace.kernel_seconds(t, (r"\bfa_dkv_wgmma_kernel\b",))
    if not n_dq or n_dq != n_dkv:
        return None
    case = flops_hybrid.flash_case(run.config, c["batch"], c["seq_len"])
    dtype = run.config["dtype"]
    least = flops.least_seconds(*flops_hybrid.flash_bwd_flops_bytes(
        case, flops.DTYPE_BYTES[dtype]), dtype)
    return 100.0 * n_dq * least / (dq + dkv)
