"""Percent of its roofline that ``fa_fwd_wgmma_kernel`` reached in the
traced training steps: the least time of each traced launch at the cell's
attention shape (B x H query / K KV heads x S x D, causal; the larger of
its visible FLOPs over the bf16 peak and its least bytes over 3.35 TB/s,
``flops_hybrid.flash_fwd_flops_bytes``) over the kernel's traced device
time.  None where the trace holds no launch of it."""
from perfbench import flops, flops_hybrid, trace

KERNELS = (r"\bfa_fwd_wgmma_kernel\b",)


def read(run):
    t, c = run.trace, run.counters
    if t is None or t.empty:
        return None
    secs, launches = trace.kernel_seconds(t, KERNELS)
    if not launches:
        return None
    case = flops_hybrid.flash_case(run.config, c["batch"], c["seq_len"])
    dtype = run.config["dtype"]
    least = flops.least_seconds(*flops_hybrid.flash_fwd_flops_bytes(
        case, flops.DTYPE_BYTES[dtype]), dtype)
    return 100.0 * launches * least / secs
