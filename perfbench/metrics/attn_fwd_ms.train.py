"""Device ms a traced training step spends in the forward of its layers'
attention mixers: the CUDA events of each ``train.step`` span's
``train.attn`` spans, summed, averaged over the traced steps.  A
program span; None without it."""
from perfbench import spanread


def read(run):
    return spanread.mean_device_ms(run, "train.attn")
