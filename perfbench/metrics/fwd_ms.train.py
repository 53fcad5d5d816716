"""Mean device ms of the traced training steps' forward: the CUDA events
of each ``train.step`` span's ``train.forward`` (the loss's forward,
``T.loss_fn``).  A program span; None without it."""
from perfbench import spanread


def read(run):
    return spanread.mean_device_ms(run, "train.forward")
