"""Mean device ms of the traced training steps' backward: the CUDA events
of each ``train.step`` span's ``train.backward`` (``torch.autograd.grad``).
A program span; None without it."""
from perfbench import spanread


def read(run):
    return spanread.mean_device_ms(run, "train.backward")
