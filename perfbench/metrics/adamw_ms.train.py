"""Mean device ms of the traced training steps' optimizer: the CUDA events
of each ``train.step`` span's ``train.optimizer`` (gradient compression
where the Trainer has it, and ``adamw.update``).  A program span; None
without it."""
from perfbench import spanread


def read(run):
    return spanread.mean_device_ms(run, "train.optimizer")
