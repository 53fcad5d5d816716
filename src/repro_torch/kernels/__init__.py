"""Hand-written Hopper kernels of the port.

Each kernel package holds ``ref.py`` (the plain PyTorch version),
``<name>.py`` (the wrapper that launches the CUDA kernel built from
``repro_torch/csrc/``) and ``ops.py`` (dispatch on the tensor's device).
"""
import torch


BUILT_WIDTHS = (32, 64, 128)


def built_width(d: int):
    """The width the attention kernels run head dim ``d`` at: the next of
    ``BUILT_WIDTHS``, with the columns past ``d`` zero and never stored;
    ``None`` for a ``d`` they refuse (not a multiple of 8, which 16-byte
    rows need, or over 128)."""
    if d <= 0 or d % 8 or d > BUILT_WIDTHS[-1]:
        return None
    return next(w for w in BUILT_WIDTHS if d <= w)


def readable(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when the kernels can read it through its strides, else
    a contiguous copy: the last dimension contiguous, the base 16-byte
    aligned and every other stride a multiple of 16 bytes (4 float32
    elements for vector loads, 8 bf16 elements for the tensor maps of TMA
    and 16-byte loads)."""
    ok = (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
          and all(s * t.element_size() % 16 == 0
                  for n, s in zip(t.shape[:-1], t.stride()[:-1]) if n > 1))
    return t if ok else t.contiguous()
