"""Hand-written Hopper kernels of the port.

Each kernel package holds ``ref.py`` (the plain PyTorch version),
``<name>.py`` (the wrapper that launches the CUDA kernel built from
``repro_torch/csrc/``) and ``ops.py`` (dispatch on the tensor's device).
"""
