"""PyTorch/CUDA port of the ``repro`` package.

Module for module a twin of ``src/repro/``: same file names, public
functions and contracts, with the JAX package kept as the reference the
port is tested against.  This package imports ``torch`` and never ``jax``
or anything of ``repro``.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"``; each hand-written kernel's wrapper takes
its plain PyTorch version only for tensors that lie on the CPU.
"""
