"""Paged-attention decode: CUDA kernel, plain version and dispatch."""
