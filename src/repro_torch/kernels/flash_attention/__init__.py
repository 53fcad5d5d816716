"""Flash attention: CUDA forward, dq and dkv kernels, plain versions and
the differentiable ``ops.mha_fused``."""
