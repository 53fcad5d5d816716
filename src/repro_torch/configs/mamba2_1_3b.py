"""mamba2-1.3b — attention-free SSD (state-space duality) LM.
[arXiv:2405.21060; unverified]
48L d_model=2048 (attn-free) d_ff=0 vocab=50280, ssm_state=128
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,              # attention-free
    n_kv_heads=0,
    d_ff=0,                 # no FFN: mamba blocks only
    vocab_size=50280,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    block_pattern=("mamba",),
    tie_embeddings=True,
    source="arXiv:2405.21060",
)
