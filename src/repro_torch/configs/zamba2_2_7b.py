"""zamba2-2.7b — hybrid: Mamba2 blocks + shared attention block every 6th.
[arXiv:2411.15242; hf]
54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    arch_id="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,          # MHA in the shared attention block
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk_size=256),
    # 5 mamba blocks then one shared attention(+MLP) block, cycled (54 = 9*6)
    block_pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "shared_attn"),
    source="arXiv:2411.15242",
)
