"""llama4-scout-17b-a16e — MoE (16 experts, top-1) + shared expert,
early-fusion multimodal (vision frontend stubbed).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16e top-1
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,              # per-expert FFN width
    vocab_size=202048,
    head_dim=128,
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192,
                  n_shared_experts=1),
    frontend="vq_tokens",   # early fusion; image tokens precomputed (stub)
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
