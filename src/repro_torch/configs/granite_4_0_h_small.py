"""granite-4.0-h-small — hybrid: Mamba-2 and GQA attention mixers, each
followed by a mixture of 72 SwiGLU experts (top-10) beside a shared one.
[hf:ibm-granite/granite-4.0-h-small config.json, model_type granitemoehybrid]
40L d_model=4096; 36 Mamba-2 (128 heads of 64, d_state 128, one group,
chunk 256, conv 4 with bias) and 4 attention layers (32H, GQA kv=8, head
128, no positional encoding), attention at layers 5, 15, 25, 35; experts
72 x 768, shared 1536; tied vocab 100352; muP scalars: embeddings x 12,
residual branches x 0.22, logits / 16, softmax scale 1/128.

Not one of the JAX package's architectures: ``configs.EXTRA_ARCHS``.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

M, A = "mamba_ffn", "attn"

CONFIG = ModelConfig(
    arch_id="granite-4.0-h-small",
    family="hybrid",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=768,               # per-expert FFN width
    vocab_size=100352,
    head_dim=128,
    pos_embed="none",
    tie_embeddings=True,
    moe=MoEConfig(n_experts=72, top_k=10, d_ff_expert=768, d_ff_shared=1536,
                  dropless=True, aux_loss_coef=0.001),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk_size=256),
    block_pattern=(M, M, M, M, M, A, M, M, M, M),
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    logits_scaling=16.0,
    attention_multiplier=0.0078125,
    source="hf:ibm-granite/granite-4.0-h-small",
)
