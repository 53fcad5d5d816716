"""chameleon-34b — early-fusion VLM; VQ image tokens share the text vocab.
[arXiv:2405.09818; unverified]
48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536

The modality frontend (VQ-GAN image tokenizer) is a STUB per assignment:
`input_specs()` provides precomputed token ids (image tokens are ordinary
vocab entries in early-fusion models, so the backbone is a standard LM).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    head_dim=128,
    rope_theta=10_000.0,
    frontend="vq_tokens",
    source="arXiv:2405.09818",
)
