"""whisper-medium — encoder-decoder speech model; conv frontend stubbed.
[arXiv:2212.04356; unverified]
24L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=51865

Backbone only: the conv1d/log-mel frontend is a STUB — `input_specs()`
provides precomputed frame embeddings of shape (batch, enc_seq, d_model).
Decoder nominal context is 448 tokens; the assigned 32k decode cells lower
structurally (noted in DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    arch_id="whisper-medium",
    family="audio",
    n_layers=24,            # decoder layers
    n_encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,          # whisper uses MHA (kv == q heads)
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    act="gelu",
    pos_embed="absolute",
    encoder_seq_len=1500,
    frontend="audio_frames",
    source="arXiv:2212.04356",
)
