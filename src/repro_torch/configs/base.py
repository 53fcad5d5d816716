"""Configuration system for Coyote-JAX.

Every assigned architecture is described by a `ModelConfig`; every assigned
input shape by a `ShapeConfig`.  Configs are plain frozen dataclasses so they
hash cleanly into the shell's compile cache (the "routed & locked checkpoint"
analogue from the paper).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    # layers that are MoE (None -> all); e.g. llama4 interleaves dense/MoE
    moe_layer_period: int = 1  # every k-th layer is MoE
    n_shared_experts: int = 0
    # Switch-style capacity factor; reduced() raises it so tiny smoke
    # batches never drop tokens (decode must match forward exactly)
    capacity_factor: float = 1.25
    # the shared expert's width (0 -> n_shared_experts * d_ff_expert)
    d_ff_shared: int = 0
    # dropless routing (every routed pair computed, no capacity) over the
    # held experts: the first experts_held of the n_experts the router
    # scores (0 -> all).  One
    # chip of an expert-parallel deployment holds such a block and computes
    # only its experts' part of the layer.
    dropless: bool = False
    experts_held: int = 0
    # weight of the load-balancing loss in the training loss
    aux_loss_coef: float = 0.01

    @property
    def shared_width(self) -> int:
        return self.d_ff_shared or self.n_shared_experts * self.d_ff_expert

    @property
    def n_held(self) -> int:
        return self.experts_held or self.n_experts


@dataclass(frozen=True)
class SSMConfig:
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description (exact values from the assignment table)."""

    arch_id: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int          # query heads (0 for attn-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0     # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    swa_window: int = 0   # 0 -> full attention; >0 -> sliding window
    norm_eps: float = 1e-5
    act: str = "silu"     # silu (SwiGLU) | gelu (plain MLP, used by whisper)
    pos_embed: str = "rope"  # rope | absolute (whisper)
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # layer pattern for hybrids: tuple of block kinds cycled over layers
    # e.g. zamba2: 5x mamba + 1 shared attention block
    block_pattern: Tuple[str, ...] = ("attn",)
    # encoder-decoder (whisper): encoder layer count; 0 -> decoder-only
    n_encoder_layers: int = 0
    encoder_seq_len: int = 0  # fixed encoder frames (whisper: 1500)
    # modality frontend stub: "none" | "audio_frames" | "vq_tokens"
    frontend: str = "none"
    dtype: str = "bfloat16"
    source: str = ""
    # muP scalars of the granitemoehybrid family, under its config.json
    # names: embeddings times embedding_multiplier, each layer's mixer and
    # FFN outputs times residual_multiplier, logits over logits_scaling,
    # and attention_multiplier the softmax scale (0 -> 1/sqrt(head_dim))
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    attention_multiplier: float = 0.0

    def __post_init__(self):
        # a configuration read from a file gives its groups as dicts and
        # its pattern as a list
        if isinstance(self.moe, dict):
            object.__setattr__(self, "moe", MoEConfig(**self.moe))
        if isinstance(self.ssm, dict):
            object.__setattr__(self, "ssm", SSMConfig(**self.ssm))
        if isinstance(self.block_pattern, list):
            object.__setattr__(self, "block_pattern",
                               tuple(self.block_pattern))

    # ---- derived ----
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 128 (MXU lane alignment)."""
        return _round_up(self.vocab_size, 128)

    @property
    def attn_scale(self) -> float:
        return self.attention_multiplier or self.resolved_head_dim ** -0.5

    @property
    def per_layer_pattern(self) -> bool:
        """A hybrid whose layers each have their own weights and an FFN
        after every mixer (``"attn"`` and ``"mamba_ffn"`` layers), not
        zamba2's mamba slots around one shared block."""
        return "mamba_ffn" in self.block_pattern

    @property
    def is_attention_free(self) -> bool:
        return all(k == "mamba" for k in self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state is O(1)/O(window) in sequence length."""
        return self.ssm is not None or (self.swa_window > 0)

    def block_kind(self, layer: int) -> str:
        return self.block_pattern[layer % len(self.block_pattern)]

    def layer_kinds(self) -> Tuple[str, ...]:
        return tuple(self.block_kind(i) for i in range(self.n_layers))

    def n_params(self) -> int:
        """Analytic parameter count (total, incl. all experts)."""
        d, hd = self.d_model, self.resolved_head_dim
        n = self.padded_vocab * d  # embed
        if not self.tie_embeddings:
            n += self.padded_vocab * d
        kinds = self.layer_kinds()
        for k in kinds:
            if k in ("attn", "shared_attn"):
                n += d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
                n += (self.n_heads * hd) * d
                if self.qkv_bias:
                    n += (self.n_heads + 2 * self.n_kv_heads) * hd
                n += 2 * d  # norms
            if k in ("mamba", "mamba_ffn"):
                assert self.ssm is not None
                di = self.ssm.d_inner(d)
                nh = self.ssm.n_heads(d)
                n += d * (2 * di + 2 * self.ssm.n_groups * self.ssm.d_state + nh)
                n += di * self.ssm.d_conv + di * d + 2 * nh + d
            # ffn
            if k != "mamba":
                if self.moe is not None and (kinds.index(k) % self.moe.moe_layer_period == 0):
                    pass  # handled below per-layer
                else:
                    pass
        # FFN counted per layer explicitly:
        for i, k in enumerate(kinds):
            if k == "mamba":
                continue
            if self.moe is not None and (i % self.moe.moe_layer_period == 0):
                e = self.moe
                n += e.n_held * 3 * d * e.d_ff_expert + d * e.n_experts
                n += 3 * d * e.shared_width
            else:
                mult = 3 if self.act == "silu" else 2
                n += mult * d * self.d_ff
        n += d  # final norm
        if self.n_encoder_layers:
            # encoder layers: attn + ffn
            per = d * (self.n_heads * hd) * 2 + 2 * d * (self.n_kv_heads * hd)
            per += (3 if self.act == "silu" else 2) * d * self.d_ff + 2 * d
            n += self.n_encoder_layers * per
            # decoder cross-attention blocks
            n += self.n_layers * (2 * d * (self.n_heads * hd) +
                                  2 * d * (self.n_kv_heads * hd) + d)
        return n

    def n_active_params(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.n_params()
        e = self.moe
        total = self.n_params()
        kinds = self.layer_kinds()
        inactive = 0
        for i, k in enumerate(kinds):
            if k == "mamba":
                continue
            if i % e.moe_layer_period == 0:
                inactive += (e.n_experts - e.top_k) * 3 * self.d_model * e.d_ff_expert
        return total - inactive

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        period = len(self.block_pattern)
        kw = dict(
            n_layers=min(self.n_layers, (1 if self.per_layer_pattern else 2)
                         * period),
            d_model=128,
            n_heads=4 if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=256,
            vocab_size=512,
            head_dim=32 if self.n_heads else 0,
            swa_window=min(self.swa_window, 64) if self.swa_window else 0,
            encoder_seq_len=min(self.encoder_seq_len, 32) if self.encoder_seq_len else 0,
            n_encoder_layers=min(self.n_encoder_layers, 2),
        )
        if self.moe is not None and self.moe.dropless:
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=8, top_k=min(self.moe.top_k, 2),
                d_ff_expert=64, d_ff_shared=128 if self.moe.d_ff_shared else 0,
                experts_held=min(self.moe.experts_held, 2))
        elif self.moe is not None:
            kw["moe"] = MoEConfig(
                n_experts=4, top_k=min(self.moe.top_k, 2), d_ff_expert=64,
                moe_layer_period=self.moe.moe_layer_period,
                n_shared_experts=min(self.moe.n_shared_experts, 1),
                capacity_factor=8.0)
        if self.ssm is not None:
            kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=32,
                                  n_groups=1, chunk_size=32)
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    """Assigned input shape.  kind: train | prefill | decode."""
    name: str
    kind: str
    seq_len: int
    global_batch: int

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32_768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32_768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524_288, 1)

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shape_applicable(model: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether a (arch x shape) cell runs, per assignment rules."""
    if shape.name == "long_500k" and not model.sub_quadratic:
        return False, ("long_500k requires sub-quadratic attention; "
                       f"{model.arch_id} is full-attention (see DESIGN.md §5)")
    return True, ""
