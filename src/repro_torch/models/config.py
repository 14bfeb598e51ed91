"""Model configuration for the assigned architecture pool.

Every architecture in the assignment maps onto one `ModelConfig`. The config
is purely declarative — no jax work happens at import time. Derived
quantities (padded vocab, padded heads, parameter counts) are computed from
shapes only, so the dry-run can reason about full-size models without
allocating them.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional, Tuple

# Block families --------------------------------------------------------------
DENSE = "dense"       # attention + dense MLP
MOE = "moe"           # attention + mixture-of-experts MLP
SSM = "ssm"           # mamba-1 mixer only (no attention, no separate MLP)
HYBRID = "hybrid"     # parallel attention ∥ mamba heads + dense MLP
ENCODER = "encoder"   # bidirectional attention + dense MLP (no decode path)
VLM = "vlm"           # decoder LM with prepended image-patch embeddings


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    vocab_size: int
    # Attention (heads == 0 → attention-free)
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    qkv_bias: bool = False
    sliding_window: int = 0          # 0 → full attention
    rope_theta: float = 10_000.0
    causal: bool = True
    # MLP
    d_ff: int = 0                    # per-expert width for MoE
    mlp_act: str = "silu"            # silu (SwiGLU) | gelu (plain 2-layer)
    # MoE
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    # SSM (mamba-1)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0                 # 0 → d_model // 16
    # Norm
    norm_type: str = "rmsnorm"       # rmsnorm | layernorm | nonparam_ln
    # Embedding
    tie_embeddings: bool = False
    scale_embed: bool = False        # gemma-style sqrt(d_model) scaling
    # VLM / audio frontend stub
    num_prefix_tokens: int = 0       # precomputed patch/frame embeddings
    # Numerics
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # -- derived -------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank_eff(self) -> int:
        return self.dt_rank or max(1, self.d_model // 16)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so it always shards over a
        16-way model axis (hymba 32001→32256, hubert 504→512)."""
        return _round_up(self.vocab_size, 256)

    @property
    def padded_heads(self) -> int:
        """Query heads padded (whole GQA groups kept intact) up to the next
        multiple of 16 when the overhead is ≤ 15%; otherwise unpadded and the
        sharding rules fall back to replicated attention over `model`.

        Padding query heads with zero w_q/w_o rows is function-preserving:
        the extra heads see zero scores (uniform attention) but their w_o
        rows are zero, contributing nothing to the output.
        """
        if self.num_heads == 0 or self.num_heads % 16 == 0:
            return self.num_heads
        kv = max(1, self.num_kv_heads)
        group = self.num_heads // kv
        # grow per-group width until total % 16 == 0, cap overhead at 15%
        for g in range(group + 1, group * 2):
            total = g * kv
            if total % 16 == 0 and total <= math.ceil(self.num_heads * 1.15):
                return total
        return self.num_heads

    @property
    def heads_shardable(self) -> bool:
        return self.padded_heads > 0 and self.padded_heads % 16 == 0

    @property
    def has_attention(self) -> bool:
        return self.family in (DENSE, MOE, HYBRID, ENCODER, VLM)

    @property
    def has_ssm(self) -> bool:
        return self.family in (SSM, HYBRID)

    @property
    def has_mlp(self) -> bool:
        return self.family in (DENSE, HYBRID, ENCODER, VLM)

    @property
    def has_moe(self) -> bool:
        return self.family == MOE

    @property
    def expert_sharding(self) -> str:
        """EP when experts divide the model axis, else per-expert FFN TP."""
        if not self.has_moe:
            return "none"
        return "ep" if self.num_experts % 16 == 0 else "tp"

    @property
    def supports_decode(self) -> bool:
        return self.family != ENCODER

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k: SSM / hybrid / sliding-window attention."""
        if self.family == SSM:
            return True
        if not self.has_attention:
            return True
        return self.sliding_window > 0

    # -- parameter accounting (shape math only) -------------------------------
    def _attn_params(self) -> int:
        if not self.has_attention:
            return 0
        h, kv, hd, m = self.padded_heads, self.num_kv_heads, self.head_dim, self.d_model
        p = m * h * hd + 2 * m * kv * hd + h * hd * m
        if self.qkv_bias:
            p += h * hd + 2 * kv * hd
        return p

    def _mlp_params(self) -> int:
        if not self.has_mlp:
            return 0
        if self.mlp_act == "silu":
            return 3 * self.d_model * self.d_ff
        return 2 * self.d_model * self.d_ff + self.d_ff + self.d_model

    def _moe_params(self) -> int:
        if not self.has_moe:
            return 0
        per_expert = 3 * self.d_model * self.d_ff
        return self.num_experts * per_expert + self.d_model * self.num_experts

    def _ssm_params(self) -> int:
        if not self.has_ssm:
            return 0
        m, di, n, r, c = (self.d_model, self.d_inner, self.ssm_state,
                          self.dt_rank_eff, self.ssm_conv)
        p = m * 2 * di            # in_proj (x, z)
        p += di * c + di          # depthwise conv (+ bias)
        p += di * (r + 2 * n)     # x_proj -> (dt, B, C)
        p += r * di + di          # dt_proj
        p += di * n + di          # A_log, D
        p += di * m               # out_proj
        return p

    def _norm_params(self) -> int:
        if self.norm_type == "nonparam_ln":
            return 0
        per = self.d_model * (2 if self.norm_type == "layernorm" else 1)
        n_norms = 2 if (self.has_mlp or self.has_moe) else 1
        if self.family == HYBRID:
            n_norms = 2
        return per * n_norms

    def param_count(self, padded: bool = False) -> int:
        """Total parameters. padded=False gives the TRUE model size used for
        MODEL_FLOPS = 6·N·D; padded=True matches the allocated tree."""
        vocab = self.padded_vocab if padded else self.vocab_size
        heads_saved = 0
        if not padded and self.padded_heads != self.num_heads:
            hd, m = self.head_dim, self.d_model
            heads_saved = (self.padded_heads - self.num_heads) * hd * m * 2
        per_layer = (self._attn_params() + self._mlp_params()
                     + self._moe_params() + self._ssm_params()
                     + self._norm_params()) - heads_saved
        embed = 0 if self.family == ENCODER else vocab * self.d_model
        head = 0 if self.tie_embeddings else vocab * self.d_model
        final_norm = 0 if self.norm_type == "nonparam_ln" else (
            self.d_model * (2 if self.norm_type == "layernorm" else 1))
        return self.num_layers * per_layer + embed + head + final_norm

    def active_param_count(self) -> int:
        """Activated parameters per token (MoE: top_k of num_experts)."""
        if not self.has_moe:
            return self.param_count()
        full = self.param_count()
        moe_all = self.num_layers * self.num_experts * 3 * self.d_model * self.d_ff
        moe_active = self.num_layers * self.top_k * 3 * self.d_model * self.d_ff
        return full - moe_all + moe_active

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# -- input shapes (assignment) -------------------------------------------------
@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg: ModelConfig, shape: ShapeSpec) -> Tuple[bool, str]:
    """Whether an (arch, shape) cell runs, per the assignment skip rules."""
    if shape.kind == "decode" and not cfg.supports_decode:
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, "long_500k needs sub-quadratic attention (pure full-attention arch)"
    return True, ""
