"""Model configuration dataclasses for the assigned architecture pool."""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int                 # routed experts
    top_k: int
    d_expert: int                  # per-expert ffn hidden dim
    n_shared: int = 0              # always-on shared experts (same d_expert)
    capacity_factor: float = 1.25
    dense_prelude_layers: int = 0  # leading dense layers (DeepSeek-MoE layer 0)
    d_ff_prelude: int = 0
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0               # 0 -> d_model // 16

    def resolved_dt_rank(self, d_model: int) -> int:
        return self.dt_rank or max(d_model // 16, 1)


@dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0             # 0 -> d_model
    d_conv: int = 4
    n_blocks: int = 0              # block-diagonal gate blocks (0 -> n_heads)


@dataclass(frozen=True)
class ModelConfig:
    """One architecture. `block_pattern` is cycled to n_layers; entries are
    "global" (full causal attn), "local" (sliding window), "mamba", "rglru"."""

    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    block_pattern: tuple[str, ...] = ("global",)
    window: int = 0
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    rglru: RGLRUConfig | None = None
    rope_theta: float = 10_000.0
    rope_theta_global: float = 0.0  # per-layer theta for "global" layers (gemma3); 0 -> rope_theta
    norm_eps: float = 1e-6
    act: str = "silu"              # silu | gelu | relu | relu2
    mlp_gated: bool = True
    embed_inputs: bool = True      # False: modality frontend stub provides embeddings
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    notes: str = ""

    # -- derived ---------------------------------------------------------------

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    def layer_kinds(self) -> tuple[str, ...]:
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    @property
    def is_attention_free(self) -> bool:
        return all(k == "mamba" for k in self.layer_kinds())

    @property
    def has_full_attention(self) -> bool:
        return any(k == "global" for k in self.layer_kinds())

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs eligible for the long_500k shape: SSM, hybrid
        recurrent, and local-attention-dominated (gemma3's 5:1 local:global —
        its decode cost is O(window) on 5/6 of layers)."""
        kinds = self.layer_kinds()
        n_full = sum(k == "global" for k in kinds)
        return n_full == 0 or (self.window > 0 and n_full / len(kinds) <= 0.25)

    def scaled(self, **overrides) -> "ModelConfig":
        """Reduced config of the same family (smoke tests)."""
        return replace(self, **overrides)

    def param_count(self) -> int:
        """Analytic parameter count (embedding included once if tied)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        n_mlp_mats = 3 if self.mlp_gated else 2
        total = 0
        for kind in self.layer_kinds():
            if kind in ("global", "local"):
                attn = D * self.q_dim + 2 * D * self.kv_dim + self.q_dim * D
                total += attn + 2 * D  # norms
                if self.moe is not None:
                    m = self.moe
                    total += D * m.n_experts
                    total += (m.n_experts + m.n_shared) * n_mlp_mats * D * m.d_expert
                else:
                    total += n_mlp_mats * D * F
            elif kind == "mamba":
                s = self.ssm or SSMConfig()
                di = s.expand * D
                dt = s.resolved_dt_rank(D)
                total += D * 2 * di + di * s.d_conv + di * (dt + 2 * s.d_state)
                total += dt * di + di * s.d_state + di + di * D + D
            elif kind == "rglru":
                r = self.rglru or RGLRUConfig()
                W = r.lru_width or D
                nb = r.n_blocks or self.n_heads
                total += 2 * D * W + W * r.d_conv + W * D + 2 * D
                total += 2 * nb * (W // nb) * (W // nb) + 3 * W  # gates + lambda + biases
                total += n_mlp_mats * D * F + D if F else 0
        total += D  # final norm
        if self.embed_inputs:
            total += V * D
        total += 0 if self.tie_embeddings and self.embed_inputs else V * D  # lm head
        return total
