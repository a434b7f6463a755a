"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072,
8 experts top-2 (no shared). [hf:xai-org/grok-1]"""

from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab_size=131072,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=32768),
    act="gelu", mlp_gated=True,
)

SMOKE = CONFIG.scaled(
    n_layers=3, d_model=64, n_heads=8, n_kv_heads=2, head_dim=8,
    d_ff=128, vocab_size=512,
    moe=MoEConfig(n_experts=4, top_k=2, d_expert=128, capacity_factor=2.0))
