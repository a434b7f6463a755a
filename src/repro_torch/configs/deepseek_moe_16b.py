"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (MHA kv=16) vocab=102400.
Fine-grained MoE: 64 routed experts top-6 + 2 shared, d_expert=1408; layer 0
is a dense-MLP prelude (d_ff 10944). [arXiv:2401.06066; hf]"""

from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=102400,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                  dense_prelude_layers=1, d_ff_prelude=10944),
    act="silu", mlp_gated=True,
)

SMOKE = CONFIG.scaled(
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=96, vocab_size=512,
    moe=MoEConfig(n_experts=8, top_k=2, d_expert=96, n_shared=1,
                  dense_prelude_layers=1, d_ff_prelude=128, capacity_factor=4.0))
