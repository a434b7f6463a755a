"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8) d_ff=33792
vocab=256000, no biases, full attention. [hf:CohereForAI/c4ai-command-r-v01]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=33792, vocab_size=256000,
    act="silu", mlp_gated=True,
)

SMOKE = CONFIG.scaled(n_layers=4, d_model=96, n_heads=8, n_kv_heads=2,
                      head_dim=12, d_ff=256, vocab_size=512)
