"""gemma3-1b [dense]: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144.
5:1 local:global attention, sliding window 512, RoPE theta 10k local / 1M
global, head_dim 256 (independent of d_model). [hf:google/gemma-3-1b-pt]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, head_dim=256,
    d_ff=6912, vocab_size=262144,
    block_pattern=("local",) * 5 + ("global",), window=512,
    rope_theta=10_000.0, rope_theta_global=1_000_000.0,
    act="gelu", mlp_gated=True, tie_embeddings=True,
    notes="26 = 4 full (5L+1G) periods + 2 local remainder",
)

SMOKE = CONFIG.scaled(n_layers=8, d_model=64, n_heads=4, n_kv_heads=1,
                      head_dim=16, d_ff=128, vocab_size=512, window=16,
                      block_pattern=("local",) * 2 + ("global",))
