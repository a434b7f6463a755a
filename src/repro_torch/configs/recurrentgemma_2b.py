"""recurrentgemma-2b [hybrid]: Griffin — RG-LRU + local attention, pattern
(rec, rec, attn). 26L d_model=2560 10H (GQA kv=1) d_ff=7680 vocab=256000,
lru_width=2560, window=2048, head_dim 256. [arXiv:2402.19427; hf]"""

from ..models.config import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000,
    block_pattern=("rglru", "rglru", "local"), window=2048,
    rglru=RGLRUConfig(lru_width=2560, d_conv=4, n_blocks=10),
    act="gelu", mlp_gated=True, tie_embeddings=True,
    notes="26 = 8 (rec,rec,attn) periods + 2 rec remainder; local attn window 2048",
)

SMOKE = CONFIG.scaled(n_layers=5, d_model=80, n_heads=4, n_kv_heads=1,
                      head_dim=16, d_ff=160, vocab_size=512, window=16,
                      rglru=RGLRUConfig(lru_width=80, d_conv=4, n_blocks=4))
