"""llava-next-34b [vlm]: LM backbone only (anyres vision tiling stubbed).
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
[hf:llava-hf/llava-v1.6-*] input_specs() provides precomputed patch+text
embeddings (B,S,7168)."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8, head_dim=128,
    d_ff=20480, vocab_size=64000,
    act="silu", mlp_gated=True, embed_inputs=False,
    notes="vision frontend stubbed: patch embeddings in",
)

SMOKE = CONFIG.scaled(n_layers=4, d_model=64, n_heads=8, n_kv_heads=2,
                      head_dim=8, d_ff=128, vocab_size=512)
