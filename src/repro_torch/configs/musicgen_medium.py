"""musicgen-medium [audio]: decoder-only over EnCodec tokens.
48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048. [arXiv:2306.05284; hf]
Frontend (EnCodec + codebook interleaving) is a stub: input_specs() provides
precomputed frame embeddings (B,S,1536); ungated ReLU MLP per the original;
RMSNorm/RoPE standardized across the zoo (deviation noted)."""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048,
    act="relu", mlp_gated=False, embed_inputs=False,
    notes="audio frontend stubbed: frame embeddings in, EnCodec token logits out",
)

SMOKE = CONFIG.scaled(n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
                      head_dim=16, d_ff=128, vocab_size=256)
