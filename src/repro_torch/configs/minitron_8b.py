"""minitron-8b [dense]: pruned Nemotron. 32L d_model=4096 32H (GQA kv=8)
d_ff=16384 vocab=256000, squared-ReLU ungated MLP. [arXiv:2407.14679; hf]"""

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab_size=256000,
    act="relu2", mlp_gated=False,
)

SMOKE = CONFIG.scaled(n_layers=4, d_model=64, n_heads=8, n_kv_heads=2,
                      head_dim=8, d_ff=256, vocab_size=512)
