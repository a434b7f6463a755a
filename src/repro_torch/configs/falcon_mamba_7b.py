"""falcon-mamba-7b [ssm]: attention-free Mamba-1. 64L d_model=4096
(d_inner=8192, state=16, conv=4, dt_rank=256) vocab=65024. [arXiv:2410.05355]"""

from ..models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv_heads=1, head_dim=1,
    d_ff=0, vocab_size=65024,
    block_pattern=("mamba",),
    ssm=SSMConfig(d_state=16, d_conv=4, expand=2),
)

SMOKE = CONFIG.scaled(n_layers=4, d_model=64, vocab_size=512,
                      ssm=SSMConfig(d_state=4, d_conv=4, expand=2))
