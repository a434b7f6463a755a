from .config import ModelConfig, MoEConfig, RGLRUConfig, SSMConfig
from .transformer import (decode_step, forward, init_cache, init_params,
                          plan_segments, prefill)

__all__ = ["ModelConfig", "MoEConfig", "RGLRUConfig", "SSMConfig",
           "decode_step", "forward", "init_cache", "init_params",
           "plan_segments", "prefill"]
