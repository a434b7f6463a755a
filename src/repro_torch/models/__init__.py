from .config import ModelConfig, MoEConfig, RGLRUConfig, SSMConfig
from .transformer import forward, init_params, plan_segments

__all__ = ["ModelConfig", "MoEConfig", "RGLRUConfig", "SSMConfig", "forward",
           "init_params", "plan_segments"]
