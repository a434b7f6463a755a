from .ops import (VARIANTS, flash_attention, flash_attention_bwd,
                  flash_attention_dkv, flash_attention_dq, flash_attention_fwd)
from .ref import (attention_bwd_ref, attention_dkv_ref, attention_dq_ref,
                  attention_ref)

__all__ = ["VARIANTS", "attention_bwd_ref", "attention_dkv_ref", "attention_dq_ref",
           "attention_ref", "flash_attention", "flash_attention_bwd",
           "flash_attention_dkv", "flash_attention_dq", "flash_attention_fwd"]
