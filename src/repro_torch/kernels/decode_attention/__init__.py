from .ops import flash_decode
from .ref import decode_attention_ref

__all__ = ["decode_attention_ref", "flash_decode"]
