from .ops import (decode_merge, decode_partials, decode_splits, decode_tile,
                  flash_decode)
from .ref import decode_attention_ref, decode_merge_ref, decode_partials_ref

__all__ = ["decode_attention_ref", "decode_merge", "decode_merge_ref",
           "decode_partials", "decode_partials_ref", "decode_splits",
           "decode_tile", "flash_decode"]
