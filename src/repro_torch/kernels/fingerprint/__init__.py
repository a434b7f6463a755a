from .ops import fingerprint_blocks, fingerprint_diff, supported_dtype
from .ref import (fingerprint_blocks_ref, fingerprint_diff_ref, fmix32,
                  mix_words, n_blocks_of, word_bytes, words_per_block)

__all__ = ["fingerprint_blocks", "fingerprint_blocks_ref", "fingerprint_diff",
           "fingerprint_diff_ref", "fmix32", "mix_words", "n_blocks_of",
           "supported_dtype", "word_bytes", "words_per_block"]
