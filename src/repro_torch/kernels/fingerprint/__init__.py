from .ops import (SLICE_BYTES, fingerprint_blocks, fingerprint_diff,
                  fingerprint_final, fingerprint_grid, fingerprint_partials,
                  supported_dtype)
from .ref import (fingerprint_blocks_ref, fingerprint_diff_ref,
                  fingerprint_final_ref, fingerprint_partials_ref, fmix32,
                  mix_words, n_blocks_of, slices_per_block, word_bytes,
                  words_per_block)

__all__ = ["SLICE_BYTES", "fingerprint_blocks", "fingerprint_blocks_ref",
           "fingerprint_diff", "fingerprint_diff_ref", "fingerprint_final",
           "fingerprint_final_ref", "fingerprint_grid", "fingerprint_partials",
           "fingerprint_partials_ref", "fmix32", "mix_words", "n_blocks_of",
           "slices_per_block", "supported_dtype", "word_bytes",
           "words_per_block"]
