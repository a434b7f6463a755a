from .serve_step import (generate, make_decode_step, make_prefill,
                         sample_greedy, state_from_numpy)

__all__ = ["generate", "make_decode_step", "make_prefill", "sample_greedy",
           "state_from_numpy"]
