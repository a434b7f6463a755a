from .ops import (absmax, dequantize_int8, dequantize_int8_many, quantize_int8,
                  quantize_with_inv)
from .ref import (absmax_ref, dequantize_int8_ref, quantize_int8_ref,
                  quantize_with_inv_ref)

__all__ = ["absmax", "absmax_ref", "dequantize_int8", "dequantize_int8_many",
           "dequantize_int8_ref", "quantize_int8", "quantize_int8_ref",
           "quantize_with_inv", "quantize_with_inv_ref"]
