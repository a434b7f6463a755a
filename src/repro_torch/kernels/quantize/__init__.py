from .ops import (absmax, absmax_grid, dequantize_int8, dequantize_int8_many,
                  dequantize_layout, quantize_int8, quantize_with_inv)
from .ref import (absmax_ref, dequantize_int8_ref, quantize_int8_ref,
                  quantize_with_inv_ref)

__all__ = ["absmax", "absmax_grid", "absmax_ref", "dequantize_int8",
           "dequantize_int8_many", "dequantize_int8_ref", "dequantize_layout",
           "quantize_int8", "quantize_int8_ref", "quantize_with_inv",
           "quantize_with_inv_ref"]
