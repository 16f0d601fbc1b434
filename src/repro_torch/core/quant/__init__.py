from repro_torch.core.quant.quantize import (
    QuantConfig,
    dequantize_tensor,
    percentile,
    quant_values,
    quantize_tensor,
    quantize_tree,
    quantized_size_bytes,
    tree_size_bytes,
)
from repro_torch.core.quant.calibrate import CalibrationSession

__all__ = [
    "QuantConfig",
    "quantize_tensor",
    "dequantize_tensor",
    "quantize_tree",
    "quant_values",
    "percentile",
    "tree_size_bytes",
    "quantized_size_bytes",
    "CalibrationSession",
]
