from repro_torch.core.quant.quantize import (
    QuantConfig,
    dequantize_tensor,
    quantize_tensor,
    quantize_tree,
    tree_size_bytes,
)
from repro_torch.core.quant.calibrate import CalibrationSession

__all__ = [
    "QuantConfig",
    "quantize_tensor",
    "dequantize_tensor",
    "quantize_tree",
    "tree_size_bytes",
    "CalibrationSession",
]
