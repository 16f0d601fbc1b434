from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_cache,
    init_params,
    prefill,
)

__all__ = [
    "ModelConfig",
    "forward",
    "prefill",
    "decode_step",
    "init_cache",
    "init_params",
]
