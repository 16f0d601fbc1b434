from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (
    decode_step,
    decode_step_paged,
    forward,
    init_cache,
    init_params,
    prefill,
    prefill_paged,
    verify_step,
    verify_step_paged,
)

__all__ = [
    "ModelConfig",
    "forward",
    "prefill",
    "decode_step",
    "prefill_paged",
    "decode_step_paged",
    "verify_step",
    "verify_step_paged",
    "init_cache",
    "init_params",
]
