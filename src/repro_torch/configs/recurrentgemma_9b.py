"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 1:2 [arXiv:2402.19427].

38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000; pattern
(rec, rec, attn) -> 12 full groups + 2 remainder recurrent layers;
local attention window 2048; lru_width == d_model (ssm_expand=1).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab_size=256000,
    attention="sliding", window=2048,
    layer_pattern=("rec", "rec", "attn"),
    ssm_expand=1, conv_width=4,
    rope_theta=10_000.0,
    grad_accum=2,
    source="arXiv:2402.19427",
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke",
    arch_type="hybrid",
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=1, head_dim=32,
    d_ff=256, vocab_size=512,
    attention="sliding", window=16,
    layer_pattern=("rec", "rec", "attn"),
    ssm_expand=1, conv_width=4,
    remat=False,
    source="reduced recurrentgemma family (1 group + 1 tail rec layer)",
)
