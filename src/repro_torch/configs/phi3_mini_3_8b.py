"""phi3-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2404.14219].

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-mini-3.8b",
    arch_type="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32064,
    rope_theta=10_000.0,
    grad_accum=1,
    source="arXiv:2404.14219",
)

SMOKE = ModelConfig(
    name="phi3-mini-smoke",
    arch_type="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=512,
    remat=False,
    source="reduced phi3-mini family",
)
