"""deepseek-7b [dense] — llama-arch [arXiv:2401.02954].

30L d_model=4096 32H (GQA kv=32 => MHA) d_ff=11008 vocab=102400.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    arch_type="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab_size=102400,
    rope_theta=10_000.0,
    grad_accum=2,
    source="arXiv:2401.02954",
)

SMOKE = ModelConfig(
    name="deepseek-7b-smoke",
    arch_type="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=512,
    remat=False,
    source="reduced deepseek-7b family",
)
