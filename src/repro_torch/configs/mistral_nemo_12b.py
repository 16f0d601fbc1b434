"""mistral-nemo-12b [dense] — 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407].

40L d_model=5120 32H (GQA kv=8) head_dim=128 d_ff=14336 vocab=131072,
rope theta 1e6 for long context.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    arch_type="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=131072,
    rope_theta=1_000_000.0,
    grad_accum=2,
    source="hf:mistralai/Mistral-Nemo-Base-2407",
)

SMOKE = ModelConfig(
    name="mistral-nemo-smoke",
    arch_type="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=256, vocab_size=512,
    rope_theta=1_000_000.0,
    remat=False,
    source="reduced mistral-nemo family (GQA 4:2)",
)
