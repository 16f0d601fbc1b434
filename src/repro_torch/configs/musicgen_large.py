"""musicgen-large [audio] — decoder-only over EnCodec tokens [arXiv:2306.05284].

48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048 per codebook, 4 codebooks
(the delay pattern is the data pipeline's). The EnCodec / conditioning
frontend is a stub, as in the JAX package: callers pass 64 precomputed
conditioning embeddings (dim 1024), which the learned projector maps into
the LM stream.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    arch_type="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048,
    n_codebooks=4,
    frontend="audio", frontend_dim=1024, n_frontend_tokens=64,
    rope_theta=10_000.0,
    grad_accum=1,
    source="arXiv:2306.05284",
)

SMOKE = ModelConfig(
    name="musicgen-smoke",
    arch_type="audio",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=128,
    n_codebooks=2,
    frontend="audio", frontend_dim=64, n_frontend_tokens=4,
    remat=False,
    source="reduced musicgen family (2 codebooks)",
)
