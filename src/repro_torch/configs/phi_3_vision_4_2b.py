"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP frontend (stubbed).

[hf:microsoft/Phi-3-vision-128k-instruct]: 32L d_model=3072 32H (GQA kv=32)
d_ff=8192 vocab=32064. The CLIP ViT-L/14-336 vision tower is a stub, as in
the JAX package: callers pass 576 precomputed patch embeddings (dim 1024)
which the learned projector maps into the LM stream.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32064,
    rope_theta=10_000.0,
    frontend="vision", frontend_dim=1024, n_frontend_tokens=576,
    grad_accum=2,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)

SMOKE = ModelConfig(
    name="phi-3-vision-smoke",
    arch_type="vlm",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=512,
    frontend="vision", frontend_dim=64, n_frontend_tokens=8,
    remat=False,
    source="reduced phi-3-vision family",
)
