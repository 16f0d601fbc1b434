"""stablelm-1.6b [dense] — [hf:stabilityai/stablelm-2-1_6b].

24L d_model=2048 32H (GQA kv=32) head_dim=64 d_ff=5632 vocab=100352.
(stablelm-2 uses partial-rotary; full RoPE is applied, as in the JAX
package.)
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-1.6b",
    arch_type="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=5632, vocab_size=100352,
    rope_theta=10_000.0,
    grad_accum=1,
    source="hf:stabilityai/stablelm-2-1_6b",
)

SMOKE = ModelConfig(
    name="stablelm-smoke",
    arch_type="dense",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=512,
    remat=False,
    source="reduced stablelm family",
)
