"""mamba2-780m [ssm] — SSD (state-space duality) [arXiv:2405.21060].

48L d_model=1536 (attention-free), d_inner=3072 (expand 2), headdim 64
(=> 48 SSD heads), ssm_state=128, vocab=50280, tied embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    arch_type="ssm",
    n_layers=48, d_model=1536, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1,
    ssm_chunk=256, conv_width=4,
    tie_embeddings=True,
    grad_accum=1,
    source="arXiv:2405.21060",
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    arch_type="ssm",
    n_layers=2, d_model=128, vocab_size=512,
    ssm_state=32, ssm_expand=2, ssm_headdim=32, ssm_ngroups=1,
    ssm_chunk=16, conv_width=4,
    tie_embeddings=True,
    remat=False,
    source="reduced mamba2 family",
)
