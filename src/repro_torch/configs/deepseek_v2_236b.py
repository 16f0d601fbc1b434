"""deepseek-v2-236b [moe] — MLA + fine-grained MoE [arXiv:2405.04434].

60L d_model=5120 128H, MLA kv_lora=512 (q_lora=1536, qk_nope=128, qk_rope=64,
v_head=128); MoE: 160 routed experts top-6 + 2 shared, expert d_ff=1536,
first layer dense (d_ff 12288); vocab=102400.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    arch_type="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128,
    attention="mla",
    q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    d_ff=1536, d_ff_expert=1536, d_ff_dense=12288,
    n_experts=160, n_shared_experts=2, top_k=6, n_dense_layers=1,
    vocab_size=102400,
    rope_theta=10_000.0,
    fsdp=True, grad_accum=4,
    source="arXiv:2405.04434",
)

SMOKE = ModelConfig(
    name="deepseek-v2-smoke",
    arch_type="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    attention="mla",
    q_lora_rank=96, kv_lora_rank=64,
    qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32,
    d_ff=64, d_ff_expert=64, d_ff_dense=256,
    n_experts=4, n_shared_experts=1, top_k=2, n_dense_layers=1,
    vocab_size=512,
    remat=False,
    source="reduced deepseek-v2 family (MLA + 4-expert MoE)",
)
