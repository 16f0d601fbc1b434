"""kimi-k2-1t-a32b [moe] — trillion-param MoE (paper-table) [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8, head_dim 128) d_ff_expert=2048,
384 routed experts top-8 + 1 shared, first layer dense; vocab=163840.
FSDP sharding + grad-accum 8 so optimizer state fits the pod (DESIGN §5).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=2048, d_ff_expert=2048, d_ff_dense=18432,
    n_experts=384, n_shared_experts=1, top_k=8, n_dense_layers=1,
    vocab_size=163840,
    rope_theta=50_000.0,
    fsdp=True, grad_accum=8,
    source="arXiv:2501.kimi2 (assignment paper-table)",
)

SMOKE = ModelConfig(
    name="kimi-k2-smoke",
    arch_type="moe",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=64, d_ff_expert=64, d_ff_dense=256,
    n_experts=4, n_shared_experts=1, top_k=2, n_dense_layers=1,
    vocab_size=512,
    remat=False,
    source="reduced kimi-k2 family (GQA + 4-expert MoE)",
)
