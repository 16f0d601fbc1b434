"""Model configuration: the port's own copy of ``repro.models.config``.

Every field of the JAX dataclass, with the same names and defaults, so the
``configs/*`` modules copy verbatim and a checkpoint manifest written by
either package (``dataclasses.asdict(cfg)``) loads in the other with
``ModelConfig(**mc)``. ``dtype`` stays a string and ``activation_dtype``
maps it to a ``torch.dtype``. Only the dense-GQA, full-attention stack is
ported (with an fp, int8 or int4 KV cache, the flash or the chunked
prefill, and the phi-3-vision frontend stub); ``check_supported`` names
the ROADMAP item for everything else.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str              # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    vocab_size: int
    # ---- attention ----
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0           # 0 -> d_model // n_heads
    attention: str = "full"     # full | sliding | mla | none
    window: int = 0             # sliding-window size
    rope_theta: float = 10_000.0
    # ---- MLA (deepseek-v2 family) ----
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # ---- FFN ----
    d_ff: int = 0
    # ---- MoE ----
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    d_ff_dense: int = 0
    n_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3
    # ---- SSM (mamba2 SSD) ----
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_chunk: int = 256
    conv_width: int = 4
    # ---- hybrid (recurrentgemma / griffin) ----
    layer_pattern: Tuple[str, ...] = ()
    rglru_c: float = 8.0
    # ---- modality frontend (a stub: precomputed embeddings, projected) ----
    frontend: str = "none"      # none | vision | audio
    frontend_dim: int = 0       # width of the frontend's embeddings
    n_frontend_tokens: int = 0  # patch / conditioning tokens prepended
    n_codebooks: int = 0
    # ---- numerics / training ----
    dtype: str = "bfloat16"     # float32 | bfloat16
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    remat: bool = True
    grad_accum: int = 1
    # ---- long-context override ----
    long_context_window: int = 4096
    # ---- distribution ----
    fsdp: bool = False
    # ---- KV tier, prefill path and the JAX package's perf knobs (same
    # defaults) ----
    opt_attn_accum: bool = False
    kv_cache_int8: bool = False
    kv_cache_precision: str = ""   # "" | fp | int8 | int4
    opt_mla_absorb: bool = False
    opt_moe_shardmap: bool = False
    opt_flash_prefill: bool = True
    # ---- provenance ----
    source: str = ""

    @property
    def kv_precision(self) -> str:
        """Resolved KV-cache tier: ``kv_cache_precision`` when set (must be
        fp / int8 / int4), else the legacy ``kv_cache_int8`` bool."""
        if self.kv_cache_precision:
            if self.kv_cache_precision not in ("fp", "int8", "int4"):
                raise ValueError(
                    f"kv_cache_precision must be fp|int8|int4, got "
                    f"{self.kv_cache_precision!r}")
            return self.kv_cache_precision
        return "int8" if self.kv_cache_int8 else "fp"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        if self.n_heads:
            return self.d_model // self.n_heads
        return 0

    @property
    def activation_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for any branch the port does not serve
    yet, naming the ROADMAP item that will."""
    if cfg.arch_type not in ("dense", "vlm") or cfg.n_experts \
            or cfg.layer_pattern:
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r}: MoE/SSM/hybrid/audio stacks are "
            "ROADMAP Queue 1 item 9")
    if cfg.attention != "full":
        raise NotImplementedError(
            f"attention {cfg.attention!r}: MLA and sliding windows are "
            "ROADMAP Queue 1 item 9")
    if cfg.window:
        raise NotImplementedError(
            "sliding-window ring caches are ROADMAP Queue 1 item 9")
    if cfg.frontend not in ("none", "vision") or cfg.n_codebooks > 1:
        raise NotImplementedError(
            "audio frontends and codebooks are ROADMAP Queue 1 item 9")
    if (cfg.arch_type == "vlm") != (cfg.frontend == "vision") \
            or (cfg.frontend == "vision" and cfg.frontend_dim <= 0):
        raise ValueError(
            f"{cfg.name}: a vlm needs frontend='vision' and frontend_dim > 0, "
            "and only a vlm has a vision frontend")
    if cfg.fsdp:
        raise NotImplementedError(
            "fsdp weight sharding is ROADMAP Queue 1 item 10")
    if cfg.tie_embeddings:
        raise NotImplementedError(
            "tied embeddings are ROADMAP Queue 1 item 9")
