"""Model configuration: the port's own copy of ``repro.models.config``.

Every field of the JAX dataclass, with the same names and defaults, so the
``configs/*`` modules copy verbatim and a checkpoint manifest written by
either package (``dataclasses.asdict(cfg)``) loads in the other with
``ModelConfig(**mc)``. ``dtype`` stays a string and ``activation_dtype``
maps it to a ``torch.dtype``. The ported stacks: dense GQA (with an fp,
int8 or int4 KV cache, the flash or the chunked prefill, a sliding-window
ring cache, and the phi-3-vision frontend stub), Multi-head Latent
Attention (deepseek-v2), the capacity-routed MoE FFN (deepseek-v2,
kimi-k2), Mamba2's SSD stack (mamba2-780m) and the RG-LRU hybrid of
recurrentgemma with tied embeddings, and musicgen's audio conditioning
stub with its ``n_codebooks`` token streams; ``check_supported`` refuses
what none of them assembles.
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

    def for_long_context(self) -> "ModelConfig":
        """The sub-quadratic variant of the long-context shape: SSM and
        hybrid stacks (and a model that already has a window) as they are,
        a full-attention model with a sliding window of
        ``long_context_window``."""
        if self.arch_type in ("ssm", "hybrid") or self.window:
            return self
        return self.with_overrides(window=self.long_context_window)

    def layer_types(self) -> Tuple[str, ...]:
        """Per-layer mixer type, length == n_layers."""
        if self.arch_type == "ssm":
            return ("ssm",) * self.n_layers
        if self.layer_pattern:
            pat = self.layer_pattern
            return tuple(pat[i % len(pat)] for i in range(self.n_layers))
        return ("attn",) * self.n_layers

    def is_moe_layer(self, i: int) -> bool:
        return self.n_experts > 0 and i >= self.n_dense_layers

    @property
    def d_inner(self) -> int:
        """Inner width of SSM / recurrent blocks."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    def param_count(self, active_only: bool = False) -> int:
        """Parameters (``active_only``: the experts a token reaches, top-k
        of them), the JAX package's integer arithmetic term for term."""
        d, hd = self.d_model, self.resolved_head_dim
        n = self.vocab_size * d
        if not self.tie_embeddings:
            n += d * self.vocab_size
        if self.n_codebooks:
            n += (self.n_codebooks - 1) * self.vocab_size * d
        for i, lt in enumerate(self.layer_types()):
            n += 2 * d
            if lt == "attn":
                if self.attention == "mla":
                    qdim = self.qk_nope_dim + self.qk_rope_dim
                    if self.q_lora_rank:
                        n += (d * self.q_lora_rank
                              + self.q_lora_rank * self.n_heads * qdim)
                    else:
                        n += d * self.n_heads * qdim
                    n += d * self.kv_lora_rank + d * self.qk_rope_dim
                    n += self.kv_lora_rank * self.n_heads * (
                        self.qk_nope_dim + self.v_head_dim)
                    n += self.n_heads * self.v_head_dim * d
                else:
                    n += d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                    n += self.n_heads * hd * d
            elif lt == "ssm":
                din = self.d_inner
                zxbcdt = (2 * din + 2 * self.ssm_ngroups * self.ssm_state
                          + self.ssm_nheads)
                n += d * zxbcdt + din * d
                n += self.conv_width * (din + 2 * self.ssm_ngroups
                                        * self.ssm_state)
                n += 3 * self.ssm_nheads
            elif lt == "rec":
                din = self.d_inner
                n += 2 * d * din + din * d
                n += self.conv_width * din
                n += 2 * din * (din // 8) + 2 * din
                n += din
            if lt != "ssm" and self.d_ff + self.d_ff_expert > 0:
                if self.is_moe_layer(i):
                    ff = self.d_ff_expert or self.d_ff
                    n_e = self.top_k if active_only else self.n_experts
                    n += n_e * 3 * d * ff
                    n += self.n_shared_experts * 3 * d * ff
                    n += d * self.n_experts
                else:
                    ff = self.d_ff_dense or self.d_ff
                    n += 3 * d * ff
        return n


#: the one layer pattern the hybrid stack assembles: (rec, rec, attn)
#: groups, then the remainder as recurrent tail layers
HYBRID_PATTERN = ("rec", "rec", "attn")


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a stack the port does not assemble
    and ``ValueError`` for an inconsistent config."""
    # an "moe" config with n_experts=0 is a dense stack, as the JAX
    # package builds it (its stacks follow n_experts; tensor-parallel
    # serving shards deepseek-v2's MLA attention so)
    if cfg.arch_type not in ("dense", "vlm", "audio", "moe", "ssm",
                             "hybrid") \
            or (cfg.n_experts > 0 and cfg.arch_type != "moe"):
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r} (n_experts={cfg.n_experts}) is "
            "not a stack the port assembles")
    if (cfg.arch_type == "hybrid") != bool(cfg.layer_pattern) or (
            cfg.layer_pattern and tuple(cfg.layer_pattern) != HYBRID_PATTERN):
        raise NotImplementedError(
            f"layer_pattern {cfg.layer_pattern!r}: the hybrid stack is "
            f"{HYBRID_PATTERN} groups, and only a hybrid has a pattern")
    if cfg.attention not in ("full", "mla", "sliding"):
        raise NotImplementedError(f"attention {cfg.attention!r}")
    if cfg.arch_type == "ssm" and (cfg.ssm_state <= 0 or cfg.ssm_nheads <= 0):
        raise ValueError(f"{cfg.name}: an ssm stack needs ssm_state > 0 and "
                         "ssm_headdim dividing d_inner")
    if cfg.attention == "sliding" and cfg.window <= 0:
        raise ValueError(f"{cfg.name}: attention='sliding' needs window > 0")
    if (cfg.arch_type == "vlm") != (cfg.frontend == "vision") \
            or (cfg.frontend != "none" and cfg.frontend_dim <= 0):
        raise ValueError(
            f"{cfg.name}: a vlm needs frontend='vision', a frontend needs "
            "frontend_dim > 0, and only a vlm has a vision frontend")
    # ``fsdp`` only names a sharding under a training mesh (what is left of
    # ROADMAP Queue 1 item 10: the GSPMD rules); serving shards with
    # ``serving.sharded`` and ignores it, as in the JAX package
