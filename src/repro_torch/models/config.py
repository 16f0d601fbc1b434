"""Model configuration: the port's own copy of ``repro.models.config``.

Field names and defaults are the JAX dataclass's, so ``configs/*`` copy
verbatim; ``dtype`` stays a string and ``activation_dtype`` maps it to a
``torch.dtype``. Only the dense-GQA, full-attention path with an fp, int8
or int4 KV cache is ported; ``check_supported`` names the ROADMAP item for
everything else.
"""
from __future__ import annotations

import dataclasses
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """The fields this slice reads (plus ``remat`` / ``grad_accum``, which
    the verbatim configs set). Later slices add the MoE, SSM, MLA, hybrid
    and frontend fields of the JAX dataclass with the code that reads
    them."""
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
    # ---- FFN / MoE ----
    d_ff: int = 0
    n_experts: int = 0
    # ---- modality frontend ----
    frontend: str = "none"      # none | vision | audio
    n_frontend_tokens: int = 0
    n_codebooks: int = 0
    # ---- numerics / training ----
    dtype: str = "bfloat16"     # float32 | bfloat16
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    remat: bool = True
    grad_accum: int = 1
    # ---- KV tier and prefill path (same defaults as the JAX package) ----
    kv_cache_int8: bool = False
    kv_cache_precision: str = ""   # "" | fp | int8 | int4
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
    """Raise ``NotImplementedError`` for any branch this slice does not
    port, naming the ROADMAP item that will."""
    if cfg.arch_type != "dense" or cfg.n_experts:
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r}: MoE/SSM/hybrid/VLM/audio stacks "
            "are ROADMAP Queue 1 item 9")
    if cfg.attention != "full":
        raise NotImplementedError(
            f"attention {cfg.attention!r}: MLA and sliding windows are "
            "ROADMAP Queue 1 item 9")
    if cfg.window:
        raise NotImplementedError(
            "sliding-window ring caches are ROADMAP Queue 1 item 9")
    if cfg.frontend != "none" or cfg.n_codebooks > 1:
        raise NotImplementedError(
            "vision/audio frontends and codebooks are ROADMAP Queue 1 item 9")
    if not cfg.opt_flash_prefill:
        raise NotImplementedError(
            "the chunked-query prefill path is ROADMAP Queue 1 item 3; the "
            "flash kernel covers every full-attention prefill")
    if cfg.tie_embeddings:
        raise NotImplementedError(
            "tied embeddings are ROADMAP Queue 1 item 9")
