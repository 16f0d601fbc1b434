"""Prefill bucketing helpers: copies of ``repro.serving.kvcache``'s
``pow2_bucket`` and ``bucketed_prefill_ok``. The paged KV cache
(``BlockAllocator``, ``PagedKVCache``) is ROADMAP Queue 1 item 6.
"""
from __future__ import annotations

from repro_torch.models.config import ModelConfig


def bucketed_prefill_ok(cfg: ModelConfig) -> bool:
    """Whether prefill may pad *tokens* (not just the cache) to a bucket:
    dense full-attention single-codebook models only. Pad tokens trail the
    real ones, so causal attention keeps them out of every real position."""
    return (cfg.arch_type == "dense" and not cfg.window
            and cfg.n_codebooks <= 1)


def pow2_bucket(n: int, floor: int = 16) -> int:
    """Next power-of-two >= n (min ``floor``): the shared padding bucket."""
    n = max(int(n), 1)
    return max(floor, 1 << (n - 1).bit_length())
