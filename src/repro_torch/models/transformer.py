"""Dense decoder: the port of ``repro.models.transformer`` (dense stack).

Param tree (per-layer, not stacked; leaf paths match the JAX tree's with a
layer index, e.g. ``layers/3/attn/wq``, so quantization and calibration
regexes select the same leaves)::

    embed [V, d], final_norm [d], unembed [d, V]
    frontend_proj [frontend_dim, d]        (vlm: the vision stub projector)
    layers: [ {ln1 [d], attn {wq, wk, wv, wo}, ln2 [d], mlp {wi, wo}} ] * L

Entry points:
    forward(params, batch, cfg)                  -> (logits, aux)
    prefill(params, batch, cfg, pad_to, n_valid) -> (logits, cache)
    decode_step(params, cache, tokens, pos, cfg) -> (logits, cache)
    prefill_paged(params, pools, batch, pos, tables, cfg)    -> (logits, pools)
    decode_step_paged(params, pools, tokens, pos, tables, cfg) -> (logits, pools)
    verify_step(params, cache, tokens, pos, cfg)  -> (logits [B,M,V], cache)
    verify_step_paged(params, pools, tokens, pos, tables, cfg) -> (logits, pools)

A Python loop over the layers stands in for the JAX ``scan``. In train
mode with ``cfg.remat`` and grad mode on, each layer runs under
``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint`` per
scanned layer): the backward recomputes it, flash kernel launch included.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.quantize import kv_group_size
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig, check_supported
from repro_torch.models.layers import (dense_init, embed_init, linear,
                                       rms_norm, swiglu)


def _zero_aux(device) -> Dict[str, torch.Tensor]:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"lb_loss": z, "z_loss": z, "fraction_dropped": z}


# ===================================================================== #
# Init
# ===================================================================== #
def _init_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, dt = cfg.d_model, cfg.activation_dtype
    return {
        "ln1": torch.zeros((d,), dtype=dt, device=gen.device),
        "attn": attn.init_gqa_params(gen, cfg),
        "ln2": torch.zeros((d,), dtype=dt, device=gen.device),
        "mlp": {"wi": dense_init(gen, (d, 2 * cfg.d_ff), dtype=dt),
                "wo": dense_init(gen, (cfg.d_ff, d), dtype=dt)},
    }


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random weights drawn on ``device`` (default: the card) from a
    ``torch.Generator`` seeded with ``seed``."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = cfg.activation_dtype
    p = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
        "unembed": dense_init(gen, (cfg.d_model, cfg.vocab_size), dtype=dt),
    }
    if cfg.frontend != "none":
        p["frontend_proj"] = dense_init(
            gen, (cfg.frontend_dim, cfg.d_model), dtype=dt)
    p["layers"] = [_init_block(gen, cfg) for _ in range(cfg.n_layers)]
    return p


# ===================================================================== #
# Embedding / head
# ===================================================================== #
def _take_embed(leaf, tokens, dtype):
    """Embedding gather, aware of quantized and observer leaves. Quantized
    rows dequantize after the gather (minus the zero point when
    asymmetric); a grouped scale runs over the vocab axis, so row v takes
    ``scale[v // g, 0]``."""
    if isinstance(leaf, dict) and ("w_int8" in leaf or "w_int4" in leaf):
        vals = leaf.get("w_int8", leaf.get("w_int4"))
        rows = vals[tokens].to(torch.float32)
        if "zero" in leaf:
            rows = rows - leaf["zero"][0]
        scale = leaf["scale"]
        if scale.dim() == vals.dim() + 1:
            g = vals.shape[0] // scale.shape[0]
            row_scale = scale[:, 0][torch.div(tokens, g,
                                              rounding_mode="floor")]
        else:
            row_scale = scale[0]
        return (rows * row_scale).to(dtype)
    if isinstance(leaf, dict) and "w" in leaf:
        leaf = leaf["w"]
    return leaf[tokens].to(dtype)


def embed_inputs(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Token embeddings; with a frontend and ``batch["frontend_embeds"]``
    ([B, n_frontend_tokens, frontend_dim]), the projected embeddings are
    put in front of them, so positions 0.. are the patches."""
    x = _take_embed(params["embed"], batch["tokens"], cfg.activation_dtype)
    if cfg.frontend != "none" and "frontend_embeds" in batch:
        fe = linear(params["frontend_proj"],
                    batch["frontend_embeds"].to(x.dtype))
        x = torch.cat([fe, x], dim=1)
    return x


def lm_head(params, x, cfg: ModelConfig):
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    return linear(params["unembed"], x).to(torch.float32)


# ===================================================================== #
# Passes
# ===================================================================== #
def _block(lp, x, cfg: ModelConfig, *, mode: str, cache=None,
           positions=None, pos=None, pad_to: int = 0, tables=None):
    h = rms_norm(lp["ln1"], x, cfg.norm_eps)
    if mode == "verify":
        # speculative decoding: score k+1 candidate positions in one pass
        if tables is not None:
            a_out, new_cache = attn.gqa_verify_paged(lp["attn"], h, cache,
                                                     pos, tables, cfg)
        else:
            a_out, new_cache = attn.gqa_verify(lp["attn"], h, cache, pos, cfg)
    elif mode == "decode" and tables is not None:
        # paged decode: pooled cache leaves read through block tables
        a_out, new_cache = attn.gqa_decode_paged(lp["attn"], h, cache, pos,
                                                 tables, cfg)
    elif mode == "decode":
        a_out, new_cache = attn.gqa_decode(lp["attn"], h, cache, pos, cfg)
    elif tables is not None:
        # paged cold prefill: K/V go straight into the block pools
        a_out, new_cache = attn.gqa_prefill_paged(lp["attn"], h, positions,
                                                  cache, pos, tables, cfg)
    else:
        a_out, new_cache = attn.gqa_prefill(lp["attn"], h, positions, cfg,
                                            pad_to=pad_to)
    x = x + a_out
    h2 = rms_norm(lp["ln2"], x, cfg.norm_eps)
    return x + swiglu(lp["mlp"]["wi"], lp["mlp"]["wo"], h2), new_cache


def _train_block(lp, x, cfg: ModelConfig, positions):
    return _block(lp, x, cfg, mode="train", positions=positions)[0]


def _backbone(params, x, cfg: ModelConfig, *, mode: str, caches=None,
              pos=None, pad_to: int = 0, tables=None):
    """``tables`` (paged prefill / decode) is shared by every layer: block
    ids are per sequence, not per layer."""
    check_supported(cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    new = []
    for i, lp in enumerate(params["layers"]):
        if remat:
            # one activation checkpoint per layer, as jax.checkpoint wraps
            # each scanned layer: the backward recomputes the layer
            x = checkpoint(_train_block, lp, x, cfg, positions,
                           use_reentrant=False, preserve_rng_state=False)
            new.append(None)
            continue
        cache = None if caches is None else caches["layers"][i]
        x, c = _block(lp, x, cfg, mode=mode, cache=cache, positions=positions,
                      pos=pos, pad_to=pad_to, tables=tables)
        new.append(c)
    return x, {"layers": new}


def forward(params, batch, cfg: ModelConfig):
    """Teacher-forced pass: (logits [B,S,V] f32, aux)."""
    x = embed_inputs(params, batch, cfg)
    x, _ = _backbone(params, x, cfg, mode="train")
    return lm_head(params, x, cfg), _zero_aux(x.device)


def prefill(params, batch, cfg: ModelConfig, pad_to: int = 0, n_valid=None):
    """(logits at the last real position [B,1,V], cache). ``pad_to``
    reserves cache slots for decode (default: seq + 64). ``n_valid`` marks
    the real token count when the token axis is bucket-padded: logits come
    from position ``n_valid - 1`` (clamped into the sequence, as
    ``dynamic_slice`` does); causal attention keeps the trailing pads out
    of every real position's context."""
    x = embed_inputs(params, batch, cfg)
    if not pad_to:
        pad_to = x.shape[1] + 64
    x, caches = _backbone(params, x, cfg, mode="prefill", pad_to=pad_to)
    if n_valid is None:
        last = x[:, -1:]
    else:
        i = min(max(int(n_valid) - 1, 0), x.shape[1] - 1)
        last = x[:, i:i + 1]
    return lm_head(params, last, cfg), caches


def decode_step(params, caches, tokens, pos, cfg: ModelConfig):
    """tokens [B,1]; pos: int or [B] position of this token. The cache is
    updated in place and returned."""
    x = embed_inputs(params, {"tokens": tokens}, cfg)
    x, caches = _backbone(params, x, cfg, mode="decode", caches=caches, pos=pos)
    return lm_head(params, x, cfg), caches


def prefill_paged(params, caches, batch, pos, tables, cfg: ModelConfig):
    """Paged cold prefill: run the prompt once and write every layer's K/V
    straight into the pools through the per-sequence block table.
    ``caches`` are the pools (``{"layers": [(k_pool, v_pool), ...]}``,
    updated in place), ``tables`` [B, max_blocks] int32 (the scheduler
    allocates the prompt's blocks first) and ``pos`` the valid-token count:
    the token axis may be bucket-padded, and pad positions write to the
    trash block. Returns (logits at ``pos - 1`` [B,1,V], pools)."""
    x = embed_inputs(params, batch, cfg)
    x, caches = _backbone(params, x, cfg, mode="prefill", caches=caches,
                          pos=pos, tables=tables)
    i = min(max(int(pos) - 1, 0), x.shape[1] - 1)
    return lm_head(params, x[:, i:i + 1], cfg), caches


def decode_step_paged(params, caches, tokens, pos, tables, cfg: ModelConfig):
    """Paged decode step: ``caches`` are the pools (updated in place),
    ``tables`` the per-sequence block table [B, max_blocks] and ``pos`` the
    per-sequence positions [B]. Same contract as ``decode_step``
    otherwise."""
    x = embed_inputs(params, {"tokens": tokens}, cfg)
    x, caches = _backbone(params, x, cfg, mode="decode", caches=caches,
                          pos=pos, tables=tables)
    return lm_head(params, x, cfg), caches


def verify_step(params, caches, tokens, pos, cfg: ModelConfig):
    """Multi-token verify (speculative decoding): score M candidate tokens
    [B, M] in one pass against a dense cache (updated in place); ``pos``
    (int or [B]) is the cache position of ``tokens[:, 0]``. Returns (logits
    [B, M, V], caches): ``logits[:, i]`` is what M sequential
    ``decode_step`` calls would give after ``tokens[:, :i+1]``. All M
    tokens' K/V are written; callers roll a rejected tail back by position
    alone (stale entries are masked, then overwritten)."""
    x = embed_inputs(params, {"tokens": tokens}, cfg)
    x, caches = _backbone(params, x, cfg, mode="verify", caches=caches,
                          pos=pos)
    return lm_head(params, x, cfg), caches


def verify_step_paged(params, caches, tokens, pos, tables, cfg: ModelConfig):
    """Paged ``verify_step``: pools and per-sequence block tables; the
    scheduler truncates tail blocks that hold only rejected tokens
    (``PagedKVCache.truncate``)."""
    x = embed_inputs(params, {"tokens": tokens}, cfg)
    x, caches = _backbone(params, x, cfg, mode="verify", caches=caches,
                          pos=pos, tables=tables)
    return lm_head(params, x, cfg), caches


def kv_leaves(cfg: ModelConfig, lead, device) -> tuple:
    """One layer's zeroed KV leaves with leading dims ``lead`` (``(B, S)``
    for a dense cache, ``(N, bs)`` for a block pool): ``(k, v)`` in the
    activation dtype, or for the quantized tiers ``(k_q, k_scale, v_q,
    v_scale)``: int8 codes ``[*lead, Hkv, hd]`` and f32 scales
    ``[*lead, Hkv]``; int4: packed codes ``[*lead, Hkv, hd // 2]`` (two per
    int8 byte) and f16 group scales ``[*lead, Hkv, hd // g]``."""
    hd = cfg.resolved_head_dim
    shape = tuple(lead) + (cfg.n_kv_heads, hd)
    if cfg.kv_precision == "int4":
        ng = hd // kv_group_size(hd)
        codes = lambda: torch.zeros(shape[:-1] + (hd // 2,),  # noqa: E731
                                    dtype=torch.int8, device=device)
        scale = lambda: torch.zeros(shape[:-1] + (ng,),  # noqa: E731
                                    dtype=torch.float16, device=device)
        return codes(), scale(), codes(), scale()
    if cfg.kv_precision == "int8":
        codes = lambda: torch.zeros(shape, dtype=torch.int8, device=device)  # noqa: E731
        scale = lambda: torch.zeros(shape[:-1], dtype=torch.float32,  # noqa: E731
                                    device=device)
        return codes(), scale(), codes(), scale()
    dt = cfg.activation_dtype
    return (torch.zeros(shape, dtype=dt, device=device),
            torch.zeros(shape, dtype=dt, device=device))


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device: DeviceLike = None) -> Dict[str, Any]:
    check_supported(cfg)
    dev = resolve_device(device)
    return {"layers": [kv_leaves(cfg, (batch, seq_len), dev)
                       for _ in range(cfg.n_layers)]}
