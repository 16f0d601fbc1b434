"""Attention mixers: the port of ``repro.models.attention`` for full
attention: GQA over an fp, int8 or int4 KV cache, and MLA (deepseek-v2).

Prefill goes through the flash-prefill kernel (``kernels.ops.flash_prefill``)
as ``cfg.opt_flash_prefill`` does by default in the JAX package;
``opt_flash_prefill=False`` takes the chunked-query core
(``chunked_attention``, plain PyTorch as it is plain jnp there), which
attends over the fp K/V and quantizes a quantized tier's cache only after
padding it, as the JAX package does. ``cfg.opt_attn_accum`` takes every
score product with f32 operands (bf16 x bf16 products are exact in f32),
the JAX package's bf16 operands with an f32 result. Speculative decoding's
multi-token verify (``gqa_verify``, ``gqa_verify_paged``) writes M tokens'
K/V and attends each over its causal prefix, plain PyTorch over the
dequantized cache.

A window (``cfg.window``: recurrentgemma's local attention, or
``for_long_context``) keeps the banded chunked prefill (never flash) and a
ring cache of exactly ``window`` slots: decode writes position t at slot
t % window and masks the ring by position, in every tier.

Every ``wo`` goes through ``layers.row_combine``: plain ``linear`` outside
a tensor-parallel region, the shard group's gather or reduce inside one.

Decode over the fp cache is a plain masked softmax einsum there, and a
plain ``torch.einsum`` here. The quantized tiers quantize K and V before they are
stored, keep the cache as ``(k_q, k_scale, v_q, v_scale)``, and attend over
the quantized values with the fused-dequant kernels. int8
(``cfg.kv_precision == "int8"``): per-(slot, head) f32 scales,
``flash_qprefill``, ``qdecode`` and ``paged_qdecode``. int4: codes packed two
per byte with per-(slot, head, group of 32) f16 scales
(``kernels.quantize``), ``flash_q4prefill`` and ``paged_q4decode``; the
dense int4 decode stays the plain ``q4decode_ref`` on every device, as it
stays at the jnp level in the JAX package. The decode cache is updated in
place (one ``[B, 1]`` slot per step) instead of copied, which saves a full
cache copy per layer per step; callers own the cache they pass in.

MLA caches the compressed streams ``c_kv`` [B,S,kv_lora_rank] and
``k_rope`` [B,S,qk_rope_dim] (head-free pools when paged), in the
activation dtype whatever the KV tier. Prefill up-projects them to per-head
K/V and attends with the flash kernel, one kv head per query head at hd =
qk_nope + qk_rope and dv = v_head_dim (192 / 128 at deepseek-v2's width:
``flash_tc``'s 192 / 128 class). Decode is plain PyTorch, as it is plain
jnp there: naive (re-up-project the cache) or, with ``cfg.opt_mla_absorb``,
weight-absorbed (scores against ``c_kv`` directly); paged decode and verify
gather the streams through the block table and run the same cores.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quantize import dequantize_kv_int4, quantize_kv_int4
from repro_torch.kernels.ref import (NEG_INF, paged_gather, paged_valid,
                                     q4decode_ref, quantize_kv_ref)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_rope, dense_init, linear,
                                       rms_norm, row_combine)


Q_CHUNK = 512


def init_gqa_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dt = cfg.activation_dtype
    return {
        "wq": dense_init(gen, (d, cfg.n_heads * hd), dtype=dt),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype=dt),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype=dt),
        "wo": dense_init(gen, (cfg.n_heads * hd, d), dtype=dt),
    }


# ----------------------------------------------------------------------- #
# Chunked-query attention core
# ----------------------------------------------------------------------- #
def _score_einsum(spec: str, a: torch.Tensor, b: torch.Tensor, native: bool):
    """Score product in f32. ``native`` (``cfg.opt_attn_accum``): f32
    operands, so bf16 products are exact and nothing is rounded to bf16
    before the f32 sum (the JAX package's bf16 operands with an f32
    result); else the product in the operands' (promoted) dtype, then f32."""
    if native:
        return torch.einsum(spec, a.float(), b.float())
    dt = torch.promote_types(a.dtype, b.dtype)
    return torch.einsum(spec, a.to(dt), b.to(dt)).to(torch.float32)


def _inv_sqrt_scaled(scores: torch.Tensor, hd: int) -> torch.Tensor:
    """``scores / sqrt(hd)`` with the constant filled on the device (a host
    tensor copy would sync the stream)."""
    return scores / torch.full((), hd, dtype=torch.float32,
                               device=scores.device).sqrt()


def _attend_chunk(q, k, v, q_pos, k_pos, window: int,
                  native_accum: bool = False) -> torch.Tensor:
    """q [B,C,Hq,hd]; k, v [B,T,Hkv,hd]; q_pos [C], k_pos [T] absolute."""
    b, c, hq, hd = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, c, hkv, hq // hkv, hd)
    scores = _score_einsum("bckgh,btkh->bkgct", qg, k, native_accum)
    scores = _inv_sqrt_scaled(scores, hd)
    rel = q_pos[:, None] - k_pos[None, :]                       # [C, T]
    mask = rel >= 0
    if window:
        mask &= rel < window
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgct,btkh->bckgh", probs, v)
    return out.reshape(b, c, hq, v.shape[-1])


def chunked_attention(q, k, v, positions=None, window: int = 0,
                      native_accum: bool = False) -> torch.Tensor:
    """Causal attention over query chunks of ``Q_CHUNK``: q [B,S,Hq,hd],
    k / v [B,S,Hkv,hd] -> [B,S,Hq,hd]. q is padded to a whole number of
    chunks and every chunk masks by absolute position; with a window only
    the ``[chunk_end - window - C, chunk_end)`` K/V band is read.
    ``positions`` (the contiguous arange) is implied by the shapes."""
    b, s, hq, hd = q.shape
    c = min(Q_CHUNK, s)
    n_chunks = -(-s // c)
    pad = n_chunks * c - s
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
    band = window + c if window and window + c < s else 0
    ar = torch.arange(c, device=q.device)
    outs = []
    for i in range(n_chunks):
        q0 = i * c
        if band:
            start = min(max(q0 + c - band, 0), s - band)
            kc, vc = k[:, start:start + band], v[:, start:start + band]
            k_pos = start + torch.arange(band, device=q.device)
        else:
            kc, vc, k_pos = k, v, torch.arange(s, device=q.device)
        outs.append(_attend_chunk(q[:, q0:q0 + c], kc, vc, q0 + ar, k_pos,
                                  window, native_accum=native_accum))
    return torch.cat(outs, dim=1)[:, :s]


def _ring_or_pad(t: torch.Tensor, s: int, window: int, pad_to: int):
    """Prefill K/V [B, S, ...] -> the decode cache layout. With a window: a
    ring of exactly ``window`` slots, the prompt zero-padded to ``window``
    slots, or its last ``window`` rows rolled by ``-(s % window)`` as the
    JAX package rolls them (position t then sits at slot t % window, where
    decode looks for it, only when ``s % window`` is 0 or ``window / 2``:
    ROADMAP Queue 3); else padded to ``pad_to`` slots so decode can
    append."""
    def pad(n):
        z = torch.zeros((t.shape[0], n - s) + tuple(t.shape[2:]),
                        dtype=t.dtype, device=t.device)
        return torch.cat([t, z], dim=1)

    if window:
        if window < s:
            return torch.roll(t[:, s - window:], -(s % window), dims=1)
        return pad(window) if window > s else t
    return pad(pad_to) if pad_to > s else t


def _quantize_kv(t):
    """[B,S,H,hd] -> (int8, scale [B,S,H]) per-slot-per-head symmetric.
    Plain PyTorch on every device, as it is ``jnp`` (not a Pallas kernel)
    in the JAX package."""
    return quantize_kv_ref(t)


def _quantize(t, prec: str):
    """K or V [B,S,Hkv,hd] -> (codes, scales) of the quantized tier
    ``prec``: int8 per (slot, head), int4 packed per group."""
    return quantize_kv_int4(t) if prec == "int4" else _quantize_kv(t)


def _flash_ok(cfg: ModelConfig, window: int) -> bool:
    """Prefill dispatch: the flash kernel covers full (non-windowed) causal
    attention; ``opt_flash_prefill=False`` or a window takes the chunked
    core."""
    return cfg.opt_flash_prefill and not window


def gqa_prefill(p, x, positions, cfg: ModelConfig, window: int = 0,
                pad_to: int = 0):
    """Returns (out [B,S,d], cache), the cache padded to ``max(S, pad_to)``
    slots: ``(k, v)`` [B,S_cache,Hkv,hd], or for the quantized tiers
    ``(k_q, k_scale, v_q, v_scale)``: int8 codes with f32 scales
    [B,S_cache,Hkv], int4 packed codes [B,S_cache,Hkv,hd//2] with f16 group
    scales [B,S_cache,Hkv,hd//g]. A quantized prefill attends over the
    quantized K/V (the values decode reads later) with ``flash_qprefill`` /
    ``flash_q4prefill``; codes and scales are padded with zeros after
    quantizing. The chunked core (``opt_flash_prefill=False``) attends over
    the fp K/V and quantizes the padded cache."""
    prec = cfg.kv_precision
    from repro_torch.kernels import ops

    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = linear(p["wq"], x).reshape(b, s, cfg.n_heads, hd)
    k = linear(p["wk"], x).reshape(b, s, cfg.n_kv_heads, hd)
    v = linear(p["wv"], x).reshape(b, s, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if not _flash_ok(cfg, window):
        # chunked core over the fp K/V; a quantized tier quantizes the
        # padded cache (pad rows get the floor scale, as in JAX)
        out = chunked_attention(q, k, v, positions, window=window,
                                native_accum=cfg.opt_attn_accum)
        out = row_combine(p["wo"], out.reshape(b, s, cfg.n_heads * hd))
        kc, vc = (_ring_or_pad(t, s, window, pad_to) for t in (k, v))
        if prec == "fp":
            return out, (kc, vc)
        return out, (*_quantize(kc, prec), *_quantize(vc, prec))
    if prec == "fp":
        out = ops.flash_prefill(q, k, v).to(x.dtype)
        cache = (k, v)
    else:
        kq, ks = _quantize(k, prec)
        vq, vs = _quantize(v, prec)
        attend = ops.flash_q4prefill if prec == "int4" else ops.flash_qprefill
        out = attend(q, kq, ks, vq, vs).to(x.dtype)
        cache = (kq, ks, vq, vs)
    out = row_combine(p["wo"], out.reshape(b, s, cfg.n_heads * hd))
    return out, tuple(_ring_or_pad(t, s, window, pad_to) for t in cache)


def _batched_update(cache: torch.Tensor, update: torch.Tensor, slots):
    """In-place per-sequence write: cache [B,S,...], update [B,M,...] at
    slots [B]..slots+M-1. The start clamps to ``[0, S - M]`` as
    ``dynamic_update_slice`` does."""
    b, s_cache = cache.shape[:2]
    m = update.shape[1]
    rows = torch.arange(b, device=cache.device)[:, None]
    idx = (slots.clamp(0, s_cache - m)[:, None]
           + torch.arange(m, device=cache.device)[None])
    cache[rows, idx] = update.to(cache.dtype)
    return cache


def decode_positions(pos, b: int, s_cache: int, window: int, device=None):
    """pos (int or [B] tensor) -> (pos_vec [B], slots_vec [B], k_pos [B,S],
    valid [B,S]). Full attention: slot k holds position k. A window's ring:
    this token goes to slot pos % S, slot k holds the latest position
    congruent to k that is <= pos (negative: never written), valid within
    the window. An int position is filled on ``device`` (no host-to-device
    copy, so no stream sync)."""
    if isinstance(pos, torch.Tensor):
        pos_vec = pos.to(torch.int64).expand(b)
    else:
        pos_vec = torch.full((b,), int(pos), dtype=torch.int64, device=device)
    slots = torch.arange(s_cache, device=pos_vec.device)
    if window:
        slot_vec = pos_vec % s_cache
        k_pos = pos_vec[:, None] - torch.remainder(
            pos_vec[:, None] - slots[None], s_cache)
    else:
        slot_vec = pos_vec
        k_pos = slots[None].expand(b, s_cache)
    valid = (k_pos >= 0) & (k_pos <= pos_vec[:, None])
    if window:
        valid &= (pos_vec[:, None] - k_pos) < window
    return pos_vec, slot_vec, k_pos, valid


def gqa_decode(p, x, cache_kv, pos, cfg: ModelConfig, window: int = 0):
    """x [B,1,d]; cache_kv as returned by gqa_prefill (updated in place);
    pos: int or per-sequence [B] tensor of positions. The quantized tiers
    write this token's codes and scales, then attend under the bias
    ``where(valid, 0, NEG_INF)``: int8 with the ``qdecode`` kernel, int4
    with the plain ``q4decode_ref`` (no TPU kernel covers the dense int4
    decode; the JAX package runs its oracle there too)."""
    prec = cfg.kv_precision
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    s_cache = cache_kv[0].shape[1]
    pos_vec, slot_vec, _, valid = decode_positions(pos, b, s_cache, window,
                                                   device=x.device)
    pos_b = pos_vec[:, None]
    q = linear(p["wq"], x).reshape(b, 1, cfg.n_heads, hd)
    k = linear(p["wk"], x).reshape(b, 1, cfg.n_kv_heads, hd)
    v = linear(p["wv"], x).reshape(b, 1, cfg.n_kv_heads, hd)
    q = apply_rope(q, pos_b, cfg.rope_theta)
    k = apply_rope(k, pos_b, cfg.rope_theta)
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    qg = q.reshape(b, hkv, hq // hkv, hd)
    if prec != "fp":
        from repro_torch.kernels import ops

        kq, ks = _quantize(k, prec)
        vq, vs = _quantize(v, prec)
        cache_kv = tuple(_batched_update(c, u, slot_vec)
                         for c, u in zip(cache_kv, (kq, ks, vq, vs)))
        bias = torch.where(valid, torch.zeros((), device=x.device),
                           torch.full((), NEG_INF, device=x.device))
        attend = q4decode_ref if prec == "int4" else ops.qdecode
        out = attend(qg, *cache_kv, bias)
        out = out.to(x.dtype).reshape(b, 1, hq * hd)
        return row_combine(p["wo"], out), cache_kv
    k_cache = _batched_update(cache_kv[0], k, slot_vec)
    v_cache = _batched_update(cache_kv[1], v, slot_vec)
    scores = _score_einsum("bkgh,btkh->bkgt", qg, k_cache, cfg.opt_attn_accum)
    scores = _inv_sqrt_scaled(scores, hd)
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgt,btkh->bkgh", probs, v_cache)
    return row_combine(p["wo"], out.reshape(b, 1, hq * hd)), (k_cache, v_cache)


# ----------------------------------------------------------------------- #
# Paged prefill / decode (block-table cache, fp, int8 and int4 tiers)
# ----------------------------------------------------------------------- #
def _count_vec(pos, b: int, device) -> torch.Tensor:
    """int or [B] tensor -> int64 [B] on ``device``, filled there (no
    host-to-device copy)."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int64).expand(b)
    return torch.full((b,), int(pos), dtype=torch.int64, device=device)


def _paged_prefill_slots(tables, n_valid, s: int, block_size: int):
    """(block ids [B,S], offsets [B,S]) for scattering S prefill positions
    per sequence through the block table. Positions >= n_valid (bucket
    padding) and unallocated table entries route to the reserved trash
    block 0."""
    b = tables.shape[0]
    pos_ids = torch.arange(s, device=tables.device)
    idx = torch.clamp(pos_ids // block_size, max=tables.shape[1] - 1)
    blk = tables.to(torch.int64)[:, idx]
    blk = torch.where(pos_ids[None] < n_valid[:, None], blk.clamp(min=0),
                      torch.zeros_like(blk))
    off = (pos_ids % block_size)[None].expand(b, s)
    return blk, off


def gqa_prefill_paged(p, x, positions, cache, pos, tables, cfg: ModelConfig):
    """Cold-path paged prefill: compute the prompt's K/V, attend with the
    flash kernel, and write the K/V straight into the block pools through
    the slot's table (in place; the dense cache never materializes).
    ``pos`` is the valid-token count (int or [B]); padded positions land
    in the trash block. The quantized tiers attend over the quantized K/V
    with ``flash_qprefill`` / ``flash_q4prefill`` and scatter codes and
    scales; the chunked core (``opt_flash_prefill=False``) attends over the
    fp K/V and scatters the same codes."""
    prec = cfg.kv_precision
    from repro_torch.kernels import ops

    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    n_valid = _count_vec(pos, b, x.device)
    q = linear(p["wq"], x).reshape(b, s, cfg.n_heads, hd)
    k = linear(p["wk"], x).reshape(b, s, cfg.n_kv_heads, hd)
    v = linear(p["wv"], x).reshape(b, s, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    blk, off = _paged_prefill_slots(tables, n_valid, s, cache[0].shape[1])
    new = (k, v) if prec == "fp" else (*_quantize(k, prec),
                                       *_quantize(v, prec))
    if not cfg.opt_flash_prefill:
        out = chunked_attention(q, k, v, positions,
                                native_accum=cfg.opt_attn_accum)
    elif prec == "fp":
        out = ops.flash_prefill(q, k, v).to(x.dtype)
    else:
        attend = ops.flash_q4prefill if prec == "int4" else ops.flash_qprefill
        out = attend(q, *new).to(x.dtype)
    # duplicate (block 0, offset) pairs only ever come from padding
    for pool, t in zip(cache, new):
        pool[blk, off] = t.to(pool.dtype)
    out = row_combine(p["wo"], out.reshape(b, s, cfg.n_heads * hd))
    return out, cache


def paged_write_slots(tables, positions, block_size: int):
    """(block ids, offsets) for writing ``positions`` ([B], or [B, M] for a
    verify span) through each sequence's table. Unallocated entries clamp
    to the reserved trash block 0 (idle slots write there; block 0 is
    masked on every read), and so do positions past the table (an idle
    slot's position keeps counting), as the JAX gather's out-of-range fill
    gives."""
    span = positions if positions.dim() == 2 else positions[:, None]
    m = tables.shape[1]
    idx = span // block_size
    blk = torch.gather(tables.to(torch.int64), 1, idx.clamp(max=m - 1))
    blk = torch.where(idx < m, blk, torch.zeros_like(blk)).clamp(min=0)
    off = span % block_size
    return (blk, off) if positions.dim() == 2 else (blk[:, 0], off[:, 0])


def gqa_decode_paged(p, x, cache, pos, tables, cfg: ModelConfig):
    """x [B,1,d]; cache (k_pool, v_pool) [N,bs,Hkv,hd], or for the
    quantized tiers (k_pool, k_scale, v_pool, v_scale): int8 pools with f32
    scale pools [N,bs,Hkv], int4 pools [N,bs,Hkv,hd//2] with f16 group-scale
    pools [N,bs,Hkv,hd//g]; updated in place; tables [B,M] int32; pos int
    or [B]. Writes this token's K/V (codes and scales) into its table's
    block, then reads the whole sequence through the table with the paged
    attention kernel (``paged_qdecode`` for int8, ``paged_q4decode`` for
    int4)."""
    prec = cfg.kv_precision
    from repro_torch.kernels import ops

    b = x.shape[0]
    hd = cfg.resolved_head_dim
    pos_vec = _count_vec(pos, b, x.device)
    pos_b = pos_vec[:, None]
    q = linear(p["wq"], x).reshape(b, 1, cfg.n_heads, hd)
    k = linear(p["wk"], x).reshape(b, 1, cfg.n_kv_heads, hd)
    v = linear(p["wv"], x).reshape(b, 1, cfg.n_kv_heads, hd)
    q = apply_rope(q, pos_b, cfg.rope_theta)
    k = apply_rope(k, pos_b, cfg.rope_theta)
    blk, off = paged_write_slots(tables, pos_vec, cache[0].shape[1])
    if prec == "fp":
        new = (k, v)
    else:
        kq, ks = _quantize(k, prec)
        vq, vs = _quantize(v, prec)
        new = (kq, ks, vq, vs)
    for pool, t in zip(cache, new):
        pool[blk, off] = t[:, 0].to(pool.dtype)
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    qg = q.reshape(b, hkv, hq // hkv, hd)
    attend = {"fp": ops.paged_decode, "int8": ops.paged_qdecode,
              "int4": ops.paged_q4decode}[prec]
    out = attend(qg, *cache, tables.to(torch.int32), pos_vec.to(torch.int32))
    out = out.to(x.dtype).reshape(b, 1, hq * hd)
    return row_combine(p["wo"], out), cache


# ----------------------------------------------------------------------- #
# Multi-token verify (speculative decoding)
# ----------------------------------------------------------------------- #
def _verify_positions(pos, b: int, m: int, device):
    """pos (int or [B]) -> (pos_vec [B], positions [B, M]) for a verify
    span of M candidate tokens starting at each sequence's position."""
    pos_vec = _count_vec(pos, b, device)
    return pos_vec, pos_vec[:, None] + torch.arange(m, device=device)[None]


def _verify_qkv(p, x, positions, cfg: ModelConfig):
    b, m, _ = x.shape
    hd = cfg.resolved_head_dim
    q = linear(p["wq"], x).reshape(b, m, cfg.n_heads, hd)
    k = linear(p["wk"], x).reshape(b, m, cfg.n_kv_heads, hd)
    v = linear(p["wv"], x).reshape(b, m, cfg.n_kv_heads, hd)
    return (apply_rope(q, positions, cfg.rope_theta),
            apply_rope(k, positions, cfg.rope_theta), v)


def _dequant_kv(kv, prec: str):
    """(k, v) of a cache or gathered pools in f32 for the quantized tiers,
    as they are for the fp tier."""
    if prec == "int4":
        return (dequantize_kv_int4(kv[0], kv[1]),
                dequantize_kv_int4(kv[2], kv[3]))
    if prec == "int8":
        return (kv[0].float() * kv[1][..., None],
                kv[2].float() * kv[3][..., None])
    return kv


def _attend_verify(p, x, q, kf, vf, valid, cfg: ModelConfig):
    """Each of M queries over the keys ``valid`` [B, M, T] lets it read."""
    b, m = x.shape[:2]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    qg = q.reshape(b, m, hkv, hq // hkv, hd)
    scores = _score_einsum("bmkgh,btkh->bkgmt", qg, kf, cfg.opt_attn_accum)
    scores = _inv_sqrt_scaled(scores, hd)
    scores = scores.masked_fill(~valid[:, None, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(vf.dtype)
    out = torch.einsum("bkgmt,btkh->bmkgh", probs, vf)
    return row_combine(p["wo"], out.to(x.dtype).reshape(b, m, hq * hd))


def gqa_verify(p, x, cache_kv, pos, cfg: ModelConfig):
    """Score M candidate tokens in one pass against a dense cache: x
    [B,M,d], pos (int or [B]) the cache position of x[:, 0]. Writes the M
    tokens' K/V (codes and scales) at pos..pos+M-1 in place and attends
    query i over the cache through pos+i. Rejected-tail writes stay: later
    reads mask by position and overwrite them."""
    b, m, _ = x.shape
    prec = cfg.kv_precision
    s_cache = cache_kv[0].shape[1]
    pos_vec, positions = _verify_positions(pos, b, m, x.device)
    q, k, v = _verify_qkv(p, x, positions, cfg)
    new = (k, v) if prec == "fp" else (*_quantize(k, prec),
                                       *_quantize(v, prec))
    cache_kv = tuple(_batched_update(c, u, pos_vec)
                     for c, u in zip(cache_kv, new))
    kf, vf = _dequant_kv(cache_kv, prec)
    valid = (torch.arange(s_cache, device=x.device)[None, None, :]
             <= positions[:, :, None])
    return _attend_verify(p, x, q, kf, vf, valid, cfg), cache_kv


def gqa_verify_paged(p, x, cache, pos, tables, cfg: ModelConfig):
    """Paged ``gqa_verify``: the M tokens' K/V (codes and scales) go into
    the slots' blocks in place, then the whole block table is gathered and
    attended with the triangular span mask. Rows no query may read
    (unallocated entries, which read the trash block, and slots past the
    span) are set to 0 before the value product, so NaN there cannot leak
    through a zero probability; where they are finite this changes no
    bit. The scheduler frees blocks that held only rejected tokens
    (``PagedKVCache.truncate``)."""
    b, m, _ = x.shape
    prec = cfg.kv_precision
    bs = cache[0].shape[1]
    pos_vec, positions = _verify_positions(pos, b, m, x.device)
    q, k, v = _verify_qkv(p, x, positions, cfg)
    new = (k, v) if prec == "fp" else (*_quantize(k, prec),
                                       *_quantize(v, prec))
    blk, off = paged_write_slots(tables, positions, bs)
    for pool, t in zip(cache, new):
        pool[blk, off] = t.to(pool.dtype)
    kf, vf = _dequant_kv(tuple(paged_gather(t, tables) for t in cache), prec)
    t_len = kf.shape[1]
    allocated = (tables >= 0).repeat_interleave(bs, dim=1)        # [B, T]
    valid = ((torch.arange(t_len, device=x.device)[None, None, :]
              <= positions[:, :, None]) & allocated[:, None, :])
    live = valid.any(dim=1)[:, :, None, None]
    vf = torch.where(live, vf, torch.zeros((), dtype=vf.dtype,
                                           device=vf.device))
    return _attend_verify(p, x, q, kf, vf, valid, cfg), cache


# ----------------------------------------------------------------------- #
# MLA (deepseek-v2): compressed c_kv / k_rope caches, naive and absorbed
# ----------------------------------------------------------------------- #
def init_mla_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, dt = cfg.d_model, cfg.activation_dtype
    qdim = cfg.qk_nope_dim + cfg.qk_rope_dim
    p = {
        "w_dkv": dense_init(gen, (d, cfg.kv_lora_rank), dtype=dt),
        "w_kr": dense_init(gen, (d, cfg.qk_rope_dim), dtype=dt),
        "w_ukv": dense_init(
            gen, (cfg.kv_lora_rank,
                  cfg.n_heads * (cfg.qk_nope_dim + cfg.v_head_dim)),
            dtype=dt),
        "wo": dense_init(gen, (cfg.n_heads * cfg.v_head_dim, d), dtype=dt),
        "kv_norm": torch.zeros((cfg.kv_lora_rank,), dtype=dt,
                               device=gen.device),
    }
    if cfg.q_lora_rank:
        p["w_dq"] = dense_init(gen, (d, cfg.q_lora_rank), dtype=dt)
        p["w_uq"] = dense_init(gen, (cfg.q_lora_rank, cfg.n_heads * qdim),
                               dtype=dt)
        p["q_norm"] = torch.zeros((cfg.q_lora_rank,), dtype=dt,
                                  device=gen.device)
    else:
        p["wq"] = dense_init(gen, (d, cfg.n_heads * qdim), dtype=dt)
    return p


def _mla_q(p, x, q_positions, cfg: ModelConfig):
    """(q_nope [B,S,H,dn], q_rope [B,S,H,dr] rotated)."""
    b, sq = x.shape[:2]
    nh, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        cq = rms_norm(p["q_norm"], linear(p["w_dq"], x), cfg.norm_eps)
        q = linear(p["w_uq"], cq).reshape(b, sq, nh, dn + dr)
    else:
        q = linear(p["wq"], x).reshape(b, sq, nh, dn + dr)
    return q[..., :dn], apply_rope(q[..., dn:], q_positions, cfg.rope_theta)


def _mla_qkv(p, x, c_kv, k_rope, q_positions, kv_positions,
             cfg: ModelConfig):
    """Per-head q, k [B,*,H,dn+dr] and v [B,*,H,dv], all contiguous: k is
    the up-projected ``k_nope`` beside the rotated ``k_rope`` broadcast over
    the heads, v a slice of the up-projection (copied, as the flash kernel
    reads contiguous operands)."""
    b, skv = c_kv.shape[:2]
    nh, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                      cfg.v_head_dim)
    q_nope, q_rope = _mla_q(p, x, q_positions, cfg)
    q = torch.cat([q_nope, q_rope], dim=-1)
    kv = linear(p["w_ukv"], rms_norm(p["kv_norm"], c_kv, cfg.norm_eps))
    kv = kv.reshape(b, skv, nh, dn + dv)
    kr = apply_rope(k_rope[:, :, None, :], kv_positions, cfg.rope_theta)
    k = torch.cat([kv[..., :dn], kr.expand(b, skv, nh, dr)], dim=-1)
    return q, k, kv[..., dn:].contiguous()


def _mla_attend_naive(p, x, c_kv, k_rope, pos_b, k_pos, valid,
                      cfg: ModelConfig):
    """Re-up-projecting MLA attention of x's queries (one in decode, the M
    of a verify span) over an (updated) compressed cache view: the dense
    and paged decode and verify paths. ``pos_b`` [B, M] are the queries'
    positions, ``valid`` [B, T] (the same for every query) or [B, M, T]
    the keys each may read."""
    b, m = x.shape[:2]
    q, k, v = _mla_qkv(p, x, c_kv, k_rope, pos_b, k_pos, cfg)
    scores = _score_einsum("bqnh,btnh->bnqt", q, k, cfg.opt_attn_accum)
    scores = _inv_sqrt_scaled(scores, q.shape[-1])
    mask = valid[:, None] if valid.dim() == 3 else valid[:, None, None]
    scores = scores.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bnqt,btnh->bqnh", probs, v)
    return out.reshape(b, m, cfg.n_heads * cfg.v_head_dim)


def _w_ukv(p, rank: int, dtype) -> torch.Tensor:
    """``w_ukv`` [rank, H * (dn + dv)] in ``dtype``; a quantized leaf is
    dequantized, and one packed K-major for the card's GEMMs
    (``w_packed [N, Kp]``, ``place_params``) is read back as its first
    ``rank`` columns transposed."""
    w = p["w_ukv"]
    if not isinstance(w, dict):
        return w.to(dtype)
    from repro_torch.core.quant.quantize import dequantize_tensor

    if "w_packed" in w:
        w = {"w_int8": w["w_packed"][:, :rank].t(), "scale": w["scale"]}
    return dequantize_tensor(w, dtype)


def _mla_attend_absorbed(p, x, c_kv, k_rope, pos_b, k_pos, valid,
                         cfg: ModelConfig):
    """Weight-absorbed MLA attention of one query over an (updated)
    compressed cache view: W_uk folds into the query and W_uv into the
    output, so scores run against ``c_kv`` directly. Every product takes
    f32 operands (exact for bf16 values) with an f32 result, the JAX
    package's bf16 operands with ``preferred_element_type=f32``."""
    b = x.shape[0]
    nh, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                      cfg.v_head_dim)
    rank = cfg.kv_lora_rank
    f32 = torch.float32
    q_nope, q_rope = _mla_q(p, x, pos_b, cfg)
    q_rope = q_rope[:, 0]                                          # [B,H,dr]
    w = _w_ukv(p, rank, x.dtype).reshape(rank, nh, dn + dv)
    w_uk, w_uv = w[..., :dn], w[..., dn:]
    q_c = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].to(f32), w_uk.to(f32))

    ckv_n = rms_norm(p["kv_norm"], c_kv, cfg.norm_eps)             # [B,S,r]
    kr = apply_rope(k_rope[:, :, None, :], k_pos, cfg.rope_theta)[:, :, 0]

    scores = torch.einsum("bhr,bsr->bhs", q_c.to(x.dtype).to(f32),
                          ckv_n.to(f32))
    scores = scores + torch.einsum("bhd,bsd->bhs", q_rope.to(f32),
                                   kr.to(f32))
    scores = _inv_sqrt_scaled(scores, dn + dr)
    scores = scores.masked_fill(~valid[:, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", probs.to(x.dtype).to(f32),
                       ckv_n.to(f32))
    out = torch.einsum("bhr,rhd->bhd", ctx.to(x.dtype).to(f32),
                       w_uv.to(f32))
    return out.to(x.dtype).reshape(b, 1, nh * dv)


def mla_prefill(p, x, positions, cfg: ModelConfig, window: int = 0,
                pad_to: int = 0):
    """Returns (out [B,S,d], (c_kv [B,S_cache,rank], k_rope
    [B,S_cache,dr])). The flash kernel attends with one kv head per query
    head, hd = dn + dr and dv = v_head_dim (192 and 128 at deepseek-v2's
    width); the chunked core (``opt_flash_prefill=False``) otherwise. MLA
    caches stay in the activation dtype whatever the KV tier, as in the JAX
    package."""
    b, s, _ = x.shape
    c_kv = linear(p["w_dkv"], x)
    k_rope = linear(p["w_kr"], x)
    q, k, v = _mla_qkv(p, x, c_kv, k_rope, positions, positions, cfg)
    if _flash_ok(cfg, window):
        from repro_torch.kernels import ops

        out = ops.flash_prefill(q, k, v).to(x.dtype)
    else:
        out = chunked_attention(q, k, v, positions, window=window,
                                native_accum=cfg.opt_attn_accum)
    out = row_combine(p["wo"], out.reshape(b, s, cfg.n_heads * cfg.v_head_dim))
    return out, (_ring_or_pad(c_kv, s, window, pad_to),
                 _ring_or_pad(k_rope, s, window, pad_to))


def mla_prefill_paged(p, x, positions, cache, pos, tables, cfg: ModelConfig):
    """Paged MLA cold prefill: the compressed streams go straight into the
    head-free pools ``(c_pool [N,bs,rank], r_pool [N,bs,dr])`` (in place);
    padded positions land in the trash block."""
    b, s, _ = x.shape
    c_pool, r_pool = cache
    n_valid = _count_vec(pos, b, x.device)
    c_kv = linear(p["w_dkv"], x)
    k_rope = linear(p["w_kr"], x)
    q, k, v = _mla_qkv(p, x, c_kv, k_rope, positions, positions, cfg)
    if cfg.opt_flash_prefill:
        from repro_torch.kernels import ops

        out = ops.flash_prefill(q, k, v).to(x.dtype)
    else:
        out = chunked_attention(q, k, v, positions,
                                native_accum=cfg.opt_attn_accum)
    blk, off = _paged_prefill_slots(tables, n_valid, s, c_pool.shape[1])
    c_pool[blk, off] = c_kv.to(c_pool.dtype)
    r_pool[blk, off] = k_rope.to(r_pool.dtype)
    out = row_combine(p["wo"], out.reshape(b, s, cfg.n_heads * cfg.v_head_dim))
    return out, cache


def mla_decode_absorbed(p, x, cache, pos, cfg: ModelConfig, window: int = 0):
    """Weight-absorbed MLA decode (``cfg.opt_mla_absorb``): scores against
    the compressed cache, no per-head K/V of the whole cache."""
    b = x.shape[0]
    c_kv, k_rope = cache
    pos_vec, slot_vec, k_pos, valid = decode_positions(
        pos, b, c_kv.shape[1], window, device=x.device)
    c_kv = _batched_update(c_kv, linear(p["w_dkv"], x), slot_vec)
    k_rope = _batched_update(k_rope, linear(p["w_kr"], x), slot_vec)
    out = _mla_attend_absorbed(p, x, c_kv, k_rope, pos_vec[:, None], k_pos,
                               valid, cfg)
    return row_combine(p["wo"], out), (c_kv, k_rope)


def mla_decode(p, x, cache, pos, cfg: ModelConfig, window: int = 0):
    """cache = (c_kv [B,S,rank], k_rope [B,S,dr]), updated in place. Naive:
    re-up-project the cache; ``cfg.opt_mla_absorb`` takes the absorbed
    path."""
    if cfg.opt_mla_absorb:
        return mla_decode_absorbed(p, x, cache, pos, cfg, window=window)
    b = x.shape[0]
    c_kv, k_rope = cache
    pos_vec, slot_vec, k_pos, valid = decode_positions(
        pos, b, c_kv.shape[1], window, device=x.device)
    c_kv = _batched_update(c_kv, linear(p["w_dkv"], x), slot_vec)
    k_rope = _batched_update(k_rope, linear(p["w_kr"], x), slot_vec)
    out = _mla_attend_naive(p, x, c_kv, k_rope, pos_vec[:, None], k_pos,
                            valid, cfg)
    return row_combine(p["wo"], out), (c_kv, k_rope)


def mla_decode_paged(p, x, cache, pos, tables, cfg: ModelConfig):
    """Paged MLA decode over head-free pools (c_pool [N,bs,rank], r_pool
    [N,bs,dr]), updated in place: this token's entries go into its block,
    then the streams are gathered through the table and attended by the
    dense core (absorbed with ``cfg.opt_mla_absorb``, else naive). Rows of
    unallocated entries read the trash block under a NEG_INF score, as in
    the JAX package: an idle slot (no block) attends uniformly over them,
    and its hidden state, which an MoE router sees, stays the JAX one."""
    b = x.shape[0]
    c_pool, r_pool = cache
    bs = c_pool.shape[1]
    pos_vec = _count_vec(pos, b, x.device)
    blk, off = paged_write_slots(tables, pos_vec, bs)
    c_pool[blk, off] = linear(p["w_dkv"], x)[:, 0].to(c_pool.dtype)
    r_pool[blk, off] = linear(p["w_kr"], x)[:, 0].to(r_pool.dtype)
    c_kv, k_rope = (paged_gather(t, tables) for t in cache)
    valid = paged_valid(tables, pos_vec, bs)
    s = c_kv.shape[1]
    k_pos = torch.arange(s, device=x.device)[None].expand(b, s)
    attend = (_mla_attend_absorbed if cfg.opt_mla_absorb
              else _mla_attend_naive)
    out = attend(p, x, c_kv, k_rope, pos_vec[:, None], k_pos, valid, cfg)
    return row_combine(p["wo"], out), cache


def mla_verify(p, x, cache, pos, cfg: ModelConfig):
    """Dense MLA verify: write M compressed entries at pos..pos+M-1 (in
    place) and attend each query over its causal prefix."""
    b, m, _ = x.shape
    c_kv, k_rope = cache
    s_cache = c_kv.shape[1]
    pos_vec, positions = _verify_positions(pos, b, m, x.device)
    c_kv = _batched_update(c_kv, linear(p["w_dkv"], x), pos_vec)
    k_rope = _batched_update(k_rope, linear(p["w_kr"], x), pos_vec)
    k_pos = torch.arange(s_cache, device=x.device)[None].expand(b, s_cache)
    valid = k_pos[:, None, :] <= positions[:, :, None]
    out = _mla_attend_naive(p, x, c_kv, k_rope, positions, k_pos, valid, cfg)
    return row_combine(p["wo"], out), (c_kv, k_rope)


def mla_verify_paged(p, x, cache, pos, tables, cfg: ModelConfig):
    """Paged MLA verify: M compressed entries scattered through the block
    table (in place), the streams gathered, the verify core run with the
    triangular span mask."""
    b, m, _ = x.shape
    c_pool, r_pool = cache
    bs = c_pool.shape[1]
    pos_vec, positions = _verify_positions(pos, b, m, x.device)
    blk, off = paged_write_slots(tables, positions, bs)
    c_pool[blk, off] = linear(p["w_dkv"], x).to(c_pool.dtype)
    r_pool[blk, off] = linear(p["w_kr"], x).to(r_pool.dtype)
    t_len = tables.shape[1] * bs
    allocated = (tables >= 0).repeat_interleave(bs, dim=1)
    k_pos = torch.arange(t_len, device=x.device)[None].expand(b, t_len)
    valid = ((k_pos[:, None, :] <= positions[:, :, None])
             & allocated[:, None, :])
    c_kv, k_rope = (paged_gather(t, tables) for t in cache)
    out = _mla_attend_naive(p, x, c_kv, k_rope, positions, k_pos, valid, cfg)
    return row_combine(p["wo"], out), cache
