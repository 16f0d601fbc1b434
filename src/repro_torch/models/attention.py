"""Dense GQA attention: the port of ``repro.models.attention`` for the
full-attention path with an fp, int8 or int4 KV cache.

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
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quantize import dequantize_kv_int4, quantize_kv_int4
from repro_torch.kernels.ref import (NEG_INF, paged_gather, q4decode_ref,
                                     quantize_kv_ref)
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, linear


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
    """Prefill K/V [B, S, ...] -> decode cache layout, padded to ``pad_to``
    slots so decode can append (the ring-buffer branch is not ported)."""
    if window:
        raise NotImplementedError(
            "sliding-window ring caches are ROADMAP Queue 1 item 9")
    if pad_to > s:
        pad = torch.zeros((t.shape[0], pad_to - s) + tuple(t.shape[2:]),
                          dtype=t.dtype, device=t.device)
        return torch.cat([t, pad], dim=1)
    return t


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
        out = linear(p["wo"], out.reshape(b, s, cfg.n_heads * hd))
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
    out = linear(p["wo"], out.reshape(b, s, cfg.n_heads * hd))
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
    valid [B,S]) for a full-attention cache. An int position is filled on
    ``device`` (no host-to-device copy, so no stream sync)."""
    if window:
        raise NotImplementedError(
            "sliding-window decode is ROADMAP Queue 1 item 9")
    if isinstance(pos, torch.Tensor):
        pos_vec = pos.to(torch.int64).expand(b)
    else:
        pos_vec = torch.full((b,), int(pos), dtype=torch.int64, device=device)
    slots = torch.arange(s_cache, device=pos_vec.device)
    k_pos = slots[None].expand(b, s_cache)
    valid = (k_pos >= 0) & (k_pos <= pos_vec[:, None])
    return pos_vec, pos_vec, k_pos, valid


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
        return linear(p["wo"], out), cache_kv
    k_cache = _batched_update(cache_kv[0], k, slot_vec)
    v_cache = _batched_update(cache_kv[1], v, slot_vec)
    scores = _score_einsum("bkgh,btkh->bkgt", qg, k_cache, cfg.opt_attn_accum)
    scores = _inv_sqrt_scaled(scores, hd)
    scores = scores.masked_fill(~valid[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgt,btkh->bkgh", probs, v_cache)
    return linear(p["wo"], out.reshape(b, 1, hq * hd)), (k_cache, v_cache)


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
    out = linear(p["wo"], out.reshape(b, s, cfg.n_heads * hd))
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
    return linear(p["wo"], out), cache


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
    return linear(p["wo"], out.to(x.dtype).reshape(b, m, hq * hd))


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
