"""Dense GQA attention: the port of ``repro.models.attention`` for the
full-attention path with an fp, int8 or int4 KV cache.

Prefill goes through the flash-prefill kernel (``kernels.ops.flash_prefill``)
as ``cfg.opt_flash_prefill`` does by default in the JAX package. Decode over
the fp cache is a plain masked softmax einsum there, and a plain
``torch.einsum`` here. The quantized tiers quantize K and V before they are
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

from repro_torch.kernels.quantize import quantize_kv_int4
from repro_torch.kernels.ref import NEG_INF, q4decode_ref, quantize_kv_ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, linear


def init_gqa_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    dt = cfg.activation_dtype
    return {
        "wq": dense_init(gen, (d, cfg.n_heads * hd), dtype=dt),
        "wk": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype=dt),
        "wv": dense_init(gen, (d, cfg.n_kv_heads * hd), dtype=dt),
        "wo": dense_init(gen, (cfg.n_heads * hd, d), dtype=dt),
    }


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


def _kv_tier(cfg: ModelConfig, prefill: bool) -> str:
    """``cfg.kv_precision`` (fp, int8 or int4); raise for the chunked-query
    prefill, which is not ported."""
    if prefill and not cfg.opt_flash_prefill:
        raise NotImplementedError(
            "the chunked-query prefill is ROADMAP Queue 1 item 3")
    return cfg.kv_precision


def gqa_prefill(p, x, positions, cfg: ModelConfig, window: int = 0,
                pad_to: int = 0):
    """Returns (out [B,S,d], cache), the cache padded to ``max(S, pad_to)``
    slots: ``(k, v)`` [B,S_cache,Hkv,hd], or for the quantized tiers
    ``(k_q, k_scale, v_q, v_scale)``: int8 codes with f32 scales
    [B,S_cache,Hkv], int4 packed codes [B,S_cache,Hkv,hd//2] with f16 group
    scales [B,S_cache,Hkv,hd//g]. A quantized prefill attends over the
    quantized K/V (the values decode reads later) with ``flash_qprefill`` /
    ``flash_q4prefill``; codes and scales are padded with zeros after
    quantizing."""
    prec = _kv_tier(cfg, prefill=True)
    from repro_torch.kernels import ops

    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    q = linear(p["wq"], x).reshape(b, s, cfg.n_heads, hd)
    k = linear(p["wk"], x).reshape(b, s, cfg.n_kv_heads, hd)
    v = linear(p["wv"], x).reshape(b, s, cfg.n_kv_heads, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
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
    """In-place per-sequence write: cache [B,S,...], update [B,1,...],
    slots [B]. Slots clamp to the cache as ``dynamic_update_slice`` does."""
    b, s_cache = cache.shape[:2]
    rows = torch.arange(b, device=cache.device)
    cache[rows, slots.clamp(0, s_cache - 1)] = update[:, 0].to(cache.dtype)
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
    prec = _kv_tier(cfg, prefill=False)
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
    scores = torch.einsum("bkgh,btkh->bkgt", qg, k_cache).to(torch.float32)
    # constants are filled on the device: a host tensor copy would sync
    scores = scores / torch.full((), hd, dtype=torch.float32,
                                 device=x.device).sqrt()
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
    scales."""
    prec = _kv_tier(cfg, prefill=True)
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
    if prec == "fp":
        out = ops.flash_prefill(q, k, v).to(x.dtype)
        new = (k, v)
    else:
        kq, ks = _quantize(k, prec)
        vq, vs = _quantize(v, prec)
        attend = ops.flash_q4prefill if prec == "int4" else ops.flash_qprefill
        out = attend(q, kq, ks, vq, vs).to(x.dtype)
        new = (kq, ks, vq, vs)
    # duplicate (block 0, offset) pairs only ever come from padding
    for pool, t in zip(cache, new):
        pool[blk, off] = t.to(pool.dtype)
    out = linear(p["wo"], out.reshape(b, s, cfg.n_heads * hd))
    return out, cache


def paged_write_slots(tables, pos_vec, block_size: int):
    """(block_id [B], offset [B]) for writing position ``pos`` per sequence.
    Unallocated entries clamp to the reserved trash block 0 (idle slots
    write there; block 0 is masked on every read)."""
    m = tables.shape[1]
    idx = pos_vec // block_size
    blk = torch.gather(tables.to(torch.int64), 1,
                       idx.clamp(max=m - 1)[:, None])[:, 0]
    # past the table (an idle slot's position keeps counting): the trash
    # block, as the JAX gather's out-of-range fill gives
    blk = torch.where(idx < m, blk, torch.zeros_like(blk))
    return blk.clamp(min=0), pos_vec % block_size


def gqa_decode_paged(p, x, cache, pos, tables, cfg: ModelConfig):
    """x [B,1,d]; cache (k_pool, v_pool) [N,bs,Hkv,hd], or for the
    quantized tiers (k_pool, k_scale, v_pool, v_scale): int8 pools with f32
    scale pools [N,bs,Hkv], int4 pools [N,bs,Hkv,hd//2] with f16 group-scale
    pools [N,bs,Hkv,hd//g]; updated in place; tables [B,M] int32; pos int
    or [B]. Writes this token's K/V (codes and scales) into its table's
    block, then reads the whole sequence through the table with the paged
    attention kernel (``paged_qdecode`` for int8, ``paged_q4decode`` for
    int4)."""
    prec = _kv_tier(cfg, prefill=False)
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
