"""Paged decode attention: port of
``repro/kernels/paged_attn.py::paged_decode_attention`` (fp pools),
``paged_qdecode_attention`` (int8 pools with f32 scale pools) and
``paged_q4decode_attention`` (int4 pools with f16 group-scale pools).

Source note. The TPU kernel walks the grid (B, Hkv, M) with the block table
in scalar prefetch, so its index map DMAs pool block ``tables[b, m]`` at
step m, and carries the online-softmax state in VMEM across the sequential
m axis. On the H100 (``csrc/paged_attn.cu``) masked slots are never read,
and the running max, normalizer and G x hd accumulator stay in f32.

All three pool kinds run one loop (``csrc/decode_split.cuh``) in three
code formats: one launch runs a cluster of up to 8 CTAs per (sequence, kv
head); each reads ``pos[b]``, takes an equal share of the sequence's slots
in 32-slot tiles and stages its share's table entries in shared memory
once; its warps walk their slots with the next step's rows in flight and
no block barrier; the rank-0 CTA merges the partials through distributed
shared memory, in rank order, so two calls give the same bits.

* bf16 and f32 pools (``Fp``): a lane reads 8 elements of a row (16 bytes
  of bf16, 32 of f32), exact in f32, and no scale.
* int8 pools: the K scale multiplies the score after the dot and the V
  scale is folded in per slot, as the TPU kernel does.
* int4 pools: a lane's codes lie in one group of 32, so it loads that
  group's two f16 scales beside them and dequantizes K and V before the
  dot, as the TPU int4 kernel does.

Each is bound by the bytes of the valid K/V rows: at stablelm-1.6b width,
eight sequences averaging ~300 positions read ~20 MB per layer from bf16
pools (~6 us at 3.35 TB/s), ~10.7 MB from int8 pools with their scales
(~3.2 us) and ~5.8 MB from int4 pools (~1.7 us).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quantize import KV_GROUP
from repro_torch.kernels.ref import (paged_decode_ref, paged_q4decode_ref,
                                     paged_qdecode_ref)

MAX_GROUP = 8            # query heads per kv head
MAX_HEAD_DIM = 128
KEY_TILE = 32            # slots per tile; the block size must divide it
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB = "paged_attn"


# head_dim elements per 16-byte load, by pool kind
_VEC = {"fp": 8, "int8": 16, "int4": 32}


def _check(q, k_pool, v_pool, tables, pos, kind="fp"):
    if q.dim() != 4 or k_pool.dim() != 4:
        raise ValueError("q must be [B,Hkv,G,hd] and pools [N,bs,Hkv,hd]")
    b, hkv, g, hd = q.shape
    bs = k_pool.shape[1]
    width = hd // 2 if kind == "int4" else hd      # stored elements per row
    if k_pool.shape[2:] != (hkv, width) or v_pool.shape != k_pool.shape:
        raise ValueError(f"pools {tuple(k_pool.shape)} / {tuple(v_pool.shape)}"
                         f" do not match q {tuple(q.shape)} (row width "
                         f"{width})")
    if tables.dim() != 2 or tables.shape[0] != b or pos.shape != (b,):
        raise ValueError(f"tables {tuple(tables.shape)} / pos "
                         f"{tuple(pos.shape)} must be [B,M] / [B] with B={b}")
    if tables.dtype != torch.int32 or pos.dtype != torch.int32:
        raise TypeError("tables and pos must be int32")
    vec = _VEC[kind]
    if not (1 <= g <= MAX_GROUP and vec <= hd <= MAX_HEAD_DIM
            and hd % vec == 0):
        raise ValueError(f"G={g}, hd={hd}: need G <= {MAX_GROUP} and hd a "
                         f"multiple of {vec} up to {MAX_HEAD_DIM}")
    if KEY_TILE % bs:
        raise ValueError(f"block size {bs} must divide {KEY_TILE}")
    quant = kind != "fp"
    pool_ok = (k_pool.dtype == torch.int8 if quant
               else k_pool.dtype in _DTYPE_CODE)
    if q.dtype not in _DTYPE_CODE or not pool_ok \
            or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"q / pool dtypes {q.dtype} / {k_pool.dtype} / "
                        f"{v_pool.dtype}: q float32 or bfloat16, pools "
                        f"{'int8' if quant else 'float32 or bfloat16'}, "
                        f"alike")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def paged_decode(q, k_pool, v_pool, tables, pos):
    """q [B,Hkv,G,hd]; pools [N,bs,Hkv,hd]; tables [B,M] int32 (-1 = no
    block); pos [B] int32 -> [B,Hkv,G,hd] f32. CPU tensors take the plain
    version; CUDA tensors launch the kernel."""
    _check(q, k_pool, v_pool, tables, pos)
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pool, v_pool, tables, pos)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_decode kernel for {q.device}")
    _build.refuse_grad("paged_decode", q, k_pool, v_pool)
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("pools must be 16-byte aligned (16-byte loads)")
    b, hkv, g, hd = q.shape
    out = torch.empty((b, hkv, g, hd), dtype=torch.float32, device=q.device)
    fn = _build.function(_LIB, "paged_decode_fwd", [
        _build.P, _build.I, _build.P, _build.P, _build.I, _build.P, _build.P,
        _build.P, _build.I, _build.I, _build.I, _build.I, _build.I, _build.I,
        _build.P])
    rc = fn(q.data_ptr(), _DTYPE_CODE[q.dtype], k_pool.data_ptr(),
            v_pool.data_ptr(), _DTYPE_CODE[k_pool.dtype], tables.data_ptr(),
            pos.data_ptr(), out.data_ptr(), b, tables.shape[1],
            k_pool.shape[1], hkv, g, hd, _build.stream_of(q))
    _build.check(_LIB, rc, "paged_decode_fwd")
    _build.count(paged_decode)
    return out


paged_decode.launches = 0


def _check_scales(k_pool, k_scale, v_scale, shape=None,
                  dtype=torch.float32):
    """Scale pools of ``shape`` (default [N,bs,Hkv]) and ``dtype``."""
    shape = tuple(k_pool.shape[:3]) if shape is None else tuple(shape)
    if k_scale.shape != shape or v_scale.shape != k_scale.shape:
        raise ValueError(f"scale pools {tuple(k_scale.shape)} / "
                         f"{tuple(v_scale.shape)} must be {shape}")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != k_pool.device:
            raise ValueError(f"{name} on {t.device}, pools on "
                             f"{k_pool.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def paged_qdecode(q, k_pool, k_scale, v_pool, v_scale, tables, pos):
    """q [B,Hkv,G,hd]; int8 pools [N,bs,Hkv,hd] with f32 scale pools
    [N,bs,Hkv]; tables [B,M] int32 (-1 = no block); pos [B] int32 ->
    [B,Hkv,G,hd] f32. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    _check(q, k_pool, v_pool, tables, pos, kind="int8")
    _check_scales(k_pool, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_qdecode_ref(q, k_pool, k_scale, v_pool, v_scale, tables,
                                 pos)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_qdecode kernel for {q.device}")
    _build.refuse_grad("paged_qdecode", q, k_scale, v_scale)
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("pools must be 16-byte aligned (16-byte loads)")
    b, hkv, g, hd = q.shape
    out = torch.empty((b, hkv, g, hd), dtype=torch.float32, device=q.device)
    fn = _build.function(_LIB, "paged_qdecode_fwd", [
        _build.P, _build.I, _build.P, _build.P, _build.P, _build.P, _build.P,
        _build.P, _build.P, _build.I, _build.I, _build.I, _build.I, _build.I,
        _build.I, _build.P])
    rc = fn(q.data_ptr(), _DTYPE_CODE[q.dtype], k_pool.data_ptr(),
            k_scale.data_ptr(), v_pool.data_ptr(), v_scale.data_ptr(),
            tables.data_ptr(), pos.data_ptr(), out.data_ptr(), b,
            tables.shape[1], k_pool.shape[1], hkv, g, hd,
            _build.stream_of(q))
    _build.check(_LIB, rc, "paged_qdecode_fwd")
    _build.count(paged_qdecode)
    return out


paged_qdecode.launches = 0


def paged_q4decode(q, k_pool, k_scale, v_pool, v_scale, tables, pos):
    """q [B,Hkv,G,hd]; int4 pools [N,bs,Hkv,hd//2] (two codes per byte)
    with f16 group-scale pools [N,bs,Hkv,hd//32]; tables [B,M] int32 (-1 =
    no block); pos [B] int32 -> [B,Hkv,G,hd] f32. hd must be a multiple of
    32 up to 128 and G at most 8. CPU tensors take the plain version; CUDA
    tensors launch the kernel."""
    _check(q, k_pool, v_pool, tables, pos, kind="int4")
    hd = q.shape[-1]
    _check_scales(k_pool, k_scale, v_scale,
                  tuple(k_pool.shape[:3]) + (hd // KV_GROUP,), torch.float16)
    if q.device.type == "cpu":
        return paged_q4decode_ref(q, k_pool, k_scale, v_pool, v_scale,
                                  tables, pos)
    if q.device.type != "cuda":
        raise ValueError(f"no paged_q4decode kernel for {q.device}")
    _build.refuse_grad("paged_q4decode", q, k_scale, v_scale)
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("pools must be 16-byte aligned (16-byte loads)")
    b, hkv, g, _ = q.shape
    out = torch.empty((b, hkv, g, hd), dtype=torch.float32, device=q.device)
    fn = _build.function(_LIB, "paged_q4decode_fwd", [
        _build.P, _build.I, _build.P, _build.P, _build.P, _build.P, _build.P,
        _build.P, _build.P, _build.I, _build.I, _build.I, _build.I, _build.I,
        _build.I, _build.P])
    rc = fn(q.data_ptr(), _DTYPE_CODE[q.dtype], k_pool.data_ptr(),
            k_scale.data_ptr(), v_pool.data_ptr(), v_scale.data_ptr(),
            tables.data_ptr(), pos.data_ptr(), out.data_ptr(), b,
            tables.shape[1], k_pool.shape[1], hkv, g, hd,
            _build.stream_of(q))
    _build.check(_LIB, rc, "paged_q4decode_fwd")
    _build.count(paged_q4decode)
    return out


paged_q4decode.launches = 0
