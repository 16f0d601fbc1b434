"""Causal flash prefill: port of
``repro/kernels/flash_prefill.py::flash_prefill_attention``, over int8 K/V
with f32 per-(position, head) scales ``flash_qprefill_attention``, and over
nibble-packed int4 K/V with f16 per-(position, head, group) scales
``flash_q4prefill_attention``.

Source note. The TPU kernel walks (batch, kv head, q tile, k tile) in grid
order, carrying the online-softmax state in VMEM scratch across the
sequential k axis and skipping tiles above the diagonal. On the H100
(``csrc/flash_prefill.cu``) blocks run in no order, so each block owns a
tile of group-flattened query rows (``r = s * G + g``) of one (batch, kv
head) and loops over the KV tiles itself up to its last query position,
keeping the running max, normalizer and accumulator in registers. Bytes
bound it (the f32 output is the largest stream). bf16 q/k/v take the
tensor-core body (``flash_tc``): Q held as bf16 mma fragments, K/V tiles
in a cp.async ring, both products on ``mma.sync`` bf16 -> f32, and the
value product over p split in two bf16 terms (hi + lo), which keeps it within
~1e-5 of the f32 reference where one bf16 rounding of p errs by ~3e-3.
f32 q/k/v take the same body with every operand split in two bf16 terms
and three products per mma (hi.hi + hi.lo + lo.hi: ~2e-5). bf16 prefills
of MLA's 192 / 128 width class take a body of their own (``flash_mla``,
``MLA_BODY``), built for the H100's full tensor rate: a producer thread
streams 128-key K / V tiles by TMA into an mbarrier ring, and two consumer
warpgroups of 64 query rows run both products on ``wgmma`` (P from
registers, split hi + lo) with the softmax in log2 units. The int8
variant takes the same loop over codes (``flash_qtc``): tiles of
int8 codes and their scales in the cp.async ring (1 byte per K/V element
instead of 2), one pass per tile turning the codes into bf16 (exact), the
score ``(q . codes) * k_s / sqrt(hd)`` as the TPU kernel computes it, and
the V scale folded into p per key before the hi + lo split; f32 q is split
once into two bf16 terms. The int4 variant takes the same loop over nibble
codes (``flash_q4tc``): tiles of packed bytes in the cp.async ring
(half a byte per element) with their f16 group scales loaded a tile ahead,
one pass per tile turning the nibbles into bf16 (exact). A code times its
f16 scale needs up to 15 significand bits, more than bf16 holds, so the
scales stay in f32: each group of 32 K columns has its own accumulator,
multiplied by its key's group scale before it joins the score, and for
each group of 32 V columns the scale folds into p per key before the hi +
lo split; f32 q is split once into two bf16 terms.

Tiles. Each entry takes keyword-only ``block_q`` / ``block_k``: the tile
its body launches, ``block_q`` group-flattened query rows (``r = s * G +
g``: one block holds ``block_q`` rows whatever G is, where JAX's
``block_q`` counts positions, ``block_q * G`` rows) by ``block_k`` keys.
The bodies instantiate a few pairs per width class (``autotune.TILES``,
read from ``tc::TileSet`` of the source); ``None`` takes the tile of old,
64 x 64 (``autotune.DEFAULT_TILE``; ``flash_mla``'s one tile, 128 x 128,
for its body). A pair the body does not instantiate raises before any
launch, on any device: nothing is rounded to a neighbour and nothing falls
back. Rows and keys past S are masked, so no tile is clipped to S. The
``cuda`` backend resolves each call's pair through ``autotune.tile_config``
(``api/backends.py``); ``launches_by_tile`` counts launches per
``"<body>:<block_q>x<block_k>"``.

Training. ``flash_prefill`` is the one kernel with a gradient: under grad
mode its CUDA branch runs ``flash_tc`` inside an autograd Function whose
backward is the plain ``ref.flash_prefill_vjp`` (P recomputed in f32), as
the JAX package differentiates its plain ``flash_prefill_ref`` (a
``pallas_call`` has no transpose rule). Every other wrapper here, like
each in this package, raises when asked for a gradient on the card
(``_build.refuse_grad``).

On a mesh. DTensor q / k / v (a training step under ``sharding.set_mesh``)
go through ``local_map``: each rank runs the kernel (the plain version on
the CPU) on its own rows and heads. q's placements must be its checked spec
``(batch axes, None, "model", None)``, and k / v's theirs; where "model" does
not divide the kv heads, k / v are replicated over it and each rank slices
the kv heads its query heads read (their grads then sum over "model"). Any
other placement raises: nothing falls back to an unsharded call.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build, autotune
from repro_torch.kernels.quantize import KV_GROUP
from repro_torch.kernels.ref import (flash_prefill_ref, flash_prefill_vjp,
                                     flash_q4prefill_ref, flash_qprefill_ref)

#: the widest q / k rows ``flash_prefill`` takes (MLA's qk_nope + qk_rope =
#: 192 at deepseek-v2's width: the kernel's 192 / 128 width class) and the
#: widest v rows of every body; the quantized prefills take hd up to
#: MAX_V_DIM (MLA has no quantized KV tier)
MAX_HEAD_DIM = 192
MAX_V_DIM = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the body ``flash_prefill_fwd`` launches for each dtype: the tensor-core
#: body over bf16 operands ("tc") or over two-term splits of f32 operands
#: ("tc_f32")
BODY = {torch.bfloat16: "tc", torch.float32: "tc_f32"}
#: the warp-specialised wgmma + TMA body of the bf16 MLA class
#: (``flash_mla_fwd``), which ``body_for`` picks in place of "tc"
MLA_BODY = "tc_mla"
BODIES = (*BODY.values(), MLA_BODY)
#: the body ``flash_qprefill_fwd`` launches for each q dtype: the int8
#: tensor-core body over bf16 q ("qtc") or over a two-term split of f32 q
#: ("qtc_f32")
QBODY = {torch.bfloat16: "qtc", torch.float32: "qtc_f32"}
#: the body ``flash_q4prefill_fwd`` launches for each q dtype: the int4
#: tensor-core body over bf16 q ("q4tc") or over a two-term split of f32 q
#: ("q4tc_f32")
Q4BODY = {torch.bfloat16: "q4tc", torch.float32: "q4tc_f32"}
_LIB = "flash_prefill"
#: the ``flash_tc`` width classes (one instantiation each per dtype)
CLASSES = ("64", "96", "128", "192x128")


def width_class(hd: int, dv: int) -> str:
    """The ``flash_tc`` width class ``flash_prefill_fwd`` launches for (hd,
    dv): MLA's 192 / 128 above hd 128, else the wider of hd and dv rounded
    up to 64, 96 or 128 (``dispatch`` and ``by_width`` in the source)."""
    if hd > MAX_V_DIM:
        return "192x128"
    w = max(hd, dv)
    return "64" if w <= 64 else "96" if w <= 96 else "128"


def body_for(q, k, v) -> str:
    """The body ``flash_prefill`` launches for checked CUDA tensors:
    ``MLA_BODY`` for bf16 rows of the 192x128 class that TMA can read (hd
    and dv multiples of 8, the three tensors 16-byte aligned: every MLA
    prefill of the models), else ``BODY[q.dtype]``."""
    hd, dv = q.shape[3], v.shape[3]
    if q.dtype == torch.bfloat16 and width_class(hd, dv) == "192x128" \
            and hd % 8 == 0 and dv % 8 == 0 \
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v)):
        return MLA_BODY
    return BODY[q.dtype]


def _tile_keys(bodies):
    """Every ``"<body>:<block_q>x<block_k>"`` key of the bodies' tiles."""
    return [f"{b}:{bq}x{bk}" for b in bodies
            for bq, bk in sorted({t for w in (64, 96, 128, 192)
                                  for t in autotune.tiles(b, w)})]


def tile_for(body: str, hd: int, dv: int, block_q=None, block_k=None):
    """The (block_q, block_k) ``body`` launches at (hd, dv): each ``None``
    the default's (``autotune.DEFAULT_TILE``, ``MLA_TILE`` for the MLA
    body); a pair the body does not instantiate at its width class raises
    ValueError."""
    default = autotune.MLA_TILE if body == MLA_BODY \
        else autotune.DEFAULT_TILE
    tile = (default[0] if block_q is None else int(block_q),
            default[1] if block_k is None else int(block_k))
    w = autotune.width(hd, dv)
    have = autotune.tiles(body, w)
    if tile not in have:
        raise ValueError(f"tile {tile} (block_q, block_k) is not "
                         f"instantiated for body {body!r} at width class "
                         f"{w}; its tiles: {list(have)}")
    return tile


def _check(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B,S,H,D]")
    b, s, hq, hd = q.shape
    hkv, dv = k.shape[2], v.shape[3]
    if k.shape != (b, s, hkv, hd) or v.shape[:3] != (b, s, hkv):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} do not match")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if not (1 <= hd <= MAX_HEAD_DIM and 1 <= dv <= MAX_V_DIM):
        raise ValueError(f"hd={hd}, dv={dv}: hd must be in "
                         f"1..{MAX_HEAD_DIM}, dv in 1..{MAX_V_DIM}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q/k/v dtypes {q.dtype}/{k.dtype}/{v.dtype}: one of "
                        "float32, bfloat16 for all three")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _flash_tc(q, k, v, body, tile):
    """Launch ``body`` (``flash_mla`` or ``flash_tc``) at ``tile`` on
    checked CUDA tensors and count it."""
    b, s, hq, hd = q.shape
    hkv, dv = k.shape[2], v.shape[3]
    out = torch.empty((b, s, hq, dv), dtype=torch.float32, device=q.device)
    if body == MLA_BODY:
        fn = _build.function(_LIB, "flash_mla_fwd", [
            _build.P, _build.P, _build.P, _build.P, _build.I, _build.I,
            _build.I, _build.I, _build.I, _build.I, _build.I, _build.I,
            _build.P])
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                s, hq, hkv, hd, dv, *tile, _build.stream_of(q))
        _build.check(_LIB, rc, "flash_mla_fwd")
    else:
        fn = _build.function(_LIB, "flash_prefill_fwd", [
            _build.P, _build.P, _build.P, _build.I, _build.P, _build.I,
            _build.I, _build.I, _build.I, _build.I, _build.I, _build.I,
            _build.I, _build.P])
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                _DTYPE_CODE[q.dtype], out.data_ptr(), b, s, hq, hkv, hd, dv,
                *tile, _build.stream_of(q))
        _build.check(_LIB, rc, "flash_prefill_fwd")
    _build.count(flash_prefill, launches_by_body=body,
                 launches_by_class=width_class(hd, dv),
                 launches_by_tile=f"{body}:{tile[0]}x{tile[1]}")
    return out


class _FlashPrefill(torch.autograd.Function):
    """The kernel's forward under autograd, at the caller's tile. The
    backward is the plain ``flash_prefill_vjp``, as the JAX package
    differentiates the plain ``flash_prefill_ref`` (``pallas_call`` has no
    transpose rule); under activation checkpointing the recompute launches
    the kernel again."""

    @staticmethod
    def forward(ctx, q, k, v, body, tile):
        out = _flash_tc(q, k, v, body, tile)
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        return (*flash_prefill_vjp(*ctx.saved_tensors, dout), None, None)


def flash_prefill(q, k, v, *, block_q=None, block_k=None):
    """q [B,S,Hq,hd]; k [B,S,Hkv,hd]; v [B,S,Hkv,dv] -> [B,S,Hq,dv] f32.
    CPU tensors take the plain version (differentiable as it is); CUDA
    tensors launch the kernel's tensor-core body ``body_for`` picks at the
    tile ``tile_for`` gives (``block_q`` rows by ``block_k`` keys, see the
    module docstring), through ``_FlashPrefill`` when grad mode is on and
    an input requires grad; DTensors run either on each rank's shard
    (``local_map``). A tile the body does not instantiate raises first."""
    from torch.distributed.tensor import DTensor

    if isinstance(q, DTensor):
        from repro_torch.models.sharding import attention_local

        return attention_local(
            functools.partial(flash_prefill, block_q=block_q,
                              block_k=block_k), q, k, v, "flash_prefill")
    _check(q, k, v)
    body = body_for(q, k, v)
    tile = tile_for(body, q.shape[3], v.shape[3], block_q, block_k)
    if q.device.type == "cpu":
        return flash_prefill_ref(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_prefill kernel for {q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashPrefill.apply(q, k, v, body, tile)
    return _flash_tc(q, k, v, body, tile)


flash_prefill.launches = 0
flash_prefill.launches_by_body = {body: 0 for body in BODIES}
flash_prefill.launches_by_class = {c: 0 for c in CLASSES}
flash_prefill.launches_by_tile = {key: 0 for key in _tile_keys(BODIES)}


def _check_q(q, k_i8, k_s, v_i8, v_s):
    if q.dim() != 4 or k_i8.dim() != 4 or v_i8.dim() != 4:
        raise ValueError("q, k_i8, v_i8 must be [B,S,H,D]")
    b, s, hq, hd = q.shape
    hkv, dv = k_i8.shape[2], v_i8.shape[3]
    if k_i8.shape != (b, s, hkv, hd) or v_i8.shape[:3] != (b, s, hkv):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k_i8.shape)} "
                         f"v {tuple(v_i8.shape)} do not match")
    if k_s.shape != (b, s, hkv) or v_s.shape != k_s.shape:
        raise ValueError(f"scales {tuple(k_s.shape)} / {tuple(v_s.shape)} "
                         f"must be [B,S,Hkv] = {(b, s, hkv)}")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if not (1 <= hd <= MAX_V_DIM and 1 <= dv <= MAX_V_DIM):
        raise ValueError(f"hd={hd}, dv={dv}: each must be in 1..{MAX_V_DIM}")
    if q.dtype not in _DTYPE_CODE or k_i8.dtype != torch.int8 \
            or v_i8.dtype != torch.int8 or k_s.dtype != torch.float32 \
            or v_s.dtype != torch.float32:
        raise TypeError(f"q {q.dtype} must be float32 or bfloat16, codes "
                        f"int8 ({k_i8.dtype}/{v_i8.dtype}), scales float32 "
                        f"({k_s.dtype}/{v_s.dtype})")
    for name, t in (("k_i8", k_i8), ("k_s", k_s), ("v_i8", v_i8),
                    ("v_s", v_s)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k_i8", k_i8), ("k_s", k_s), ("v_i8", v_i8),
                    ("v_s", v_s)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_qprefill(q, k_i8, k_s, v_i8, v_s, *, block_q=None, block_k=None):
    """q [B,S,Hq,hd] f32 or bf16; k_i8 [B,S,Hkv,hd], v_i8 [B,S,Hkv,dv]
    int8; k_s/v_s [B,S,Hkv] f32 -> [B,S,Hq,dv] f32. CPU tensors take the
    plain version; CUDA tensors launch the kernel's int8 tensor-core body
    for q's dtype (``QBODY``) at the tile ``tile_for`` gives (raising first
    on a pair it does not instantiate)."""
    _check_q(q, k_i8, k_s, v_i8, v_s)
    body = QBODY[q.dtype]
    tile = tile_for(body, q.shape[3], v_i8.shape[3], block_q, block_k)
    if q.device.type == "cpu":
        return flash_qprefill_ref(q, k_i8, k_s, v_i8, v_s)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_qprefill kernel for {q.device}")
    _build.refuse_grad("flash_qprefill", q, k_s, v_s)
    b, s, hq, hd = q.shape
    hkv, dv = k_i8.shape[2], v_i8.shape[3]
    out = torch.empty((b, s, hq, dv), dtype=torch.float32, device=q.device)
    fn = _build.function(_LIB, "flash_qprefill_fwd", [
        _build.P, _build.I, _build.P, _build.P, _build.P, _build.P, _build.P,
        _build.I, _build.I, _build.I, _build.I, _build.I, _build.I, _build.I,
        _build.I, _build.P])
    rc = fn(q.data_ptr(), _DTYPE_CODE[q.dtype], k_i8.data_ptr(),
            k_s.data_ptr(), v_i8.data_ptr(), v_s.data_ptr(), out.data_ptr(),
            b, s, hq, hkv, hd, dv, *tile, _build.stream_of(q))
    _build.check(_LIB, rc, "flash_qprefill_fwd")
    _build.count(flash_qprefill, launches_by_body=body,
                 launches_by_tile=f"{body}:{tile[0]}x{tile[1]}")
    return out


flash_qprefill.launches = 0
flash_qprefill.launches_by_body = {body: 0 for body in QBODY.values()}
flash_qprefill.launches_by_tile = {
    key: 0 for key in _tile_keys(QBODY.values())}


def _check_q4(q, k_i4, k_s, v_i4, v_s):
    if q.dim() != 4 or k_i4.dim() != 4 or v_i4.dim() != 4:
        raise ValueError("q, k_i4, v_i4 must be [B,S,H,D]")
    b, s, hq, hd = q.shape
    hkv, dv = k_i4.shape[2], v_i4.shape[3] * 2
    if k_i4.shape != (b, s, hkv, hd // 2) or v_i4.shape[:3] != (b, s, hkv):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k_i4.shape)} "
                         f"v {tuple(v_i4.shape)} do not match (packed K "
                         f"width hd // 2)")
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    if not (hd % KV_GROUP == 0 and dv % KV_GROUP == 0
            and KV_GROUP <= hd <= MAX_V_DIM
            and KV_GROUP <= dv <= MAX_V_DIM):
        raise ValueError(f"hd={hd}, dv={dv}: each must be a multiple of "
                         f"{KV_GROUP} up to {MAX_V_DIM}")
    if k_s.shape != (b, s, hkv, hd // KV_GROUP) \
            or v_s.shape != (b, s, hkv, dv // KV_GROUP):
        raise ValueError(f"scales {tuple(k_s.shape)} / {tuple(v_s.shape)} "
                         f"must be [B,S,Hkv,hd//{KV_GROUP}] / "
                         f"[B,S,Hkv,dv//{KV_GROUP}]")
    if q.dtype not in _DTYPE_CODE or k_i4.dtype != torch.int8 \
            or v_i4.dtype != torch.int8 or k_s.dtype != torch.float16 \
            or v_s.dtype != torch.float16:
        raise TypeError(f"q {q.dtype} must be float32 or bfloat16, packed "
                        f"codes int8 ({k_i4.dtype}/{v_i4.dtype}), scales "
                        f"float16 ({k_s.dtype}/{v_s.dtype})")
    for name, t in (("k_i4", k_i4), ("k_s", k_s), ("v_i4", v_i4),
                    ("v_s", v_s)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k_i4", k_i4), ("k_s", k_s), ("v_i4", v_i4),
                    ("v_s", v_s)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_q4prefill(q, k_i4, k_s, v_i4, v_s, *, block_q=None,
                    block_k=None):
    """q [B,S,Hq,hd] f32 or bf16; k_i4 [B,S,Hkv,hd//2], v_i4
    [B,S,Hkv,dv//2] int4 packed two codes per byte; k_s [B,S,Hkv,hd//32],
    v_s [B,S,Hkv,dv//32] f16 -> [B,S,Hq,dv] f32. hd and dv must be
    multiples of 32 up to 128. CPU tensors take the plain version; CUDA
    tensors launch the kernel's int4 tensor-core body for q's dtype
    (``Q4BODY``) at the tile ``tile_for`` gives (raising first on a pair
    it does not instantiate)."""
    _check_q4(q, k_i4, k_s, v_i4, v_s)
    body = Q4BODY[q.dtype]
    tile = tile_for(body, q.shape[3], 2 * v_i4.shape[3], block_q, block_k)
    if q.device.type == "cpu":
        return flash_q4prefill_ref(q, k_i4, k_s, v_i4, v_s)
    if q.device.type != "cuda":
        raise ValueError(f"no flash_q4prefill kernel for {q.device}")
    _build.refuse_grad("flash_q4prefill", q, k_s, v_s)
    b, s, hq, hd = q.shape
    hkv, dv = k_i4.shape[2], v_i4.shape[3] * 2
    out = torch.empty((b, s, hq, dv), dtype=torch.float32, device=q.device)
    fn = _build.function(_LIB, "flash_q4prefill_fwd", [
        _build.P, _build.I, _build.P, _build.P, _build.P, _build.P, _build.P,
        _build.I, _build.I, _build.I, _build.I, _build.I, _build.I, _build.I,
        _build.I, _build.P])
    rc = fn(q.data_ptr(), _DTYPE_CODE[q.dtype], k_i4.data_ptr(),
            k_s.data_ptr(), v_i4.data_ptr(), v_s.data_ptr(), out.data_ptr(),
            b, s, hq, hkv, hd, dv, *tile, _build.stream_of(q))
    _build.check(_LIB, rc, "flash_q4prefill_fwd")
    _build.count(flash_q4prefill, launches_by_body=body,
                 launches_by_tile=f"{body}:{tile[0]}x{tile[1]}")
    return out


flash_q4prefill.launches = 0
flash_q4prefill.launches_by_body = {body: 0 for body in Q4BODY.values()}
flash_q4prefill.launches_by_tile = {
    key: 0 for key in _tile_keys(Q4BODY.values())}
