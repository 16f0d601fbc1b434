"""Static w8a8 int8 GEMM: port of ``repro/kernels/qmatmul.py::qmatmul_static``.

Source note. The TPU kernel quantizes x with the calibrated scalar
``act_scale`` (``x * (1 / a_scale)``), runs an int8 MXU product with an
int32 accumulator over K tiles and multiplies by ``a_scale * w_scale`` at
the end. On the H100 (``csrc/qmatmul.cu``) the weight is the packed copy
``pack_weight`` makes once when a param tree moves to the card: K-major
``[N, Kp]``, the only layout ``wgmma`` takes for 8-bit operands. ``plan``
picks one of two bodies by M:

- decode (M <= ``GEMV_MAX_M``): one launch per linear. Every block
  quantizes the M rows into shared memory and streams its weight rows with
  16-byte loads into ``mma.sync`` m16n8k32; bound by the int8 weight bytes.
- prefill: ``quantize_rows`` writes the codes once, then a warp-specialised
  ``wgmma`` s8 GEMM over a TMA ring (a producer warp, one or two consumer
  warpgroups) accumulates in int32 registers; bound by the int8
  tensor-core rate.

Both epilogues keep the order ``acc * (a_scale * w_scale)`` and write f32,
or bf16 rounded from that f32 when the caller asks for it (``linear`` asks
for its input's dtype), so no cast pass follows.

This module also holds the packing, the plan and the launchers that
``dynquant`` shares.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (qmatmul_static_packed_ref,
                                     qmatmul_static_ref, quantize_rows_ref,
                                     quantize_static_ref)

PACK_K = 128                 # K tile of both bodies (csrc/qmatmul.cu)
GEMV_MAX_M = 16              # the decode body's rows: one m16 mma tile
GEMV_PAD = 8                 # code row stride Kp + 8 in shared memory
GROUP_M = 16                 # tile rows a wave of wgmma blocks walks together
#: wgmma tiles (BM, BN), largest first; ``qmm_wgmma`` instantiates these
TILES = ((128, 256), (128, 128), (64, 128), (64, 64), (64, 32), (64, 16))
_SMS = 132                   # H100 SXM streaming multiprocessors
_MAX_SMEM = 227 * 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}   # of x and of the output
_LIB = "qmatmul"
BODIES = ("gemv", "wgmma")


def packed_k(k: int) -> int:
    return -(-k // PACK_K) * PACK_K


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """The int8 codes of a linear leaf, [K, N] (the JAX layout) -> K-major
    [N, Kp] int8 with a zero K tail, on the same device. Its scales need no
    repacking."""
    if w.dim() != 2 or w.dtype != torch.int8:
        raise ValueError(f"weight codes must be int8 [K, N], got {w.dtype} "
                         f"{tuple(w.shape)}")
    k, n = w.shape
    out = torch.zeros((n, packed_k(k)), dtype=torch.int8, device=w.device)
    out[:, :k] = w.t()
    return out


# ------------------------------------------------------------------ #
# The plan: which body, which tile, how many blocks
# ------------------------------------------------------------------ #
class Plan(NamedTuple):
    body: str            # "gemv" or "wgmma"
    bm: int              # rows of a block's output tile
    bn: int              # columns of a block's output tile
    ng: int              # gemv: column groups of 8 a block (0 for wgmma)
    blocks: int


def gemv_smem(m: int, kp: int) -> int:
    """Shared memory of the decode body (``gemv_smem`` in the source)."""
    return -(-m * (kp + GEMV_PAD) // 16) * 16 + 4 * GEMV_MAX_M + 4 * 256 * 4


def plan(m: int, n: int, k: int) -> Plan:
    """The decode body for M <= GEMV_MAX_M (when the M code rows fit in
    shared memory), with the widest column block that still gives two
    blocks per SM; else the largest wgmma tile that puts at least 3/4 of a
    wave of blocks on the card (the smallest tile when none does)."""
    if m <= GEMV_MAX_M and gemv_smem(m, packed_k(k)) <= _MAX_SMEM:
        for ng in (8, 4, 2, 1):
            blocks = -(-n // (8 * ng))
            if blocks >= 2 * _SMS or ng == 1:
                return Plan("gemv", m, 8 * ng, ng, blocks)
    for bm, bn in TILES:
        blocks = -(-m // bm) * -(-n // bn)
        if 4 * blocks >= 3 * _SMS or (bm, bn) == TILES[-1]:
            return Plan("wgmma", bm, bn, 0, blocks)
    raise AssertionError("unreachable")


def block_tiles(p: Plan, m: int, n: int
                ) -> Iterator[Tuple[int, int, int, int]]:
    """(row0, row1, col0, col1) of each block's output tile, in block
    order, as the kernels compute them (``tile_of`` in the source)."""
    if p.body == "gemv":
        for b in range(p.blocks):
            yield 0, m, b * p.bn, min(n, (b + 1) * p.bn)
        return
    tiles_m, tiles_n = -(-m // p.bm), -(-n // p.bn)
    for b in range(p.blocks):
        per_group = GROUP_M * tiles_n
        first = b // per_group * GROUP_M
        rows = min(tiles_m - first, GROUP_M)
        tm, tn = first + b % per_group % rows, b % per_group // rows
        yield (tm * p.bm, min(m, (tm + 1) * p.bm), tn * p.bn,
               min(n, (tn + 1) * p.bn))


# ------------------------------------------------------------------ #
# Checks and launchers
# ------------------------------------------------------------------ #
def _check_x(x, w, w_scale, n: int, out_dtype):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype}: float32 or bfloat16 only")
    if w.dtype != torch.int8:
        raise TypeError(f"weight dtype {w.dtype}, want int8")
    if w_scale.dtype != torch.float32 or w_scale.numel() != n:
        raise ValueError(f"w_scale must be f32 with {n} elements")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"out_dtype {out_dtype}: float32 or bfloat16 only")
    for name, t in (("x", x), ("w", w), ("w_scale", w_scale)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_operands(x, w_int8, w_scale, out_dtype=torch.float32):
    if x.dim() != 2 or w_int8.dim() != 2 or x.shape[1] != w_int8.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} @ w {tuple(w_int8.shape)}: "
                         "need x [M,K] and w_int8 [K,N]")
    _check_x(x, w_int8, w_scale, w_int8.shape[1], out_dtype)


def _check_packed(x, w_packed, w_scale, out_dtype=torch.float32):
    if x.dim() != 2 or w_packed.dim() != 2 \
            or w_packed.shape[1] != packed_k(x.shape[1]):
        raise ValueError(f"x {tuple(x.shape)} @ w_packed "
                         f"{tuple(w_packed.shape)}: need x [M,K] and w_packed "
                         "[N, K rounded up to PACK_K]")
    _check_x(x, w_packed, w_scale, w_packed.shape[0], out_dtype)


def _quantize_cuda(x, act_scale=None):
    """Launch the row-quantize kernel: (codes [M, Kp], a_scale [M, 1] or
    None). Static mode passes ``act_scale`` as a 1-element f32 tensor."""
    m, k = x.shape
    kp = packed_k(k)
    codes = torch.empty((m, kp), dtype=torch.int8, device=x.device)
    a_scale = (torch.empty((m, 1), dtype=torch.float32, device=x.device)
               if act_scale is None else None)
    fn = _build.function(_LIB, "qmm_quantize", [_build.P, _build.I, _build.I,
                         _build.I, _build.I, _build.P, _build.P, _build.P,
                         _build.P])
    rc = fn(x.data_ptr(), _DTYPE_CODE[x.dtype], m, k, kp,
            None if act_scale is None else act_scale.data_ptr(),
            codes.data_ptr(), None if a_scale is None else a_scale.data_ptr(),
            _build.stream_of(x))
    _build.check(_LIB, rc, "qmm_quantize")
    return codes, a_scale


def _qmm_cuda(x, w_packed, w_scale, act_scale, out_dtype):
    """One GEMM on the card: x [M, K], w_packed [N, Kp], ``act_scale`` a
    1-element f32 tensor (static) or None (dynamic). Returns (out, body)."""
    m, k = x.shape
    n, kp = w_packed.shape
    p = plan(m, n, k)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    stream = _build.stream_of(x)
    if p.body == "gemv":
        fn = _build.function(_LIB, "qmm_gemv", [_build.P, _build.I, _build.P,
                             _build.P, _build.P, _build.P, _build.I, _build.I,
                             _build.I, _build.I, _build.I, _build.I,
                             _build.P])
        rc = fn(x.data_ptr(), _DTYPE_CODE[x.dtype], w_packed.data_ptr(),
                w_scale.data_ptr(),
                None if act_scale is None else act_scale.data_ptr(),
                out.data_ptr(), _DTYPE_CODE[out_dtype], m, n, k, kp, p.ng,
                stream)
        _build.check(_LIB, rc, "qmm_gemv")
        return out, p.body
    codes, a_scale = _quantize_cuda(x, act_scale)
    scale = a_scale if act_scale is None else act_scale
    fn = _build.function(_LIB, "qmm_wgmma", [_build.P, _build.P, _build.P,
                         _build.I, _build.P, _build.P, _build.I, _build.I,
                         _build.I, _build.I, _build.I, _build.I, _build.P])
    rc = fn(codes.data_ptr(), w_packed.data_ptr(), scale.data_ptr(),
            int(act_scale is None), w_scale.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[out_dtype], m, n, kp, p.bm, p.bn, stream)
    _build.check(_LIB, rc, "qmm_wgmma")
    return out, p.body


def _act_scale_tensor(act_scale, device) -> torch.Tensor:
    a = torch.as_tensor(act_scale, dtype=torch.float32, device=device)
    if a.numel() != 1:
        raise ValueError(f"act_scale must be a scalar, got {tuple(a.shape)}")
    return a.reshape(1).contiguous()


def quantize_activations(x, act_scale=None):
    """Activation codes as the kernel writes them: (codes [M,K] int8,
    a_scale [M,1] f32 or None). Dynamic when ``act_scale`` is None. For
    checking the codes against the plain version; counts no launch."""
    if x.device.type == "cpu":
        if act_scale is None:
            return quantize_rows_ref(x)
        return quantize_static_ref(x, act_scale), None
    _build.refuse_grad("quantize_activations", x, act_scale)
    a = None if act_scale is None else _act_scale_tensor(act_scale, x.device)
    codes, a_scale = _quantize_cuda(x.contiguous(), a)
    return codes[:, :x.shape[1]], a_scale


def qmatmul_static_packed(x, w_packed, w_scale, act_scale, *,
                          out_dtype=torch.float32):
    """x [M,K] f32/bf16; w_packed [N,Kp] int8 (``pack_weight``); w_scale
    [1,N] f32; act_scale scalar -> [M,N] ``out_dtype`` (f32 or bf16). CPU
    tensors take the plain version; CUDA tensors launch the kernel and
    count on ``qmatmul_static``."""
    _check_packed(x, w_packed, w_scale, out_dtype)
    if x.device.type == "cpu":
        return qmatmul_static_packed_ref(x, w_packed, w_scale,
                                         act_scale).to(out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no qmatmul_static kernel for {x.device}")
    _build.refuse_grad("qmatmul_static", x, w_scale, act_scale)
    a = _act_scale_tensor(act_scale, x.device)
    out, body = _qmm_cuda(x, w_packed, w_scale, a, out_dtype)
    _build.count(qmatmul_static, launches_by_body=body)
    return out


def qmatmul_static(x, w_int8, w_scale, act_scale, *,
                   out_dtype=torch.float32):
    """x [M,K] f32/bf16; w_int8 [K,N] int8; w_scale [1,N] f32; act_scale
    scalar -> [M,N] ``out_dtype``. CPU tensors take the plain version; a
    CUDA weight is packed (``pack_weight``) and the kernel launched."""
    _check_operands(x, w_int8, w_scale, out_dtype)
    if x.device.type == "cpu":
        return qmatmul_static_ref(x, w_int8, w_scale,
                                  act_scale).to(out_dtype)
    return qmatmul_static_packed(x, pack_weight(w_int8), w_scale, act_scale,
                                 out_dtype=out_dtype)


qmatmul_static.launches = 0
qmatmul_static.launches_by_body = {body: 0 for body in BODIES}
