"""Static w8a8 int8 GEMM: port of ``repro/kernels/qmatmul.py::qmatmul_static``.

Source note. The TPU kernel quantizes x with the calibrated scalar
``act_scale`` (``x * (1 / a_scale)``), runs an int8 MXU product with an
int32 accumulator over K tiles and multiplies by ``a_scale * w_scale`` at
the end. On the H100 (``csrc/qmatmul.cu``) a row-quantize kernel writes the
int8 codes once and an ``mma.sync`` s8 GEMM accumulates in int32 registers;
the epilogue keeps the order ``acc * (a_scale * w_scale)``. Decode is bound
by the int8 weight bytes, prefill by the int8 tensor-core rate; a split-K
grid keeps every SM streaming weights when M x N has few tiles.

This module also holds the two launchers that ``dynquant`` shares.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (qmatmul_static_ref, quantize_rows_ref,
                                     quantize_static_ref)

_KSTEP = 64                  # K padding of the code scratch (kernel's BK)
_TILE_M, _TILE_N = 64, 128   # output tile of one block
_SMS = 132                   # H100 SXM streaming multiprocessors
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB = "qmatmul"


def _check_operands(x, w_int8, w_scale):
    if x.dim() != 2 or w_int8.dim() != 2 or x.shape[1] != w_int8.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} @ w {tuple(w_int8.shape)}: "
                         "need x [M,K] and w_int8 [K,N]")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x dtype {x.dtype}: float32 or bfloat16 only")
    if w_int8.dtype != torch.int8:
        raise TypeError(f"w_int8 dtype {w_int8.dtype}, want int8")
    n = w_int8.shape[1]
    if w_scale.dtype != torch.float32 or w_scale.numel() != n:
        raise ValueError(f"w_scale must be f32 with {n} elements")
    for name, t in (("x", x), ("w_int8", w_int8), ("w_scale", w_scale)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _quantize_cuda(x, act_scale=None):
    """Launch the row-quantize kernel: (codes [M, Kp], a_scale [M, 1] or
    None). Static mode passes ``act_scale`` as a 1-element f32 tensor."""
    m, k = x.shape
    kp = -(-k // _KSTEP) * _KSTEP
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


def _splits(m: int, n: int, kp: int) -> int:
    """Split K only when the output has fewer tiles than SMs (decode)."""
    tiles = -(-m // _TILE_M) * -(-n // _TILE_N)
    if tiles >= _SMS:
        return 1
    return max(1, min(kp // _KSTEP, -(-2 * _SMS // tiles)))


def _gemm_cuda(codes, w_int8, w_scale, a_scale, k: int, per_row: bool):
    """Launch the int8 GEMM on codes [M, Kp]; ``a_scale`` is [M, 1] with
    ``per_row`` (dynamic epilogue) or a 1-element tensor (static)."""
    m, kp = codes.shape
    n = w_int8.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=codes.device)
    splits = _splits(m, n, kp)
    ws = (torch.zeros((m, n), dtype=torch.int32, device=codes.device)
          if splits > 1 else None)
    fn = _build.function(_LIB, "qmm_gemm", [_build.P, _build.P, _build.P,
                         _build.P, _build.I, _build.P, _build.P, _build.I,
                         _build.I, _build.I, _build.I, _build.I, _build.P])
    rc = fn(codes.data_ptr(), w_int8.data_ptr(), w_scale.data_ptr(),
            a_scale.data_ptr(), int(per_row),
            out.data_ptr(), None if ws is None else ws.data_ptr(),
            m, n, k, kp, splits, _build.stream_of(codes))
    _build.check(_LIB, rc, "qmm_gemm")
    return out


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
    a = None if act_scale is None else _act_scale_tensor(act_scale, x.device)
    codes, a_scale = _quantize_cuda(x.contiguous(), a)
    return codes[:, :x.shape[1]], a_scale


def qmatmul_static(x, w_int8, w_scale, act_scale):
    """x [M,K] f32/bf16; w_int8 [K,N] int8; w_scale [1,N] f32; act_scale
    scalar -> [M,N] f32. CPU tensors take the plain version; CUDA tensors
    launch the kernel."""
    _check_operands(x, w_int8, w_scale)
    if x.device.type == "cpu":
        return qmatmul_static_ref(x, w_int8, w_scale, act_scale)
    if x.device.type != "cuda":
        raise ValueError(f"no qmatmul_static kernel for {x.device}")
    a = _act_scale_tensor(act_scale, x.device)
    codes, _ = _quantize_cuda(x, a)
    out = _gemm_cuda(codes, w_int8, w_scale, a, x.shape[1], per_row=False)
    qmatmul_static.launches += 1
    return out


qmatmul_static.launches = 0
