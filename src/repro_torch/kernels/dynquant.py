"""Dynamic w8a8 int8 GEMM: port of ``repro/kernels/dynquant.py::qmatmul_dynamic``.

Source note. The TPU kernel stages a [bm, K] row block in VMEM and fuses
the per-row absmax, ``round(x * (127 / absmax))`` codes and the int8 dot,
then multiplies by ``a_scale`` and ``w_scale``. On the H100
(``csrc/qmatmul.cu``, plan and packing in ``qmatmul``) blocks run in no
order and cannot share a row's absmax, so the two bodies differ in where
the codes come from:

- decode (M <= 16): every block quantizes the M rows itself into shared
  memory, as the TPU kernel does for its row block (the absmax is a max,
  exact in any order, so every block gets the same codes), then streams
  its columns of the packed weight: one launch per linear. Bound: the int8
  weight bytes (the dynamic-int8 stablelm-1.6b decode step reads about
  1.44 GB of them, ~0.43 ms at 3.35 TB/s).
- prefill: ``quantize_rows`` reduces each row's absmax over the full K and
  writes codes and row scales once (M*K bytes in, M*K out, small next to
  the GEMM), then the ``wgmma`` GEMM; its blocks would otherwise each read
  the whole [BM, K] stripe again. Bound: the int8 tensor-core rate.

The epilogue keeps ``(acc * a_scale[m]) * w_scale[n]``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.qmatmul import (BODIES, _check_operands,
                                         _check_packed, _qmm_cuda,
                                         pack_weight)
from repro_torch.kernels.ref import (qmatmul_dynamic_packed_ref,
                                     qmatmul_dynamic_ref)


def qmatmul_dynamic_packed(x, w_packed, w_scale, *, out_dtype=torch.float32):
    """x [M,K] f32/bf16; w_packed [N,Kp] int8 (``qmatmul.pack_weight``);
    w_scale [1,N] f32 -> [M,N] ``out_dtype`` (f32 or bf16). CPU tensors
    take the plain version; CUDA tensors launch the kernel and count on
    ``qmatmul_dynamic``."""
    _check_packed(x, w_packed, w_scale, out_dtype)
    if x.device.type == "cpu":
        return qmatmul_dynamic_packed_ref(x, w_packed, w_scale).to(out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no qmatmul_dynamic kernel for {x.device}")
    _build.refuse_grad("qmatmul_dynamic", x, w_scale)
    out, body = _qmm_cuda(x, w_packed, w_scale, None, out_dtype)
    _build.count(qmatmul_dynamic, launches_by_body=body)
    return out


def qmatmul_dynamic(x, w_int8, w_scale, *, out_dtype=torch.float32):
    """x [M,K] f32/bf16; w_int8 [K,N] int8; w_scale [1,N] f32 -> [M,N]
    ``out_dtype``. CPU tensors take the plain version; a CUDA weight is
    packed (``qmatmul.pack_weight``) and the kernel launched."""
    _check_operands(x, w_int8, w_scale, out_dtype)
    if x.device.type == "cpu":
        return qmatmul_dynamic_ref(x, w_int8, w_scale).to(out_dtype)
    return qmatmul_dynamic_packed(x, pack_weight(w_int8), w_scale,
                                  out_dtype=out_dtype)


qmatmul_dynamic.launches = 0
qmatmul_dynamic.launches_by_body = {body: 0 for body in BODIES}
