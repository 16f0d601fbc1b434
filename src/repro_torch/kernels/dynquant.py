"""Dynamic w8a8 int8 GEMM: port of ``repro/kernels/dynquant.py::qmatmul_dynamic``.

Source note. The TPU kernel stages a [bm, K] row block in VMEM and fuses
the per-row absmax, ``round(x * (127 / absmax))`` codes and the int8 dot,
then multiplies by ``a_scale`` and ``w_scale``. On the H100
(``csrc/qmatmul.cu``) Blocks run in no order and cannot share a row's
absmax, so one pass per row (``quantize_rows``, dynamic mode) reduces the
absmax over the full K and writes codes and the row scale to scratch the
wrapper allocates; the same ``mma.sync`` s8 GEMM as the static path follows,
with the epilogue ``(acc * a_scale[m]) * w_scale[n]``. Bound: int8 weight
bytes at decode (the whole dynamic-int8 stablelm-1.6b decode step reads
about 1.44 GB of them, ~0.43 ms at 3.35 TB/s), the int8 tensor-core rate at
prefill. The activation pass moves M*K input bytes and M*K code bytes,
small next to the K*N weights.
"""
from __future__ import annotations

from repro_torch.kernels.qmatmul import (_check_operands, _gemm_cuda,
                                         _quantize_cuda)
from repro_torch.kernels.ref import qmatmul_dynamic_ref


def qmatmul_dynamic(x, w_int8, w_scale):
    """x [M,K] f32/bf16; w_int8 [K,N] int8; w_scale [1,N] f32 -> [M,N] f32.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    _check_operands(x, w_int8, w_scale)
    if x.device.type == "cpu":
        return qmatmul_dynamic_ref(x, w_int8, w_scale)
    if x.device.type != "cuda":
        raise ValueError(f"no qmatmul_dynamic kernel for {x.device}")
    codes, a_scale = _quantize_cuda(x)
    out = _gemm_cuda(codes, w_int8, w_scale, a_scale, x.shape[1], per_row=True)
    qmatmul_dynamic.launches += 1
    return out


qmatmul_dynamic.launches = 0
