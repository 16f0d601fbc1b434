"""Dense int8-KV decode attention: port of
``repro/kernels/qdecode.py::qdecode_attention``.

Source note. The TPU kernel stages one (batch, kv head)'s whole ``[S, hd]``
int8 K/V panel in VMEM, folds the K scales into the scores after the dot
and the V scales into the probabilities, and takes a full-row softmax under
an additive bias. On the H100 (``csrc/qdecode.cu``, loop in
``csrc/decode_split.cuh``) one launch runs a cluster of up to 8 CTAs per
(sequence, kv head): each CTA takes an equal share of S in 32-slot tiles,
its warps walk their slots with an f32 online softmax, the next step's
codes and scales in flight and no block barrier, and the rank-0 CTA merges
the partials through distributed shared memory in rank order (no
workspace, no atomics: repeated calls give the same bits). It is bound by
the bytes of the codes and scales: at the dense engine's shape (B8 S512
Hkv32 hd64) ~17.9 MB, ~5.3 us at 3.35 TB/s.

The wide class (``wide_class``: G above ``MAX_GROUP`` or hd above
``MAX_HEAD_DIM``, up to ``WIDE_GROUP`` x ``WIDE_HEAD_DIM``) serves
recurrentgemma's 16 query heads x 256 over one kv head with its own body
on the tensor cores (``qdecode_wide_tc``): one CTA holds all G heads of its
(sequence, kv head, key share) as one m16 tile, so each code is read once;
its warps stream 16-slot tiles of codes and scales by cp.async, turn the
codes into bf16 (exact) and run S = Q K^T and O += P' V on ``mma.sync``
(f32 q and p' = p * v_s each split in two bf16 terms), with the same
online softmax and merges as the split loop. At its shape (B8 S2048 Hkv1)
it must read ~8.8 MB, ~2.6 us at 3.35 TB/s. ``launches_by_class`` counts
launches by class ("split", "wide").
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import qdecode_ref

MAX_GROUP = 8            # query heads per kv head
MAX_HEAD_DIM = 128
WIDE_GROUP = 16          # the wide class's bounds
WIDE_HEAD_DIM = 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB = "qdecode"


def _check(q, k_i8, k_s, v_i8, v_s, bias):
    if q.dim() != 4 or k_i8.dim() != 4:
        raise ValueError("q must be [B,Hkv,G,hd] and codes [B,S,Hkv,hd]")
    b, hkv, g, hd = q.shape
    s = k_i8.shape[1]
    if k_i8.shape != (b, s, hkv, hd) or v_i8.shape != k_i8.shape:
        raise ValueError(f"codes {tuple(k_i8.shape)} / {tuple(v_i8.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if k_s.shape != (b, s, hkv) or v_s.shape != k_s.shape \
            or bias.shape != (b, s):
        raise ValueError(f"scales {tuple(k_s.shape)} / {tuple(v_s.shape)} "
                         f"and bias {tuple(bias.shape)} must be [B,S,Hkv] "
                         f"and [B,S] with B={b}, S={s}, Hkv={hkv}")
    if q.dtype not in _DTYPE_CODE or k_i8.dtype != torch.int8 \
            or v_i8.dtype != torch.int8:
        raise TypeError(f"q {q.dtype} must be float32 or bfloat16 and the "
                        f"codes int8 ({k_i8.dtype} / {v_i8.dtype})")
    if any(t.dtype != torch.float32 for t in (k_s, v_s, bias)):
        raise TypeError("scales and bias must be float32")
    if not (1 <= g <= WIDE_GROUP and 16 <= hd <= WIDE_HEAD_DIM
            and hd % 16 == 0):
        raise ValueError(f"G={g}, hd={hd}: need G <= {WIDE_GROUP} and hd a "
                         f"multiple of 16 up to {WIDE_HEAD_DIM}")
    for name, t in (("k_i8", k_i8), ("k_s", k_s), ("v_i8", v_i8),
                    ("v_s", v_s), ("bias", bias)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    for name, t in (("q", q), ("k_i8", k_i8), ("k_s", k_s), ("v_i8", v_i8),
                    ("v_s", v_s), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def wide_class(g: int, hd: int) -> bool:
    """Whether (G, hd) takes the wide class (else the split classes)."""
    return g > MAX_GROUP or hd > MAX_HEAD_DIM


def qdecode(q, k_i8, k_s, v_i8, v_s, bias):
    """q [B,Hkv,G,hd]; k_i8/v_i8 [B,S,Hkv,hd] int8; k_s/v_s [B,S,Hkv] f32;
    bias [B,S] f32 -> [B,Hkv,G,hd] f32. CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    _check(q, k_i8, k_s, v_i8, v_s, bias)
    if q.device.type == "cpu":
        return qdecode_ref(q, k_i8, k_s, v_i8, v_s, bias)
    if q.device.type != "cuda":
        raise ValueError(f"no qdecode kernel for {q.device}")
    _build.refuse_grad("qdecode", q, k_s, v_s, bias)
    if k_i8.data_ptr() % 16 or v_i8.data_ptr() % 16:
        raise ValueError("codes must be 16-byte aligned (16-byte loads)")
    b, hkv, g, hd = q.shape
    if wide_class(g, hd) and q.data_ptr() % 16:
        raise ValueError("the wide class reads q in 8- or 16-byte pieces: "
                         "q must be 16-byte aligned")
    out = torch.empty((b, hkv, g, hd), dtype=torch.float32, device=q.device)
    fn = _build.function(_LIB, "qdecode_fwd", [
        _build.P, _build.I, _build.P, _build.P, _build.P, _build.P, _build.P,
        _build.P, _build.I, _build.I, _build.I, _build.I, _build.I, _build.P])
    rc = fn(q.data_ptr(), _DTYPE_CODE[q.dtype], k_i8.data_ptr(),
            k_s.data_ptr(), v_i8.data_ptr(), v_s.data_ptr(), bias.data_ptr(),
            out.data_ptr(), b, k_i8.shape[1], hkv, g, hd,
            _build.stream_of(q))
    _build.check(_LIB, rc, "qdecode_fwd")
    _build.count(qdecode, launches_by_class="wide" if wide_class(g, hd)
                 else "split")
    return out


qdecode.launches = 0
qdecode.launches_by_class = {"split": 0, "wide": 0}
