"""The port of ``repro/kernels/quantize.py``: the per-channel int8 weight
quantizer ``quantize_weights`` (a hand-written kernel, ``csrc/
quantize_weights.cu``) and the int4 KV tier's wire layout and quantizer (the
port's copy of the pure-``jnp`` helpers).

Signed 4-bit codes in [-7, 7] are packed two per int8 byte along head_dim:
element ``d`` lives in byte ``d // 2``, the even index in the low nibble,
and nibbles are sign-extended on unpack. One f16 scale covers each group of
``kv_group_size(hd)`` head_dim elements of one (slot, head). The CUDA
kernels (``csrc/kv_int4.cuh``) unpack exactly this layout.

Plain PyTorch on every device, as it is ``jnp`` (not a Pallas kernel) in
the JAX package. The quantizer keeps the reference's operation order, so
its codes and scales are bit-identical:

1. ``t.float()``, then the absmax of each group;
2. ``scale = (max(absmax, 1e-8) / 7).to(float16)``, both constants as
   same-device tensors (IEEE division, no reciprocal rewrite);
3. the group divided by the *rounded* scale (back in f32), rounded half to
   even and clamped to +-7;
4. NaN to 0, then the cast to int8.

A group whose absmax is below ~2e-7 gets a scale that underflows to 0 in
f16: an all-zero group is then 0/0 = NaN, which step 4 makes code 0 (JAX's
NaN -> int8 cast gives 0 on the CPU; on CUDA the cast is undefined, hence
the explicit step), and any other such group is x/0 = +-inf, clamped to
+-7 with a stored scale of 0. Both dequantize to 0.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import _build

#: head_dim elements per int4 scale group (clamped to head_dim when smaller)
KV_GROUP = 32


def kv_group_size(head_dim: int) -> int:
    """Effective int4 group size: ``KV_GROUP`` clamped to head_dim."""
    return min(KV_GROUP, head_dim)


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """[..., D] int8 codes in [-8, 7] -> [..., D // 2] int8, two codes per
    byte: even index in the low nibble, odd in the high (D must be even)."""
    lo = codes[..., 0::2].to(torch.int32) & 0xF
    hi = codes[..., 1::2].to(torch.int32) & 0xF
    byte = lo | (hi << 4)                       # 0..255
    return torch.where(byte >= 128, byte - 256, byte).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[..., D // 2] int8 -> [..., D] int8 codes (sign-extended nibbles).
    Each nibble is shifted to the top of an int32 and shifted back
    arithmetically, which sign-extends it in two int32 ops."""
    p = packed.to(torch.int32)
    lo = (p << 28) >> 28
    hi = (p << 24) >> 28
    stacked = torch.stack([lo, hi], dim=-1)     # [..., D // 2, 2]
    return stacked.reshape(*packed.shape[:-1],
                           packed.shape[-1] * 2).to(torch.int8)


def quantize_kv_int4(t: torch.Tensor, group_size: int = 0):
    """[..., hd] float -> (packed [..., hd // 2] int8, scale [..., hd // g]
    f16), symmetric per-group absmax with qmax 7 and a 1e-8 floor;
    ``group_size`` defaults to ``kv_group_size(hd)``. Codes are computed
    against the rounded f16 scale, so dequantizing with the stored scale
    reconstructs them exactly."""
    hd = t.shape[-1]
    g = group_size or kv_group_size(hd)
    tg = t.to(torch.float32).reshape(*t.shape[:-1], hd // g, g)
    absmax = tg.abs().amax(dim=-1)
    scale = (torch.maximum(absmax, _const(1e-8, tg))
             / _const(7.0, tg)).to(torch.float16)
    q = torch.clamp(torch.round(tg / scale[..., None].to(torch.float32)),
                    -7, 7)
    q = torch.nan_to_num(q, nan=0.0)
    return pack_int4(q.reshape(t.shape).to(torch.int8)), scale


def dequantize_kv_int4(t_i4: torch.Tensor, t_s: torch.Tensor) -> torch.Tensor:
    """(packed [..., hd // 2] int8, scale [..., n_groups] f16) -> [..., hd]
    f32. The group size is derived from the shapes (hd / n_groups)."""
    hd = t_i4.shape[-1] * 2
    g = hd // t_s.shape[-1]
    x = unpack_int4(t_i4).to(torch.float32)
    xg = x.reshape(*x.shape[:-1], hd // g, g) \
        * t_s[..., None].to(torch.float32)
    return xg.reshape(x.shape)


# --------------------------------------------------------------------- #
# Per-channel int8 weight quantization (the Pallas ``quantize_weights``)
# --------------------------------------------------------------------- #
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB = "quantize_weights"

# Layout constants of ``csrc/quantize_weights.cu`` (the tests read them
# from the source and hold these to them)
W = 32                     # cluster strip: a 32-byte sector of codes a row
CLUSTER_MAX = 8            # the portable cluster size
BOX_MAX = 256              # TMA's largest box dimension (rows)
BOX_ALIGN = 8              # box rows are a multiple of this
SMEM_ALIGN = 128           # TMA destination alignment
SMEM_CAP = 227 * 1024      # a CTA's most shared memory
TWO_PASS_TC = 4            # two-pass: threads across a strip of 4 * vec
ROUTES = ("cluster", "two_pass")


class Plan(NamedTuple):
    route: str      # "cluster" or "two_pass"
    width: int      # columns of a strip: W (two-pass: 4 * vec)
    cluster: int    # c: CTAs of a cluster, splitting K (two-pass: 1)
    rows: int       # rows of a CTA's K-slice (two-pass: K)
    box: int        # rows of one TMA box (two-pass: 0)
    load: str       # cluster: "tma" or "plain"; two-pass: "vec" or "scalar"


def slice_rows(k: int, c: int) -> Tuple[int, int]:
    """(rows, box) of the K-slices when a cluster of ``c`` CTAs splits K:
    ``ceil(K / c)`` rows in the fewest boxes of at most BOX_MAX rows, each
    rounded up to BOX_ALIGN; rank r takes rows [r * rows, min(K, (r + 1) *
    rows)), so a late rank may get fewer rows or none."""
    share = -(-k // c)
    nbox = -(-share // BOX_MAX)
    box = -(-share // nbox)
    box = -(-box // BOX_ALIGN) * BOX_ALIGN
    return nbox * box, box


def cluster_smem(rows: int, box: int, elem: int) -> int:
    """A cluster CTA's dynamic shared memory (``cluster_smem`` in the
    source): alignment slack, the [rows, W] slice, one mbarrier a box, W
    partial maxima and W reciprocals."""
    return SMEM_ALIGN + rows * W * elem + 8 * (rows // box) + 8 * W


def plan(k: int, n: int, dtype: torch.dtype, aligned: bool = True) -> Plan:
    """The route and layout for w [K, N] of ``dtype`` whose base is 16-byte
    aligned (``aligned``).

    Cluster route: strips of W columns, each split along K over c =
    CLUSTER_MAX CTAs (fewer where K has fewer than CLUSTER_MAX boxes of
    BOX_ALIGN rows): the smallest K-slices, so the most CTAs in flight.
    TMA loads where it can describe w (the base and the row pitch in
    16-byte units), else plain loads. Where a K-slice outgrows SMEM_CAP (a
    strip taller than CLUSTER_MAX CTAs hold): the two-pass route."""
    elem = torch.finfo(dtype).bits // 8
    pitch = aligned and n * elem % 16 == 0
    c = min(CLUSTER_MAX, -(-k // BOX_ALIGN))
    rows, box = slice_rows(k, c)
    if cluster_smem(rows, box, elem) <= SMEM_CAP:
        return Plan("cluster", W, c, rows, box, "tma" if pitch else "plain")
    return Plan("two_pass", TWO_PASS_TC * (16 // elem if pitch else 1), 1, k,
                0, "vec" if pitch else "scalar")


def plan_for(w: torch.Tensor) -> Plan:
    """The plan ``quantize_weights`` launches for the CUDA tensor ``w``."""
    k, n = w.shape
    return plan(k, n, w.dtype, w.data_ptr() % 16 == 0)


def quantize_weights(w: torch.Tensor):
    """w [K, N] f32/bf16 -> (w_int8 [K, N] int8, scale [1, N] f32): per
    output column ``round(w * (127 / absmax))`` clipped to +-127 and
    ``absmax / 127``, absmax floored at 1e-12. CPU tensors take the plain
    ``ref.quantize_ref``; CUDA tensors launch the kernel on the route
    ``plan_for`` names (codes and scales bit-identical to the plain
    version; ``.routes`` counts launches per route). Artifacts are built
    with ``core.quant.quantize_tensor``, as in the JAX package: no model
    path calls this."""
    if w.dim() != 2:
        raise ValueError(f"w {tuple(w.shape)}: need [K, N]")
    if w.dtype not in _DTYPE_CODE:
        raise TypeError(f"w dtype {w.dtype}: float32 or bfloat16 only")
    if w.device.type == "cpu":
        from repro_torch.kernels.ref import quantize_ref

        return quantize_ref(w)
    if w.device.type != "cuda":
        raise ValueError(f"no quantize_weights kernel for {w.device}")
    _build.refuse_grad("quantize_weights", w)
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")
    k, n = w.shape
    codes = torch.empty((k, n), dtype=torch.int8, device=w.device)
    scale = torch.empty((1, n), dtype=torch.float32, device=w.device)
    p = plan_for(w)
    P, I = _build.P, _build.I
    if p.route == "cluster":
        fn = _build.function(_LIB, "qw_cluster",
                             [P, I, I, I, I, I, I, I, P, P, P])
        rc = fn(w.data_ptr(), _DTYPE_CODE[w.dtype], k, n, p.cluster, p.rows,
                p.box, int(p.load == "tma"), codes.data_ptr(),
                scale.data_ptr(), _build.stream_of(w))
    else:
        fn = _build.function(_LIB, "qw_two_pass", [P, I, I, I, I, P, P, P])
        rc = fn(w.data_ptr(), _DTYPE_CODE[w.dtype], k, n,
                p.width // TWO_PASS_TC, codes.data_ptr(), scale.data_ptr(),
                _build.stream_of(w))
    _build.check(_LIB, rc, f"qw_{p.route}")
    _build.count(quantize_weights, routes=p.route)
    return codes, scale


quantize_weights.launches = 0
quantize_weights.routes = {route: 0 for route in ROUTES}
