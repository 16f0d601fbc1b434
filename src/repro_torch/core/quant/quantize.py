"""Post-training quantization as a tree transform: the port of
``repro.core.quant.quantize``: symmetric int8 or int4 (per channel, per
tensor or per group, optionally percentile-clipped) and asymmetric int8.

``quantize_tree`` maps every quantizable matmul weight in a param tree to

    dynamic_int8: {"w_int8": int8[K,N], "scale": f32[1,N] or f32[1,1]}
    static_int8:  {... , "act_scale": f32[]}   (from a CalibrationSession)
    int4:         {"w_int4": int8[K,N] codes in [-7, 7], "scale": ...}
    per group:    "scale" f32[K/g, 1, N]; asymmetric: "zero" f32 beside it

Leaf paths are the JAX tree's with a layer index (``layers/3/attn/wq``),
so ``QuantConfig.include``/``exclude`` select the same leaves. ``min_size``
is checked per layer (the JAX package checks the ``[L, ...]`` stack).
Codes and scales are bit-identical to the JAX package's eager
``quantize_tree``: per-element ``round(x * (qmax / absmax))`` with every
constant a device tensor (a CUDA division by a host scalar multiplies by
its reciprocal), and ``percentile`` reproducing ``jnp.percentile``.
"""
from __future__ import annotations

import dataclasses
import functools
import re
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.tree import leaves_with_path, map_with_path


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    mode: str = "dynamic_int8"          # none | dynamic_int8 | static_int8
    granularity: str = "per_channel"    # per_channel | per_tensor | per_group
    group_size: int = 128
    bits: int = 8
    clip_percentile: float = 0.0
    symmetric: bool = True
    include: str = (
        r"(wq|wk|wv|wo|wi|w_in|w_out|w_x|w_gate|w_uq|w_ukv|w_dq|w_dkv|"
        r"shared_wi|shared_wo|unembed|frontend_proj|embed|extra_embeds|"
        r"out_heads)$"
    )
    exclude: str = r"(rec/(wa|wi)|lam|conv_w|router|A_log|dt_bias)"
    min_size: int = 4096


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _reduce_dims(ndim: int, per_channel: bool) -> Tuple[int, ...]:
    """The contraction axis (-2) per channel, the two matmul axes per
    tensor; leading stacked-layer / expert dims are kept."""
    return (ndim - 2,) if per_channel else (ndim - 2, ndim - 1)


def _grouped(xf: torch.Tensor, group_size: int) -> Optional[torch.Tensor]:
    """Split the contraction axis (-2) into groups: [..., K, N] ->
    [..., K/g, g, N] with ``g = min(group_size, K)``; None when K is not a
    multiple of g (the caller falls back to per channel)."""
    k = xf.shape[-2]
    g = min(group_size, k)
    if k % g:
        return None
    return xf.reshape(*xf.shape[:-2], k // g, g, xf.shape[-1])


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as a fused multiply-add gives it:
    the product is exact in f64, the f64 sum's own rounding error is
    recovered exactly (TwoSum) and decides the one case where rounding the
    f64 sum to f32 would round twice (an f64 sum on an f32 midpoint)."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    r = s.float()
    d = s - r.double()
    inf = torch.full_like(r, float("inf"))
    nxt = torch.nextafter(r, torch.where(d > 0, inf, -inf))
    mid = (d != 0) & (d == (nxt.double() - r.double()) / 2)
    return torch.where(mid & (err * d > 0), nxt, r)


def percentile(a: torch.Tensor, pct: float, dims: Sequence[int]):
    """``jnp.percentile(a, pct, axis=dims, keepdims=True)`` bit for bit, for
    f32 ``a`` of any size (``torch.quantile`` refuses more than 2^24
    elements): sort along the reduced dims, gather the two order statistics
    around ``q * (n - 1)`` and interpolate linearly. The f32 arithmetic is
    the one XLA compiles ``_quantile`` to: ``pct / 100 * (n - 1)`` folds to
    ``pct * (f32(1 / 100) * (n - 1))``, and the interpolation's add is fused
    with one product: the low term's where the result has several elements,
    the high term's where it has one (the scalar loop XLA emits for a
    per-tensor percentile)."""
    nd = a.dim()
    dims = sorted(d % nd for d in dims)
    keep = [d for d in range(nd) if d not in dims]
    flat = a.permute(keep + dims).reshape(*(a.shape[d] for d in keep), -1)
    n = flat.shape[-1]
    f32 = functools.partial(torch.full, (), dtype=torch.float32)
    n1 = f32(float(n)) - f32(1.0)
    qn = f32(pct) * (f32(1.0) / f32(100.0) * n1)
    low, high = torch.floor(qn), torch.ceil(qn)
    hw = qn - low
    lw = f32(1.0) - hw
    lo_i = int(torch.clamp(low, min=f32(0.0), max=n1))
    hi_i = int(torch.clamp(high, min=f32(0.0), max=n1))
    ordered = torch.sort(flat, dim=-1).values
    lv, hv = ordered[..., lo_i], ordered[..., hi_i]
    del ordered
    lw, hw = (torch.full_like(lv, float(w)) for w in (lw, hw))
    out = (_fma(lv, lw, hv * hw) if lv.numel() > 1
           else _fma(hv, hw, lv * lw))
    return out.reshape([1 if d in dims else a.shape[d] for d in range(nd)])


def quantize_tensor(x: torch.Tensor, *, per_channel: bool = True,
                    symmetric: bool = True, bits: int = 8,
                    group_size: int = 0,
                    clip_percentile: float = 0.0) -> Dict[str, torch.Tensor]:
    """Symmetric: ``scale = absmax / qmax``. Asymmetric: affine with a zero
    point (``zero``), always int8.

    ``bits=4`` keeps int4 codes in an int8 carrier under ``w_int4`` (qmax
    7); ``group_size > 0`` gives one scale per ``group_size`` contraction
    elements per channel, kept as ``[..., K/g, 1, N]`` (falls back to per
    channel when K is not a multiple of the group); ``clip_percentile``
    replaces absmax by that percentile of |x| (outlier clipping)."""
    qmax = 7.0 if bits == 4 else 127.0
    key = "w_int4" if bits == 4 else "w_int8"
    xf = x.to(torch.float32)
    if group_size and xf.dim() >= 2:
        xg = _grouped(xf, group_size)
        if xg is not None:
            absmax = torch.clamp(xg.abs().amax(dim=-2, keepdim=True),
                                 min=1e-12)
            if clip_percentile:
                pct = percentile(xg.abs(), clip_percentile, (-2,))
                absmax = torch.clamp(torch.minimum(absmax, pct), min=1e-12)
            q = torch.clamp(torch.round(xg * (_const(qmax, xf) / absmax)),
                            -qmax, qmax)
            return {key: q.reshape(xf.shape).to(torch.int8),
                    "scale": absmax / _const(qmax, xf)}
    if symmetric:
        if xf.dim() >= 2:
            dims = _reduce_dims(xf.dim(), per_channel)
            absmax = xf.abs().amax(dim=dims, keepdim=True)
            if clip_percentile:
                absmax = torch.minimum(
                    absmax, percentile(xf.abs(), clip_percentile, dims))
        else:
            absmax = xf.abs().amax().reshape((1,) * max(xf.dim(), 1))
        absmax = torch.clamp(absmax, min=1e-12)
        q = torch.clamp(torch.round(xf * (_const(qmax, xf) / absmax)),
                        -qmax, qmax)
        return {key: q.to(torch.int8), "scale": absmax / _const(qmax, xf)}
    dims = (_reduce_dims(xf.dim(), per_channel) if xf.dim() >= 2
            else tuple(range(xf.dim())))
    hi = xf.amax(dim=dims, keepdim=True)
    lo = xf.amin(dim=dims, keepdim=True)
    scale = torch.clamp((hi - lo) / _const(255.0, xf), min=1e-12)
    zero = torch.round(_const(-128.0, xf) - lo / scale)
    q = torch.clamp(torch.round(xf / scale) + zero, -128, 127)
    return {"w_int8": q.to(torch.int8), "scale": scale, "zero": zero}


def quant_values(q: Dict[str, torch.Tensor]) -> torch.Tensor:
    return q["w_int4"] if "w_int4" in q else q["w_int8"]


def dequantize_tensor(q: Dict[str, torch.Tensor], dtype=torch.float32):
    """Codes times scales (minus the zero point first, when asymmetric).
    A grouped scale ``[..., K/g, 1, N]`` has one more dim than the codes;
    the group size follows from the shapes."""
    x = quant_values(q).to(torch.float32)
    if "zero" in q:
        x = x - q["zero"]
    scale = q["scale"]
    if scale.dim() == x.dim() + 1:
        g = x.shape[-2] // scale.shape[-3]
        return (_grouped(x, g) * scale).reshape(x.shape).to(dtype)
    return (x * scale).to(dtype)


def quantizable(path: str, leaf, qc: QuantConfig) -> bool:
    if not isinstance(leaf, torch.Tensor) or leaf.numel() < qc.min_size \
            or leaf.dim() < 2:
        return False
    if not leaf.is_floating_point():
        return False
    if re.search(qc.exclude, path):
        return False
    return re.search(qc.include, path) is not None


#: f32 bytes of one chunk of a stacked leaf quantized at a time
CHUNK_BYTES = 1 << 30


def _quantize_leaf(leaf: torch.Tensor, **kw) -> Dict[str, torch.Tensor]:
    """``quantize_tensor`` of a leaf; one with leading dims (an MoE
    layer's ``[E, K, N]`` experts) is quantized a chunk of its first dim at
    a time, which gives the same codes and scales (every granularity keeps
    the leading dims) without an f32 copy of the whole leaf. A percentile
    is taken over the whole leaf: its final add depends on the result's
    size."""
    per = leaf[0].numel() * 4 if leaf.dim() >= 3 else 0
    if not per or kw["clip_percentile"] or leaf.numel() * 4 <= CHUNK_BYTES:
        return quantize_tensor(leaf, **kw)
    step = max(1, CHUNK_BYTES // per)
    parts = [quantize_tensor(leaf[i:i + step], **kw)
             for i in range(0, leaf.shape[0], step)]
    return {key: torch.cat([q[key] for q in parts]) for key in parts[0]}


def quantize_tree(params, qc: QuantConfig,
                  act_scales: Optional[Dict[str, float]] = None):
    """Returns (quantized tree, list of quantized paths).

    static_int8 takes ``act_scales`` (path -> activation absmax) from a
    CalibrationSession; a path without one stays dynamic."""
    if qc.mode == "none":
        return params, []
    quantized = []

    def visit(p, leaf):
        if not quantizable(p, leaf, qc):
            return leaf
        q = _quantize_leaf(
            leaf, per_channel=qc.granularity != "per_tensor",
            symmetric=qc.symmetric, bits=qc.bits,
            group_size=qc.group_size if qc.granularity == "per_group" else 0,
            clip_percentile=qc.clip_percentile)
        if qc.mode == "static_int8" and act_scales and p in act_scales:
            s = torch.full((), act_scales[p], dtype=torch.float32,
                           device=leaf.device)
            q["act_scale"] = torch.clamp(s, min=1e-12) / _const(127.0, s)
        quantized.append(p)
        return q

    return map_with_path(visit, params), quantized


def tree_size_bytes(params) -> int:
    """Artifact size in bytes: every tensor, quantized dicts included, with
    int4 codes counted as packed nibbles (the on-wire format). Nibbles are
    counted per stacked path (``layers/3/attn/wq`` with every other layer's
    ``wq``; ``head_layers`` alike), as the JAX package counts its
    ``[L, ...]`` leaf, so an odd per-layer size gives the same total."""
    total = 0
    nibbles: Dict[str, int] = {}
    for path, leaf in leaves_with_path(params):
        if not isinstance(leaf, torch.Tensor):
            continue
        if path.rsplit("/", 1)[-1] == "w_int4":
            key = re.sub(r"^(head_layers|layers|groups|tail)/\d+/", r"\1/",
                         path)
            nibbles[key] = nibbles.get(key, 0) + leaf.numel()
        else:
            total += leaf.numel() * leaf.element_size()
    return total + sum((n + 1) // 2 for n in nibbles.values())


def quantized_size_bytes(params) -> int:
    return tree_size_bytes(params)
