"""Post-training quantization as a tree transform: the port of
``repro.core.quant.quantize`` (symmetric int8, per-channel and per-tensor).

``quantize_tree`` maps every quantizable matmul weight in a param tree to

    dynamic_int8: {"w_int8": int8[K,N], "scale": f32[1,N] or f32[1,1]}
    static_int8:  {... , "act_scale": f32[]}   (from a CalibrationSession)

Leaf paths are the JAX tree's with a layer index (``layers/3/attn/wq``),
so ``QuantConfig.include``/``exclude`` select the same leaves. ``min_size``
is checked per layer (the JAX package checks the ``[L, ...]`` stack).
Codes and scales are bit-identical to the JAX package's: per-element
``round(x * (127 / absmax))`` with the division done as a tensor division.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional

import torch

from repro_torch.tree import map_with_path


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


def quantize_tensor(x: torch.Tensor, *, per_channel: bool = True,
                    symmetric: bool = True, bits: int = 8,
                    group_size: int = 0,
                    clip_percentile: float = 0.0) -> Dict[str, torch.Tensor]:
    """Symmetric int8: ``scale = absmax / 127``, per output channel
    (reducing the contraction axis -2) or per tensor."""
    if bits != 8 or group_size or clip_percentile or not symmetric:
        raise NotImplementedError(
            "int4, per-group, percentile-clipped and asymmetric quantization "
            "are ROADMAP Queue 1 item 4")
    xf = x.to(torch.float32)
    if xf.dim() >= 2:
        dims = (xf.dim() - 2,) if per_channel else (xf.dim() - 2, xf.dim() - 1)
        absmax = xf.abs().amax(dim=dims, keepdim=True)
    else:
        absmax = xf.abs().amax().reshape((1,) * max(xf.dim(), 1))
    absmax = torch.clamp(absmax, min=1e-12)
    qmax = _const(127.0, xf)
    q = torch.clamp(torch.round(xf * (qmax / absmax)), -127, 127)
    return {"w_int8": q.to(torch.int8), "scale": absmax / qmax}


def dequantize_tensor(q: Dict[str, torch.Tensor], dtype=torch.float32):
    if "w_int8" not in q or "zero" in q \
            or q["scale"].dim() == q["w_int8"].dim() + 1:
        raise NotImplementedError(
            "int4 / grouped / asymmetric leaves are ROADMAP Queue 1 item 4")
    return (q["w_int8"].to(torch.float32) * q["scale"]).to(dtype)


def quantizable(path: str, leaf, qc: QuantConfig) -> bool:
    if not isinstance(leaf, torch.Tensor) or leaf.numel() < qc.min_size \
            or leaf.dim() < 2:
        return False
    if not leaf.is_floating_point():
        return False
    if re.search(qc.exclude, path):
        return False
    return re.search(qc.include, path) is not None


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
        q = quantize_tensor(
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
    """Artifact size in bytes (every tensor, quantized dicts included)."""
    total = 0

    def visit(_, leaf):
        nonlocal total
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        return leaf

    map_with_path(visit, params)
    return total
