"""Primitive layers: the port of ``repro.models.layers`` (dense path).

``linear`` is quantization-aware: a weight leaf is a tensor, a quantized
dict from ``repro_torch.core.quant.quantize_tree``

    {"w_int8": int8[K, N], "scale": f32[1, N] or f32[1, 1]}          # dynamic
    {"w_int8", "scale", "act_scale": f32[]}                          # static
    {"w_int4" or "w_int8", "scale" f32[K/g, 1, N] or [1, N], "zero"?} # weight-only

or the same with ``w_packed`` (int8 [N, Kp], K-major) in place of
``w_int8``, as ``place_params`` leaves it on the card, or a calibration
observer ``{"w", "obs_id", "obs"}``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.sharding import tp_state

# leaves that no ``linear`` reads: the embedding is gathered row-wise in
# the JAX layout (``transformer._take_embed``)
_GATHERED = ("embed",)


def is_quantized(p) -> bool:
    return isinstance(p, dict) and ("w_int8" in p or "w_int4" in p
                                    or "w_packed" in p)


def _packable(leaf, path: str) -> bool:
    """A per-channel or per-tensor symmetric int8 leaf that ``linear``
    reads (a grouped leaf's rank-3 scale, an int4 or an asymmetric leaf
    stays weight-only)."""
    return (isinstance(leaf, dict) and "w_int8" in leaf and "zero" not in leaf
            and leaf["w_int8"].dim() == 2 and leaf["scale"].dim() == 2
            and path not in _GATHERED)


def place_params(params, device, pack=None):
    """``params`` with every tensor on ``device``; with ``pack`` (default:
    on a CUDA device) each int8 linear leaf's ``w_int8 [K, N]`` is replaced
    by its K-major packed copy ``w_packed [N, Kp]``, the operand layout of
    the card's GEMMs, so the card holds one copy of the weight. Idempotent;
    the embedding and non-int8 leaves keep their layout."""
    from repro_torch.kernels.qmatmul import pack_weight

    device = torch.device(device)
    if pack is None:
        pack = device.type == "cuda"

    def walk(tree, path):
        if isinstance(tree, dict):
            if pack and _packable(tree, path):
                leaf = {k: walk(v, f"{path}/{k}") for k, v in tree.items()
                        if k != "w_int8"}
                leaf["w_packed"] = pack_weight(tree["w_int8"].to(device))
                return leaf
            return {k: walk(v, f"{path}/{k}" if path else str(k))
                    for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, f"{path}/{i}" if path else str(i))
                    for i, v in enumerate(tree)]
        return tree.to(device) if isinstance(tree, torch.Tensor) else tree

    return walk(params, "")


def linear(p, x: torch.Tensor) -> torch.Tensor:
    """x: [..., K] @ weight [K, N] -> [..., N]; dispatches on quant state."""
    if isinstance(p, dict) and "obs_id" in p:
        p["obs"].observe(p["obs_id"], x)            # calibration pass
        return torch.matmul(x, p["w"].to(x.dtype))
    if is_quantized(p):
        codes = p.get("w_int8", p.get("w_int4"))
        if codes is not None and ("w_int4" in p or "zero" in p
                                  or p["scale"].dim() == codes.dim() + 1):
            # int4 / per-group / asymmetric: weight-only, dequantized and
            # multiplied in the activation dtype (plain PyTorch, as the JAX
            # package computes it outside any Pallas kernel); the w8a8
            # GEMMs serve the plain int8 leaves
            from repro_torch.core.quant.quantize import dequantize_tensor

            return torch.matmul(x, dequantize_tensor(p, x.dtype))
        from repro_torch.kernels import ops

        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        if "w_packed" in p:                         # place_params on the card
            y = ops.qmatmul_packed(x2, p["w_packed"], p["scale"],
                                   p.get("act_scale"), out_dtype=x.dtype)
            return y.reshape(*lead, -1)
        if "act_scale" in p:
            y = ops.qmatmul_static(x2, p["w_int8"], p["scale"], p["act_scale"],
                                   out_dtype=x.dtype)
        else:
            y = ops.qmatmul_dynamic(x2, p["w_int8"], p["scale"],
                                    out_dtype=x.dtype)
        return y.reshape(*lead, -1)
    return torch.matmul(x, p.to(x.dtype))


def rms_norm(w: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * (1.0 + w.to(torch.float32))).to(dt)


def row_combine(p, x: torch.Tensor) -> torch.Tensor:
    """Output-side (``wo``) linear, tensor-parallel aware.

    Outside a TP region this IS ``linear``. Inside a shard's body
    (``sharding.tp_region``) ``x`` holds this shard's head / ff slice and
    the combine mode picks the exchange over the shard group:

      exact  all-gather the slices along the feature axis (rank order ==
             natural chunk order) and apply the full replicated weight:
             the same contraction as tp=1.
      psum   row-parallel: the local rows of ``wo`` give a partial
             ``[., d]`` sum, and one all-reduce (summed in rank order)
             completes it.
    """
    st = tp_state()
    if st is None or st.tp <= 1:
        return linear(p, x)
    if st.combine == "exact":
        return linear(p, st.group.all_gather(x, st.rank, dim=x.dim() - 1))
    return st.group.all_reduce(linear(p, x), st.rank)


def swiglu(wi, wo, x: torch.Tensor) -> torch.Tensor:
    """Fused gate+up projection: wi [d, 2*ff], wo [ff, d].

    Under serving TP, ``wi`` is column-sharded with its gate|up columns
    permuted per shard first (``serving.sharded.permute_wi_for_tp``), so
    the local split below stays a gate / up split; ``wo`` combines across
    the shards through ``row_combine``."""
    gu = linear(wi, x)
    g, u = torch.chunk(gu, 2, dim=-1)
    return row_combine(wo, F.silu(g) * u)


# ----------------------------------------------------------------------- #
# RoPE (half-split, computed in f32, cast back)
# ----------------------------------------------------------------------- #
def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: [B, S, H, hd]; positions: [B, S] (or [S])."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------- #
# Initializers (torch.Generator draws; not the JAX package's numbers)
# ----------------------------------------------------------------------- #
def dense_init(gen: torch.Generator, shape, in_axis: int = 0,
               dtype=torch.bfloat16) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w / math.sqrt(shape[in_axis])).to(dtype)


def embed_init(gen: torch.Generator, shape, dtype=torch.bfloat16):
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (w * 0.02).to(dtype)
