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

from repro_torch.models.sharding import (gather_dim, is_dtensor,
                                         reduce_partials, tp_state)

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
    if is_dtensor(p):
        # a product reads its input reduced (a row-parallel output left
        # partial over "model" where JAX sets no constraint)
        return _MeshMatmul.apply(reduce_partials(x), p.to(x.dtype))
    return torch.matmul(x, p.to(x.dtype))


def _gathered(x, w):
    """``w`` gathered over each mesh dim that shards the rows of ``x``
    (FSDP's gather of a weight whose dims "data" shards, as the batch)."""
    if not is_dtensor(x):
        return w
    from torch.distributed.tensor import Replicate

    lead = x.dim() - 1
    pl = [Replicate() if xp.is_shard() and xp.dim < lead else wp
          for xp, wp in zip(x.placements, w.placements)]
    if pl == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, pl)


class _MeshMatmul(torch.autograd.Function):
    """``x @ w`` of a DTensor weight, partitioned as GSPMD partitions it.
    Where a mesh dim shards both the rows of x (the batch) and a dim of w
    (FSDP), w is gathered over it first, in the forward and again in the
    backward. The backward computes each rank's own block of w's grad:
    DTensor alone would take the product of the replicated activations and
    grads (its cheapest input layout) and keep w's shard of it, every rank
    computing the whole weight grad. Per mesh dim: rows sharded there stay
    sharded and the grad sums over them; else the rows of x (w's input dim
    sharded) or the columns of the grad (w's output dim sharded) are
    sliced to w's shard; the grad then takes w's placements (an
    all-reduce or reduce-scatter where it was a sum)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.matmul(x, _gathered(x, w))

    @staticmethod
    def backward(ctx, grad):
        from torch.distributed.tensor import Replicate, Shard

        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.matmul(grad, _gathered(x, w).transpose(0, 1))
        if ctx.needs_input_grad[1]:
            k, n = w.shape
            x2, g2 = x.reshape(-1, k), grad.reshape(-1, n)
            x_pl, g_pl = [], []
            for xp, gp, wp in zip(x2.placements, g2.placements, w.placements):
                if Shard(0) in (xp, gp):            # rows: a sum over them
                    x_pl.append(Shard(0))
                    g_pl.append(Shard(0))
                elif wp == Shard(0):
                    x_pl.append(Shard(1))
                    g_pl.append(Replicate())
                elif wp == Shard(1):
                    x_pl.append(Replicate())
                    g_pl.append(Shard(1))
                else:
                    x_pl.append(Replicate())
                    g_pl.append(Replicate())
            gw = torch.matmul(
                x2.redistribute(x2.device_mesh, x_pl).transpose(0, 1),
                g2.redistribute(g2.device_mesh, g_pl))
            gw = gw.redistribute(w.device_mesh, w.placements)
        return gx, gw


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
    # on a mesh the fused gate|up columns are gathered first: a shard of
    # them holds gate or up columns only (DTensor would otherwise choose
    # its own reshard for the split, which can move the rows instead)
    g, u = torch.chunk(gather_dim(linear(wi, x), -1), 2, dim=-1)
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
