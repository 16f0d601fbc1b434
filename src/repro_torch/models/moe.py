"""Mixture-of-Experts FFN with sort-based capacity dispatch: the port of
``repro.models.moe`` (its ``_moe_ffn_gspmd`` path).

Routing takes f32 router logits, a softmax, the top-k experts of each token
(ties to the lower expert id, as ``jax.lax.top_k`` breaks them) and gates
renormalized over those k. Dispatch sorts the token -> expert assignments
by expert (a stable sort) and writes each kept one into an ``[E * C + 1,
d]`` buffer, C the capacity; assignments past an expert's capacity go to the
overflow row and are dropped. The experts run as one batched SwiGLU over
``[E, C, d]`` (plain ``torch.bmm``, as the JAX package computes them
outside any Pallas kernel); quantized expert leaves are dequantized in
chunks of experts, so no f32 copy of a whole ``[E, d, 2ff]`` leaf is made.
The combine adds each token's k gated outputs in ascending expert order,
one add at a time in the activation dtype (the order in which the JAX
scatter-add rounds), never by atomics; the shared experts follow through
``linear``.

The JAX package's ``shard_map`` dispatch (``moe_ffn_sharded``) needs a
training mesh (what is left of ROADMAP Queue 1 item 10: tensor-parallel
serving refuses MoE layers); without one it falls back to this path, and
so does the port.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.quant.quantize import dequantize_tensor
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, is_quantized, linear

#: f32 bytes of one chunk of expert weights drawn or dequantized at a time
DEQUANT_CHUNK_BYTES = 1 << 30


def _expert_init(gen: torch.Generator, shape, dtype) -> torch.Tensor:
    """``dense_init`` of an ``[E, K, N]`` expert leaf (fan-in K), drawn a
    chunk of experts at a time into the leaf, so no f32 copy of the whole
    leaf is made (kimi-k2's ``wi`` is 45 GB in f32)."""
    w = torch.empty(shape, dtype=dtype, device=gen.device)
    step = max(1, DEQUANT_CHUNK_BYTES // (shape[1] * shape[2] * 4))
    for e0 in range(0, shape[0], step):
        e1 = min(e0 + step, shape[0])
        w[e0:e1] = dense_init(gen, (e1 - e0,) + tuple(shape[1:]), in_axis=1,
                              dtype=dtype)
    return w


def init_moe_params(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff_expert or cfg.d_ff
    dt = cfg.activation_dtype
    p = {
        "router": dense_init(gen, (d, cfg.n_experts), dtype=torch.float32),
        "wi": _expert_init(gen, (cfg.n_experts, d, 2 * ff), dt),
        "wo": _expert_init(gen, (cfg.n_experts, ff, d), dt),
    }
    if cfg.n_shared_experts:
        sff = cfg.n_shared_experts * ff
        p["shared_wi"] = dense_init(gen, (d, 2 * sff), dtype=dt)
        p["shared_wo"] = dense_init(gen, (sff, d), dtype=dt)
    return p


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots per expert: ``n_tokens * top_k * capacity_factor / E``,
    rounded up to a multiple of 8, at least 8."""
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts)
    return max(8, -(-c // 8) * 8)


def route(p, xt: torch.Tensor, cfg: ModelConfig):
    """xt [T, d] -> (logits [T, E] f32, probs [T, E], gate [T, k], idx
    [T, k]): the top-k of each row by a stable descending sort, so equal
    probabilities keep the lower expert id first."""
    logits = linear(p["router"], xt.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    srt = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate = srt.values[:, :cfg.top_k]
    idx = srt.indices[:, :cfg.top_k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gate, idx


def dispatch_plan(idx: torch.Tensor, cfg: ModelConfig):
    """The capacity cut of the assignments ``idx`` [T, k]: (order, the
    stable sort of the flattened assignments by expert; keep [T*k] in that
    order, whether each fits its expert's capacity; slot, its row of the
    ``[E * C + 1, d]`` buffer, the overflow row E * C when dropped;
    cap)."""
    t, k = idx.shape
    e = cfg.n_experts
    dev = idx.device
    cap = capacity(t, cfg)
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = torch.bincount(se, minlength=e)
    offsets = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(t * k, device=dev) - offsets[se]
    keep = pos_in_e < cap
    slot = torch.where(keep, se * cap + pos_in_e,
                       torch.full_like(se, e * cap))      # overflow row
    return order, keep, slot, cap


def _expert_slice(leaf, e0: int, e1: int):
    """Experts ``e0:e1`` of an ``[E, ...]`` leaf, quantized dicts field by
    field."""
    if isinstance(leaf, dict):
        return {k: (v[e0:e1] if v.dim() else v) for k, v in leaf.items()}
    return leaf[e0:e1]


def _expert_bmm(a: torch.Tensor, leaf) -> torch.Tensor:
    """a [E, C, K] @ the expert leaf [E, K, N] -> [E, C, N] in a's dtype.
    A quantized leaf is dequantized a chunk of experts at a time (at most
    ``DEQUANT_CHUNK_BYTES`` of f32 values): the values are those of the
    whole leaf's dequantization, which is elementwise. A calibration
    observer's leaf is read as its weight (no ``linear`` reads an expert,
    so there is no activation scale to record)."""
    if isinstance(leaf, dict) and "obs_id" in leaf:
        leaf = leaf["w"]
    if not is_quantized(leaf):
        return torch.bmm(a, leaf.to(a.dtype))
    e = a.shape[0]
    per = leaf.get("w_int8", leaf.get("w_int4"))[0].numel() * 4
    step = max(1, min(e, DEQUANT_CHUNK_BYTES // per))
    if step >= e:
        return torch.bmm(a, dequantize_tensor(leaf, a.dtype))
    return torch.cat([torch.bmm(a[e0:e0 + step], dequantize_tensor(
        _expert_slice(leaf, e0, e0 + step), a.dtype))
        for e0 in range(0, e, step)])


def moe_ffn(p, x: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B, S, d] -> (out [B, S, d], aux {lb_loss, z_loss,
    fraction_dropped}). Every row of x routes, padding and idle engine
    slots included: they compete for capacity as in the JAX package."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    dev = x.device
    xt = x.reshape(t, d)

    logits, probs, gate, idx = route(p, xt, cfg)

    # ---- aux losses ----
    me = probs.mean(0)
    ce = torch.bincount(idx.reshape(-1), minlength=e).to(torch.float32) \
        / (t * k)
    lb_loss = e * torch.sum(me * ce)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))

    # ---- sort-based dispatch ----
    order, keep, slot, cap = dispatch_plan(idx, cfg)
    st = torch.div(order, k, rounding_mode="floor")       # token of each

    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=dev)
    buf[slot] = xt[st]
    ein = buf[:e * cap].reshape(e, cap, d)

    # ---- experts, batched over E ----
    gu = _expert_bmm(ein, p["wi"])
    g, u = torch.chunk(gu, 2, dim=-1)
    eout = _expert_bmm(F.silu(g) * u, p["wo"])

    # ---- combine: each token's k outputs added in expert order ----
    flat_out = eout.reshape(e * cap, d)
    gathered = torch.where(keep[:, None],
                           flat_out[slot.clamp(max=e * cap - 1)],
                           torch.zeros((), dtype=x.dtype, device=dev))
    # back to (token, choice) order, then each token's choices sorted by
    # expert id: the order the sorted scatter-add visits them
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=dev)
    contrib = (gathered[inv] * gate.reshape(-1, 1).to(x.dtype)).reshape(
        t, k, d)
    by_expert = torch.argsort(idx, dim=-1)
    contrib = torch.gather(contrib, 1, by_expert[:, :, None].expand(t, k, d))
    out = torch.zeros((t, d), dtype=x.dtype, device=dev)
    for j in range(k):
        out = out + contrib[:, j]

    if cfg.n_shared_experts:
        gu = linear(p["shared_wi"], xt)
        g, u = torch.chunk(gu, 2, dim=-1)
        out = out + linear(p["shared_wo"], F.silu(g) * u)

    aux = {"lb_loss": lb_loss, "z_loss": z_loss,
           "fraction_dropped": 1.0 - keep.to(torch.float32).mean()}
    return out.reshape(b, s, d), aux
