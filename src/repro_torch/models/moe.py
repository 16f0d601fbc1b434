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

Under a mesh (``sharding.set_mesh``) ``moe_ffn`` takes one of two mesh
dispatches, as the JAX package's does under ``jax.set_mesh``:

- ``cfg.opt_moe_shardmap`` and a "model" mesh dim: ``moe_ffn_sharded``, the
  expert-parallel dispatch (JAX's ``shard_map`` body, here a ``local_map``).
  Each (batch shard, expert shard) routes its own tokens, keeps the
  assignments to its ``E / model`` experts (``_local_moe``, capacity from
  its local tokens) and gives a partial output that the "model" dim sums
  (a ``Partial`` placement); the aux losses are means over the batch
  shards and ``fraction_dropped`` a sum over the expert shards. The shared
  experts stay on the column-parallel ``linear`` outside it.
- Otherwise the GSPMD dispatch: the sort-based dispatch below on the whole
  batch. DTensor has no sharding rule for its counts (``bincount``) and
  its ``index_put`` (GSPMD partitions them with its own collectives), so the
  port gathers the tokens and the MoE leaves to every rank, runs the
  dispatch there (``local_map`` over replicated operands) and hands the
  output back batch-sharded by ``constrain``: the same capacity and drops as
  the unsharded call.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.quant.quantize import dequantize_tensor
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, is_quantized, linear
from repro_torch.models.sharding import (batch_axes, checked_spec, constrain,
                                         contiguous_grad, current_mesh,
                                         gather_dim, placements,
                                         to_placements)
from repro_torch.tree import get_path, leaves_with_path, map_with_path

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


def _counts(ids: torch.Tensor, n: int) -> torch.Tensor:
    """How often each of 0..n-1 occurs in ``ids`` (``bincount`` with a
    fixed length, which fake tensors can trace)."""
    return torch.zeros(n, dtype=torch.int64, device=ids.device).scatter_add_(
        0, ids, torch.ones_like(ids))


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
    counts = _counts(se, e)
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
    slots included: they compete for capacity as in the JAX package. Under
    a mesh, the expert-parallel dispatch (``cfg.opt_moe_shardmap`` and a
    "model" dim) or the replicated GSPMD dispatch."""
    mesh = current_mesh()
    if mesh is None:
        return _moe_ffn_local(p, x, cfg)
    if cfg.opt_moe_shardmap and "model" in mesh.mesh_dim_names:
        return moe_ffn_sharded(p, x, cfg, mesh)
    return _moe_ffn_gspmd(p, x, cfg, mesh)


def _moe_ffn_local(p, x: torch.Tensor, cfg: ModelConfig
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The sort-based dispatch on plain tensors (JAX's ``_moe_ffn_gspmd``
    body)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    dev = x.device
    xt = x.reshape(t, d)

    logits, probs, gate, idx = route(p, xt, cfg)

    # ---- aux losses ----
    me = probs.mean(0)
    ce = _counts(idx.reshape(-1), e).to(torch.float32) / (t * k)
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


# --------------------------------------------------------------------- #
# Mesh dispatches
# --------------------------------------------------------------------- #
def _moe_ffn_gspmd(p, x, cfg: ModelConfig, mesh):
    """The GSPMD dispatch on a mesh: tokens and MoE leaves gathered to
    every rank, the sort-based dispatch run there on the whole batch, the
    output constrained back to the batch axes."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    paths = [path for path, _ in leaves_with_path(p)]
    rep = [Replicate()] * mesh.ndim

    def body(xl, *leaves):
        by_path = dict(zip(paths, leaves))
        pl = map_with_path(lambda path, _: by_path[path], p)
        out, aux = _moe_ffn_local(pl, xl, cfg)
        return out, aux["lb_loss"], aux["z_loss"], aux["fraction_dropped"]

    fn = local_map(body, out_placements=(rep,) * 4,
                   in_placements=(rep,) * (1 + len(paths)),
                   device_mesh=mesh)
    out, lb, z, fd = fn(to_placements(x, mesh, rep),
                        *(to_placements(get_path(p, path), mesh, rep)
                          for path in paths))
    return (constrain(out, "batch", None, None),
            {"lb_loss": lb, "z_loss": z, "fraction_dropped": fd})


def _local_moe(xl, router, wi, wo, cfg: ModelConfig, e_loc: int,
               shard: int):
    """One (batch shard, expert shard)'s contribution: xl [Bl, S, d]
    (the whole "model" group holds the same rows), wi / wo this shard's
    ``e_loc`` experts. Returns the partial output (the sum over the local
    experts only) and the aux scalars of the local tokens;
    ``fraction_dropped`` counts this shard's dropped assignments over all
    of the local tokens' assignments."""
    bl, s, d = xl.shape
    t = bl * s
    e, k = cfg.n_experts, cfg.top_k
    dev = xl.device
    xt = xl.reshape(t, d)

    logits, probs, gate, idx = route({"router": router}, xt, cfg)
    me = probs.mean(0)
    ce = _counts(idx.reshape(-1), e).to(torch.float32) / (t * k)
    lb_loss = e * torch.sum(me * ce)
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))

    # keep only the assignments this expert shard owns
    cap = capacity(t, cfg)
    flat_e = idx.reshape(-1)
    lo = shard * e_loc
    owned = (flat_e >= lo) & (flat_e < lo + e_loc)
    loc_e = torch.where(owned, flat_e - lo, torch.full_like(flat_e, e_loc))
    order = torch.argsort(loc_e, stable=True)
    se = loc_e[order]
    counts = _counts(se, e_loc + 1)
    offsets = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(t * k, device=dev) - offsets[se]
    keep = (pos_in_e < cap) & (se < e_loc)
    slot = torch.where(keep, se * cap + pos_in_e,
                       torch.full_like(se, e_loc * cap))
    st = torch.div(order, k, rounding_mode="floor")

    buf = torch.zeros((e_loc * cap + 1, d), dtype=xl.dtype, device=dev)
    buf[slot] = xt[st]
    ein = buf[:e_loc * cap].reshape(e_loc, cap, d)
    gu = torch.bmm(ein, wi.to(xl.dtype))
    g, u = torch.chunk(gu, 2, dim=-1)
    eout = torch.bmm(F.silu(g) * u, wo.to(xl.dtype))

    # combine as the unsharded dispatch does: each token's kept outputs
    # added in ascending expert order
    flat_out = eout.reshape(e_loc * cap, d)
    gathered = torch.where(keep[:, None],
                           flat_out[slot.clamp(max=e_loc * cap - 1)],
                           torch.zeros((), dtype=xl.dtype, device=dev))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=dev)
    contrib = (gathered[inv] * gate.reshape(-1, 1).to(xl.dtype)).reshape(
        t, k, d)
    by_expert = torch.argsort(idx, dim=-1)
    contrib = torch.gather(contrib, 1, by_expert[:, :, None].expand(t, k, d))
    out = torch.zeros((t, d), dtype=xl.dtype, device=dev)
    for j in range(k):
        out = out + contrib[:, j]

    dropped = (owned & ~keep[inv]).to(torch.float32)
    aux = {"lb_loss": lb_loss, "z_loss": z_loss,
           "fraction_dropped": dropped.sum() / (t * k)}
    return out.reshape(bl, s, d), aux


def moe_ffn_sharded(p, x, cfg: ModelConfig, mesh):
    """The expert-parallel dispatch (JAX's ``moe_ffn_sharded``): x on the
    batch axes, the router replicated, ``wi`` / ``wo`` split over "model"
    by expert (gathered over "data" first under FSDP); each shard's
    ``_local_moe`` output summed over "model", the aux losses averaged over
    the batch shards, ``fraction_dropped`` summed over the expert shards.
    The shared experts follow on the column-parallel ``linear``."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    names = mesh.mesh_dim_names
    n_shards = mesh.size(names.index("model"))
    if cfg.n_experts % n_shards:
        raise ValueError(f"{cfg.n_experts} experts do not split over a "
                         f"model dim of {n_shards}")
    e_loc = cfg.n_experts // n_shards
    b_ax = batch_axes(mesh)
    x_pl = list(placements(checked_spec(tuple(x.shape), mesh, b_ax, None,
                                        None), mesh))
    n_batch = 1
    for i, pl in enumerate(x_pl):
        if isinstance(pl, Shard):
            n_batch *= mesh.size(i)
    rep = [Replicate()] * mesh.ndim
    experts = [Shard(0) if n == "model" else Replicate() for n in names]
    # the partial output sums over "model"; each aux scalar is a sum over
    # every rank of local / (n_batch * n_model), so the batch shards average
    # and each expert shard carries 1 / n_model of the routing grads, which
    # the router's Partial grad sums back; fraction_dropped sums over "model"
    out_pl = [Partial() if n == "model" else pl for n, pl in zip(names, x_pl)]
    aux_pl = [Partial() if isinstance(pl, Shard) or n == "model" else pl
              for n, pl in zip(names, x_pl)]
    batch_grad = [Partial() if isinstance(pl, Shard) else Replicate()
                  for pl in x_pl]
    x_grad = [Partial() if n == "model" else pl for n, pl in zip(names, x_pl)]
    router_grad = [Partial() if n == "model" else pl
                   for n, pl in zip(names, batch_grad)]
    expert_grad = [Shard(0) if n == "model" else pl
                   for n, pl in zip(names, batch_grad)]

    def body(xl, router, wi, wo):
        xl, router, wi, wo = (contiguous_grad(t) for t in (xl, router, wi, wo))
        shard = mesh.get_local_rank("model")
        out, aux = _local_moe(xl, router, wi, wo, cfg, e_loc, shard)
        per = n_batch * n_shards
        return (out, aux["lb_loss"] / per, aux["z_loss"] / per,
                aux["fraction_dropped"] / n_batch)

    fn = local_map(body, out_placements=(out_pl, aux_pl, aux_pl, aux_pl),
                   in_placements=(list(x_pl), rep, experts, experts),
                   in_grad_placements=(x_grad, router_grad, expert_grad,
                                       expert_grad),
                   device_mesh=mesh)

    out, lb, z, fd = fn(to_placements(x, mesh, x_pl),
                        to_placements(p["router"], mesh, rep),
                        to_placements(p["wi"], mesh, experts),
                        to_placements(p["wo"], mesh, experts))
    if cfg.n_shared_experts:
        b, s, d = x.shape
        xt = x.reshape(-1, d)
        g, u = torch.chunk(gather_dim(linear(p["shared_wi"], xt), -1), 2,
                           dim=-1)
        out = out + linear(p["shared_wo"], F.silu(g) * u).reshape(b, s, d)
    return out, {"lb_loss": lb, "z_loss": z, "fraction_dropped": fd}
