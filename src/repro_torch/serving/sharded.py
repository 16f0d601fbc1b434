"""Tensor-parallel serving: one model across tp shards, the port of
``repro.serving.sharded``.

The JAX package ``shard_map``s every serving entry point over a
``("data", "model")`` mesh. The port keeps its design (one process, one
engine whose host logic runs once) and runs each shard's body on its own
worker thread of a ``models.sharding.ShardGroup``. Inside the body the
*unmodified* model code runs on a local view:

  params   wq/wk/wv/w_uq/w_ukv/wi column-sliced (contiguous chunks == head
           groups), wo row-sliced ("psum") or replicated ("exact");
           everything else (embeddings, norms, MLA down-projections)
           replicated, and shared, not copied, where two shards sit on one
           device (``sharding.tp_param_spec``).
  cfg      heads / kv heads / d_ff divided by tp (``tp_local_config``), so
           the reshape-by-head code and the kernels (``flash_prefill`` and
           its int8 / int4 twins, ``qdecode``, the paged decodes) run each
           shard's own head slice, in every KV tier (int8 / int4 scale rows
           ride the same head axis and stay shard-local).
  caches   GQA payload and scale leaves split on the kv-head axis (dense
           caches and paged pools alike); MLA latent caches are head-free
           and each shard keeps a copy (``sharding.tp_cache_spec``). Block
           tables are host-side metadata, one for every shard.

The only cross-shard traffic is the wo-site combine
(``layers.row_combine``): "exact" all-gathers the head / ff slices and
applies the full weight (the tp=1 contraction), while "psum" keeps wo
row-parallel and all-reduces the ``[., d]`` partials in rank order. On a
host with tp cards shard s sits on ``cuda:s`` and a combine reads its
peers' tensors by a peer copy; on one card every shard shares it, and both
shards' kernels queue on its default stream.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as _m
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import (ShardGroup, shard_slice,
                                         tp_cache_spec, tp_param_spec)
from repro_torch.tree import map_with_path


# --------------------------------------------------------------------- #
# Support gate
# --------------------------------------------------------------------- #
def _has_quantized_leaves(tree) -> bool:
    if isinstance(tree, dict):
        if "w_int8" in tree or "w_int4" in tree or "w_packed" in tree:
            return True
        return any(_has_quantized_leaves(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_quantized_leaves(v) for v in tree)
    return False


def tp_unsupported_reason(cfg: ModelConfig, tp: int,
                          params=None) -> Optional[str]:
    """None when ``(cfg, tp)`` can serve tensor-parallel, else why not (the
    JAX package's gate and messages)."""
    if tp < 2:
        return None
    if cfg.attention not in ("full", "mla"):
        return f"attention={cfg.attention!r} (dense GQA/MLA stacks only)"
    if cfg.window:
        return "sliding-window attention"
    if getattr(cfg, "n_experts", 0):
        return "MoE layers (expert parallelism is moe_ffn_sharded's job)"
    if cfg.n_codebooks > 1:
        return "multi-codebook heads"
    if cfg.frontend != "none":
        return f"frontend={cfg.frontend!r}"
    if cfg.n_heads % tp:
        return f"n_heads={cfg.n_heads} not divisible by tp={tp}"
    if cfg.attention != "mla" and cfg.n_kv_heads % tp:
        return f"n_kv_heads={cfg.n_kv_heads} not divisible by tp={tp}"
    if cfg.d_ff % tp:
        return f"d_ff={cfg.d_ff} not divisible by tp={tp}"
    if params is not None and _has_quantized_leaves(params):
        return "quantized weight leaves (TP shards fp weights only; " \
               "quantized KV-cache tiers are fully supported)"
    return None


def tp_local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The per-shard view: heads and MLP width divided by tp. ``head_dim``
    is pinned so ``resolved_head_dim`` cannot drift when ``d_model /
    n_heads`` changes under it."""
    over: Dict[str, Any] = {"n_heads": cfg.n_heads // tp,
                            "head_dim": cfg.resolved_head_dim,
                            "d_ff": cfg.d_ff // tp}
    if cfg.attention != "mla":
        over["n_kv_heads"] = cfg.n_kv_heads // tp
    else:
        over["n_kv_heads"] = max(cfg.n_kv_heads // tp, 1)
    return cfg.with_overrides(**over)


# --------------------------------------------------------------------- #
# Host-side weight prep
# --------------------------------------------------------------------- #
def _wi_permutation(two_ff: int, tp: int) -> torch.Tensor:
    """Column order making each shard's fused gate|up slice locally
    splittable: shard s gets [gate_s | up_s] instead of a naive contiguous
    chunk (which would hand shard 0 all-gate and shard tp-1 all-up)."""
    ff = two_ff // 2
    c = ff // tp
    return torch.cat([torch.cat([torch.arange(s * c, (s + 1) * c),
                                 ff + torch.arange(s * c, (s + 1) * c)])
                      for s in range(tp)])


def _is_mlp_wi(path: str) -> bool:
    return path.split("/")[-2:] == ["mlp", "wi"]


def permute_wi_for_tp(params, tp: int, rank: Optional[int] = None):
    """Permute every MLP ``wi`` leaf's fused gate|up columns so that after
    column-slicing, the shard-local ``torch.chunk(gu, 2)`` in ``swiglu``
    stays a gate / up split AND the all-gathered hidden comes back in
    natural chunk order (so the unpermuted wo rows line up in both combine
    modes). With ``rank``, each ``wi`` keeps only that shard's chunk of
    the permuted columns, gathered in one ``index_select`` (the full
    permuted leaf is never built). Every other leaf is returned as it
    is."""

    def rule(path, leaf):
        if not _is_mlp_wi(path):
            return leaf
        idx = _wi_permutation(leaf.shape[-1], tp)
        if rank is not None:
            cols = idx.numel() // tp
            idx = idx[rank * cols:(rank + 1) * cols]
        return leaf.index_select(leaf.dim() - 1, idx.to(leaf.device))

    return map_with_path(rule, params)


def shard_devices(tp: int, device=None) -> List[torch.device]:
    """The shards' devices: ``device`` (default: the card) for shard 0 and,
    on the card, the next cards in turn, wrapping round the cards there are
    (``cuda:s % device_count()``); on the CPU every shard is the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * tp
    n = torch.cuda.device_count()
    first = dev.index if dev.index is not None else torch.cuda.current_device()
    return [torch.device("cuda", (first + s) % n) for s in range(tp)]


def _to(x, device):
    """Tensors (and the tensors of a batch dict) moved to ``device``; ints
    pass through."""
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    return x.to(device) if isinstance(x, torch.Tensor) else x


# --------------------------------------------------------------------- #
# TPContext: the engine-facing wrapper
# --------------------------------------------------------------------- #
class TPContext:
    """The serving entry points run on every shard, one group per engine.

    Each entry point keeps the calling convention the scheduler binds (cfg
    captured here) and takes the per-shard param trees (``shard_params``)
    and caches (``shard_cache``) as lists; it returns rank 0's logits
    (every rank's are the same: the combines give every rank the same
    bits) and every shard's cache, updated in place."""

    def __init__(self, cfg: ModelConfig, tp: int, combine: str = "exact",
                 params=None, devices: Optional[Sequence] = None):
        why = tp_unsupported_reason(cfg, tp, params)
        if why is not None:
            raise ValueError(f"tensor-parallel serving unsupported: {why}")
        devices = shard_devices(tp) if devices is None else list(devices)
        if len(devices) != tp:
            raise ValueError(f"{len(devices)} shard devices for tp={tp}")
        self.cfg = cfg
        self.tp = tp
        self.combine = combine
        self.local_cfg = tp_local_config(cfg, tp)
        self.group = ShardGroup(devices, combine)
        self.devices = self.group.devices

    # -------------------------- placement ------------------------------ #
    def shard_params(self, params) -> List[Any]:
        """One param tree per shard: column leaves sliced (each ``wi``
        through ``permute_wi_for_tp``'s chunk for the shard) and made
        contiguous, ``wo`` row-sliced in psum mode, everything else
        replicated."""
        tp = self.tp

        def shard(rank, dev):
            def rule(path, leaf):
                if _is_mlp_wi(path):        # already the shard's columns
                    return leaf.to(dev)
                dim = tp_param_spec(path, leaf.shape, tp, self.combine)
                return shard_slice(leaf, dim, rank, tp, dev)

            return map_with_path(rule, permute_wi_for_tp(params, tp, rank))

        return [shard(r, d) for r, d in enumerate(self.devices)]

    def shard_cache(self, caches) -> List[Any]:
        """One cache (or pool) tree per shard: GQA leaves split on the
        kv-head axis (each shard holds 1/tp of the pool), MLA leaves copied
        to every shard (each writes its own)."""
        def shard(rank, dev):
            def rule(path, leaf):
                dim = tp_cache_spec(self.cfg, leaf.shape, self.tp)
                if dim is None:
                    return leaf.to(dev, copy=True)
                return shard_slice(leaf, dim, rank, self.tp, dev)

            return map_with_path(rule, caches)

        return [shard(r, d) for r, d in enumerate(self.devices)]

    # -------------------------- entry points --------------------------- #
    def run_shards(self, fn: Callable, params: List[Any],
                   caches: Optional[List[Any]], *args) -> List[Any]:
        """``fn(params[r], caches[r], *args)`` (no cache argument when
        ``caches`` is None) on every shard r, the tensors of ``args`` moved
        to its device; the shards' results in rank order."""
        def body(r):
            dev = self.devices[r]
            a = [_to(x, dev) for x in args]
            if caches is None:
                return fn(params[r], *a)
            return fn(params[r], caches[r], *a)

        return self.group.run(body)

    def _replicated(self, outs):
        return outs[0][0], [o[1] for o in outs]

    def decode_step(self, params, caches, tokens, pos):
        lcfg = self.local_cfg
        return self._replicated(self.run_shards(
            lambda p, c, t, pz: _m.decode_step(p, c, t, pz, lcfg),
            params, caches, tokens, pos))

    def verify_step(self, params, caches, tokens, pos):
        lcfg = self.local_cfg
        return self._replicated(self.run_shards(
            lambda p, c, t, pz: _m.verify_step(p, c, t, pz, lcfg),
            params, caches, tokens, pos))

    def decode_step_paged(self, params, pools, tokens, pos, tables):
        lcfg = self.local_cfg
        return self._replicated(self.run_shards(
            lambda p, c, t, pz, tb: _m.decode_step_paged(p, c, t, pz, tb,
                                                         lcfg),
            params, pools, tokens, pos, tables))

    def verify_step_paged(self, params, pools, tokens, pos, tables):
        lcfg = self.local_cfg
        return self._replicated(self.run_shards(
            lambda p, c, t, pz, tb: _m.verify_step_paged(p, c, t, pz, tb,
                                                         lcfg),
            params, pools, tokens, pos, tables))

    def prefill(self, params, batch, n_valid, pad_to: int):
        lcfg = self.local_cfg
        return self._replicated(self.run_shards(
            lambda p, b, nv: _m.prefill(p, b, lcfg, pad_to=pad_to,
                                        n_valid=nv),
            params, None, batch, n_valid))

    def prefill_paged(self, params, pools, batch, n_valid, tables):
        lcfg = self.local_cfg
        return self._replicated(self.run_shards(
            lambda p, c, b, nv, tb: _m.prefill_paged(p, c, b, nv, tb, lcfg),
            params, pools, batch, n_valid, tables))

    def prefill_logits(self, params, batch):
        """Last-position prefill logits: a parity-test and debug helper."""
        s = int(batch["tokens"].shape[1])
        logits, _ = self.prefill(params, batch, s, pad_to=s + 1)
        return logits
