"""Decoder stacks: the port of ``repro.models.transformer`` for the dense
and MoE stacks (GQA or MLA attention), Mamba2's SSD stack and the RG-LRU
hybrid.

Param tree (per-layer, not stacked; leaf paths match the JAX tree's with a
layer index, e.g. ``layers/3/attn/wq`` or ``groups/3/rec1/rec/wa``, so
quantization and calibration regexes select the same leaves)::

    embed [V, d], final_norm [d], unembed [d, V] (none when tied)
    extra_embeds [K-1, V, d], out_heads [K-1, d, V]   (K = n_codebooks > 1)
    frontend_proj [frontend_dim, d]        (the vision / audio stub projector)
    layers: [ {ln1 [d], attn {wq, wk, wv, wo}, ln2 [d], mlp {wi, wo}} ] * L

An MoE model (``cfg.n_experts > 0``) keeps the JAX package's two stacks:
``head_layers``, its ``n_dense_layers`` leading blocks with a dense FFN of
width ``d_ff_dense``, and ``layers``, the rest, whose FFN is ``moe {router,
wi [E, d, 2ff], wo [E, ff, d], shared_wi, shared_wo}``. MLA blocks
(``attention == "mla"``) hold ``attn {w_dq, q_norm, w_uq, w_dkv, w_kr,
kv_norm, w_ukv, wo}`` and cache ``(c_kv [B,S,rank], k_rope [B,S,dr])``.
An SSM model's ``layers`` are ``{ln1, ssm {w_in, w_out, conv_w, A_log, D,
dt_bias, norm}}`` and cache ``(state [B,H,P,N] f32, conv_state
[B,W-1,conv_dim])``. A hybrid (``layer_pattern`` (rec, rec, attn)) keeps
``groups``, each ``{rec1, rec2, attn}``, and ``tail``, the recurrent layers
left over; a recurrent block is ``{ln1, rec {w_x, w_gate, w_out, conv_w,
wa, wi, ba, bi, lam}, ln2, mlp}`` and caches ``(h [B,din], conv_state
[B,W-1,din])``. With ``tie_embeddings`` the head reads ``embed``
(dequantized first when quantized). Caches and pools follow the stacks:
``{"head_layers": [...], "layers": [...]}`` or ``{"groups": [{"rec1",
"rec2", "attn"}, ...], "tail": [...]}``, one tuple of leaves per layer.

Entry points:
    forward(params, batch, cfg)                  -> (logits, aux)
    prefill(params, batch, cfg, pad_to, n_valid) -> (logits, cache)
    decode_step(params, cache, tokens, pos, cfg) -> (logits, cache)
    prefill_paged(params, pools, batch, pos, tables, cfg)    -> (logits, pools)
    decode_step_paged(params, pools, tokens, pos, tables, cfg) -> (logits, pools)
    verify_step(params, cache, tokens, pos, cfg)  -> (logits [B,M,V], cache)
    verify_step_paged(params, pools, tokens, pos, tables, cfg) -> (logits, pools)

A Python loop over the stacks in layer order stands in for the JAX
``scan``; ``aux`` (the MoE router's ``lb_loss``, ``z_loss`` and
``fraction_dropped``) is summed over the layers as the scan carries it. In
train mode with ``cfg.remat`` and grad mode on, each scanned unit (a layer,
or a hybrid's whole group) runs under ``torch.utils.checkpoint`` (the JAX
package's ``jax.checkpoint`` of its scan body): the backward recomputes
it, flash kernel launch included.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.quantize import kv_group_size
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rec_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.config import ModelConfig, check_supported
from repro_torch.models.layers import (dense_init, embed_init, is_quantized,
                                       linear, rms_norm, swiglu)


#: the layer stacks of a param tree, cache or pool set, in layer order
STACKS = ("head_layers", "layers", "groups", "tail")
#: a hybrid group's blocks, in layer order
GROUP = ("rec1", "rec2", "attn")


def _zero_aux(device) -> Dict[str, torch.Tensor]:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return {"lb_loss": z, "z_loss": z, "fraction_dropped": z}


def hybrid_split(cfg: ModelConfig):
    """(full (rec, rec, attn) groups, recurrent tail layers)."""
    pat = len(cfg.layer_pattern) or 1
    return cfg.n_layers // pat, cfg.n_layers % pat


def stack_sizes(cfg: ModelConfig) -> Dict[str, int]:
    """Units per stack: an MoE model's ``n_dense_layers`` leading dense
    blocks under ``head_layers`` (when there are any) and the rest under
    ``layers``; a hybrid's groups and its tail (when there is one); every
    other model's layers under ``layers``."""
    if cfg.arch_type == "hybrid":
        n_groups, n_tail = hybrid_split(cfg)
        return {"groups": n_groups, **({"tail": n_tail} if n_tail else {})}
    if cfg.n_experts and cfg.n_dense_layers:
        return {"head_layers": cfg.n_dense_layers,
                "layers": cfg.n_layers - cfg.n_dense_layers}
    return {"layers": cfg.n_layers}


def layer_caches(caches) -> List[tuple]:
    """Every layer's cache (or pool) leaves in layer order: ``head_layers``
    first, a hybrid group's ``rec1``, ``rec2``, ``attn`` in turn, then the
    tail."""
    out = []
    for key in STACKS:
        for c in caches.get(key, ()):
            out.extend([c[k] for k in GROUP] if isinstance(c, dict) else [c])
    return out


# ===================================================================== #
# Init
# ===================================================================== #
def _init_mlp(gen: torch.Generator, cfg: ModelConfig, ff: int) -> dict:
    d, dt = cfg.d_model, cfg.activation_dtype
    return {"wi": dense_init(gen, (d, 2 * ff), dtype=dt),
            "wo": dense_init(gen, (ff, d), dtype=dt)}


def _init_block(gen: torch.Generator, cfg: ModelConfig, moe: bool) -> dict:
    d, dt = cfg.d_model, cfg.activation_dtype
    blk = {"ln1": torch.zeros((d,), dtype=dt, device=gen.device),
           "attn": (attn.init_mla_params(gen, cfg) if cfg.attention == "mla"
                    else attn.init_gqa_params(gen, cfg)),
           "ln2": torch.zeros((d,), dtype=dt, device=gen.device)}
    if moe:
        blk["moe"] = moe_mod.init_moe_params(gen, cfg)
    else:
        blk["mlp"] = _init_mlp(gen, cfg, cfg.d_ff_dense or cfg.d_ff)
    return blk


def _init_ssm_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    return {"ln1": torch.zeros((cfg.d_model,), dtype=cfg.activation_dtype,
                               device=gen.device),
            "ssm": ssm_mod.init_ssm_params(gen, cfg)}


def _init_rec_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, dt = cfg.d_model, cfg.activation_dtype
    return {"ln1": torch.zeros((d,), dtype=dt, device=gen.device),
            "rec": rec_mod.init_rglru_params(gen, cfg),
            "ln2": torch.zeros((d,), dtype=dt, device=gen.device),
            "mlp": _init_mlp(gen, cfg, cfg.d_ff)}


def _init_unit(gen: torch.Generator, cfg: ModelConfig, key: str):
    """One unit of stack ``key``: a layer, or a hybrid's group."""
    if key == "groups":
        return {"rec1": _init_rec_block(gen, cfg),
                "rec2": _init_rec_block(gen, cfg),
                "attn": _init_block(gen, cfg, moe=False)}
    if key == "tail":
        return _init_rec_block(gen, cfg)
    if cfg.arch_type == "ssm":
        return _init_ssm_block(gen, cfg)
    return _init_block(gen, cfg, moe=key == "layers" and cfg.n_experts > 0)


def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random weights drawn on ``device`` (default: the card) from a
    ``torch.Generator`` seeded with ``seed``."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dt = cfg.activation_dtype
    p = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dt),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab_size),
                                  dtype=dt)
    if cfg.n_codebooks > 1:
        # codebook 0 reads embed / unembed; each further codebook its own
        # slice of these stacks
        n = cfg.n_codebooks - 1
        p["extra_embeds"] = embed_init(
            gen, (n, cfg.vocab_size, cfg.d_model), dt)
        p["out_heads"] = dense_init(gen, (n, cfg.d_model, cfg.vocab_size),
                                    in_axis=1, dtype=dt)
    if cfg.frontend != "none":
        p["frontend_proj"] = dense_init(
            gen, (cfg.frontend_dim, cfg.d_model), dtype=dt)
    for key, n in stack_sizes(cfg).items():
        p[key] = [_init_unit(gen, cfg, key) for _ in range(n)]
    return p


# ===================================================================== #
# Embedding / head
# ===================================================================== #
def _take_embed(leaf, tokens, dtype):
    """Embedding gather, aware of quantized and observer leaves. Quantized
    rows dequantize after the gather (minus the zero point when
    asymmetric); a grouped scale runs over the vocab axis, so row v takes
    ``scale[v // g, 0]``."""
    if isinstance(leaf, dict) and ("w_int8" in leaf or "w_int4" in leaf):
        vals = leaf.get("w_int8", leaf.get("w_int4"))
        rows = vals[tokens].to(torch.float32)
        if "zero" in leaf:
            rows = rows - leaf["zero"][0]
        scale = leaf["scale"]
        if scale.dim() == vals.dim() + 1:
            g = vals.shape[0] // scale.shape[0]
            row_scale = scale[:, 0][torch.div(tokens, g,
                                              rounding_mode="floor")]
        else:
            row_scale = scale[0]
        return (rows * row_scale).to(dtype)
    if isinstance(leaf, dict) and "w" in leaf:
        leaf = leaf["w"]
    return leaf[tokens].to(dtype)


def _codebook(leaf, k: int):
    """Codebook ``k``'s slice of a stacked ``[K-1, ...]`` leaf, field by
    field when quantized."""
    if isinstance(leaf, dict):
        return {name: t[k] for name, t in leaf.items()}
    return leaf[k]


def embed_inputs(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """Token embeddings; multi-codebook tokens ``[B, S, K]`` sum their K
    embeddings (codebook 0 from ``embed``, codebook k from
    ``extra_embeds[k - 1]``). With a frontend and
    ``batch["frontend_embeds"]`` ([B, n_frontend_tokens, frontend_dim]),
    the projected embeddings are put in front of them, so positions 0..
    are the patches (or conditioning frames)."""
    dt = cfg.activation_dtype
    tokens = batch["tokens"]
    if cfg.n_codebooks > 1:
        x = _take_embed(params["embed"], tokens[..., 0], dt)
        for k in range(cfg.n_codebooks - 1):
            x = x + _take_embed(_codebook(params["extra_embeds"], k),
                                tokens[..., k + 1], dt)
    else:
        x = _take_embed(params["embed"], tokens, dt)
    if cfg.frontend != "none" and "frontend_embeds" in batch:
        fe = linear(params["frontend_proj"],
                    batch["frontend_embeds"].to(x.dtype))
        x = torch.cat([fe, x], dim=1)
    return x


def _as_weight(leaf, dtype):
    """A head leaf as a plain tensor in ``dtype``: dequantized when
    quantized, an observer leaf's ``w`` as it is."""
    if is_quantized(leaf):
        from repro_torch.core.quant.quantize import dequantize_tensor

        return dequantize_tensor(leaf, dtype)
    return (leaf["w"] if isinstance(leaf, dict) else leaf).to(dtype)


def lm_head(params, x, cfg: ModelConfig):
    """Final norm and head -> f32 logits ``[B, S, V]``. Tied: ``bsd,vd->bsv``
    against the embedding. With K > 1 codebooks, ``[B, S, K, V]``: codebook
    0 through ``unembed``, the others by ``bsd,kdv->bskv`` against
    ``out_heads`` (a plain product, as in the JAX package)."""
    x = rms_norm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", x,
                              _as_weight(params["embed"], x.dtype))
    else:
        logits = linear(params["unembed"], x)
    if cfg.n_codebooks > 1:
        extra = torch.einsum("bsd,kdv->bskv", x,
                             _as_weight(params["out_heads"], x.dtype))
        logits = torch.cat([logits[:, :, None], extra], dim=2)
    return logits.to(torch.float32)


# ===================================================================== #
# Passes
# ===================================================================== #
def _attend(lp, h, cfg: ModelConfig, *, mode: str, cache, positions, pos,
            pad_to: int, tables):
    """The attention half of a block, GQA or MLA, by mode: verify
    (speculative decoding's k+1 positions), decode or prefill, each dense
    or paged (``tables``: pooled leaves read through block tables). The
    dense decode and prefill take ``cfg.window`` (a ring cache when set);
    the paged and verify paths serve full attention only."""
    mla = cfg.attention == "mla"
    a = lp["attn"]
    if mode == "verify":
        if tables is not None:
            fn = attn.mla_verify_paged if mla else attn.gqa_verify_paged
            return fn(a, h, cache, pos, tables, cfg)
        fn = attn.mla_verify if mla else attn.gqa_verify
        return fn(a, h, cache, pos, cfg)
    if mode == "decode":
        if tables is not None:
            fn = attn.mla_decode_paged if mla else attn.gqa_decode_paged
            return fn(a, h, cache, pos, tables, cfg)
        fn = attn.mla_decode if mla else attn.gqa_decode
        return fn(a, h, cache, pos, cfg, window=cfg.window)
    if tables is not None:
        fn = attn.mla_prefill_paged if mla else attn.gqa_prefill_paged
        return fn(a, h, positions, cache, pos, tables, cfg)
    fn = attn.mla_prefill if mla else attn.gqa_prefill
    return fn(a, h, positions, cfg, window=cfg.window, pad_to=pad_to)


def _block(lp, x, cfg: ModelConfig, *, mode: str, cache=None,
           positions=None, pos=None, pad_to: int = 0, tables=None):
    """(x, new cache, aux) of one block: an MoE block's FFN routes and
    gives its aux, a dense block's gives None (zeros, not launched)."""
    h = rms_norm(lp["ln1"], x, cfg.norm_eps)
    a_out, new_cache = _attend(lp, h, cfg, mode=mode, cache=cache,
                               positions=positions, pos=pos, pad_to=pad_to,
                               tables=tables)
    x = x + a_out
    h2 = rms_norm(lp["ln2"], x, cfg.norm_eps)
    if "moe" in lp:
        f_out, aux = moe_mod.moe_ffn(lp["moe"], h2, cfg)
    else:
        f_out, aux = swiglu(lp["mlp"]["wi"], lp["mlp"]["wo"], h2), None
    return x + f_out, new_cache, aux


def _ssm_block(lp, x, cfg: ModelConfig, *, mode: str, cache=None):
    h = rms_norm(lp["ln1"], x, cfg.norm_eps)
    if mode == "decode":
        out, new_cache = ssm_mod.ssm_decode(lp["ssm"], h, cache, cfg)
    else:
        out, new_cache = ssm_mod.ssm_prefill(lp["ssm"], h, cfg)
    return x + out, new_cache, None


def _rec_block(lp, x, cfg: ModelConfig, *, mode: str, cache=None):
    """norm -> RG-LRU block -> residual -> norm -> swiglu -> residual."""
    h = rms_norm(lp["ln1"], x, cfg.norm_eps)
    if mode == "decode":
        out, new_cache = rec_mod.rglru_block_decode(lp["rec"], h, cache, cfg)
    else:
        out, new_cache = rec_mod.rglru_block_prefill(lp["rec"], h, cfg)
    x = x + out
    h2 = rms_norm(lp["ln2"], x, cfg.norm_eps)
    return x + swiglu(lp["mlp"]["wi"], lp["mlp"]["wo"], h2), new_cache, None


def _unit(key: str, lp, x, cfg: ModelConfig, *, mode: str, cache=None,
          positions=None, pos=None, pad_to: int = 0, tables=None):
    """(x, new cache, aux or None) of one unit of stack ``key``: a hybrid
    group runs rec1, rec2 and its attention block in turn."""
    if key == "groups":
        new = {}
        for name in GROUP:
            c = None if cache is None else cache[name]
            if name == "attn":
                x, new[name], _ = _block(lp[name], x, cfg, mode=mode,
                                         cache=c, positions=positions,
                                         pos=pos, pad_to=pad_to)
            else:
                x, new[name], _ = _rec_block(lp[name], x, cfg, mode=mode,
                                             cache=c)
        return x, new, None
    if key == "tail":
        return _rec_block(lp, x, cfg, mode=mode, cache=cache)
    if cfg.arch_type == "ssm":
        return _ssm_block(lp, x, cfg, mode=mode, cache=cache)
    return _block(lp, x, cfg, mode=mode, cache=cache, positions=positions,
                  pos=pos, pad_to=pad_to, tables=tables)


def _train_unit(key: str, lp, x, cfg: ModelConfig, positions):
    x, _, aux = _unit(key, lp, x, cfg, mode="train", positions=positions)
    return x if aux is None else (x, aux)


def _backbone(params, x, cfg: ModelConfig, *, mode: str, caches=None,
              pos=None, pad_to: int = 0, tables=None):
    """Runs the stacks in layer order; returns (x, new caches, aux summed
    over the layers). ``tables`` (paged prefill / decode) is shared by
    every layer: block ids are per sequence, not per layer."""
    check_supported(cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    remat = cfg.remat and mode == "train" and torch.is_grad_enabled()
    aux = _zero_aux(x.device)
    new: Dict[str, list] = {}
    for key in STACKS:
        if key not in params:
            continue
        new[key] = []
        for i, lp in enumerate(params[key]):
            if remat:
                # one activation checkpoint per scanned unit (a layer, or
                # a hybrid's group), as jax.checkpoint wraps the scan body:
                # the backward recomputes it
                out = checkpoint(_train_unit, key, lp, x, cfg, positions,
                                 use_reentrant=False,
                                 preserve_rng_state=False)
                x, a = out if isinstance(out, tuple) else (out, None)
                c = None
            else:
                cache = None if caches is None else caches[key][i]
                x, c, a = _unit(key, lp, x, cfg, mode=mode, cache=cache,
                                positions=positions, pos=pos, pad_to=pad_to,
                                tables=tables)
            if a is not None:
                aux = {n: aux[n] + a[n] for n in aux}
            new[key].append(c)
    return x, new, aux


def forward(params, batch, cfg: ModelConfig):
    """Teacher-forced pass: (logits [B,S,V] f32, aux)."""
    x = embed_inputs(params, batch, cfg)
    x, _, aux = _backbone(params, x, cfg, mode="train")
    return lm_head(params, x, cfg), aux


def prefill(params, batch, cfg: ModelConfig, pad_to: int = 0, n_valid=None):
    """(logits at the last real position [B,1,V], cache). ``pad_to``
    reserves cache slots for decode (default: seq + 64). ``n_valid`` marks
    the real token count when the token axis is bucket-padded: logits come
    from position ``n_valid - 1`` (clamped into the sequence, as
    ``dynamic_slice`` does); causal attention keeps the trailing pads out
    of every real position's context."""
    x = embed_inputs(params, batch, cfg)
    if not pad_to:
        pad_to = x.shape[1] + 64
    x, caches, _ = _backbone(params, x, cfg, mode="prefill", pad_to=pad_to)
    if n_valid is None:
        last = x[:, -1:]
    else:
        i = min(max(int(n_valid) - 1, 0), x.shape[1] - 1)
        last = x[:, i:i + 1]
    return lm_head(params, last, cfg), caches


def decode_step(params, caches, tokens, pos, cfg: ModelConfig):
    """tokens [B,1]; pos: int or [B] position of this token. The cache is
    updated in place and returned."""
    x = embed_inputs(params, {"tokens": tokens}, cfg)
    x, caches, _ = _backbone(params, x, cfg, mode="decode", caches=caches, pos=pos)
    return lm_head(params, x, cfg), caches


def prefill_paged(params, caches, batch, pos, tables, cfg: ModelConfig):
    """Paged cold prefill: run the prompt once and write every layer's K/V
    straight into the pools through the per-sequence block table.
    ``caches`` are the pools (``{"layers": [(k_pool, v_pool), ...]}``,
    updated in place), ``tables`` [B, max_blocks] int32 (the scheduler
    allocates the prompt's blocks first) and ``pos`` the valid-token count:
    the token axis may be bucket-padded, and pad positions write to the
    trash block. Returns (logits at ``pos - 1`` [B,1,V], pools)."""
    x = embed_inputs(params, batch, cfg)
    x, caches, _ = _backbone(params, x, cfg, mode="prefill", caches=caches,
                          pos=pos, tables=tables)
    i = min(max(int(pos) - 1, 0), x.shape[1] - 1)
    return lm_head(params, x[:, i:i + 1], cfg), caches


def decode_step_paged(params, caches, tokens, pos, tables, cfg: ModelConfig):
    """Paged decode step: ``caches`` are the pools (updated in place),
    ``tables`` the per-sequence block table [B, max_blocks] and ``pos`` the
    per-sequence positions [B]. Same contract as ``decode_step``
    otherwise."""
    x = embed_inputs(params, {"tokens": tokens}, cfg)
    x, caches, _ = _backbone(params, x, cfg, mode="decode", caches=caches,
                          pos=pos, tables=tables)
    return lm_head(params, x, cfg), caches


def verify_step(params, caches, tokens, pos, cfg: ModelConfig):
    """Multi-token verify (speculative decoding): score M candidate tokens
    [B, M] in one pass against a dense cache (updated in place); ``pos``
    (int or [B]) is the cache position of ``tokens[:, 0]``. Returns (logits
    [B, M, V], caches): ``logits[:, i]`` is what M sequential
    ``decode_step`` calls would give after ``tokens[:, :i+1]``. All M
    tokens' K/V are written; callers roll a rejected tail back by position
    alone (stale entries are masked, then overwritten)."""
    x = embed_inputs(params, {"tokens": tokens}, cfg)
    x, caches, _ = _backbone(params, x, cfg, mode="verify", caches=caches,
                          pos=pos)
    return lm_head(params, x, cfg), caches


def verify_step_paged(params, caches, tokens, pos, tables, cfg: ModelConfig):
    """Paged ``verify_step``: pools and per-sequence block tables; the
    scheduler truncates tail blocks that hold only rejected tokens
    (``PagedKVCache.truncate``)."""
    x = embed_inputs(params, {"tokens": tokens}, cfg)
    x, caches, _ = _backbone(params, x, cfg, mode="verify", caches=caches,
                          pos=pos, tables=tables)
    return lm_head(params, x, cfg), caches


def kv_leaves(cfg: ModelConfig, lead, device) -> tuple:
    """One layer's zeroed KV leaves with leading dims ``lead`` (``(B, S)``
    for a dense cache, ``(N, bs)`` for a block pool): ``(k, v)`` in the
    activation dtype, or for the quantized tiers ``(k_q, k_scale, v_q,
    v_scale)``: int8 codes ``[*lead, Hkv, hd]`` and f32 scales
    ``[*lead, Hkv]``; int4: packed codes ``[*lead, Hkv, hd // 2]`` (two per
    int8 byte) and f16 group scales ``[*lead, Hkv, hd // g]``. MLA: the
    head-free ``(c_kv [*lead, rank], k_rope [*lead, dr])`` in the
    activation dtype, whatever the tier (MLA has no quantized tier)."""
    if cfg.attention == "mla":
        dt = cfg.activation_dtype
        return (torch.zeros(tuple(lead) + (cfg.kv_lora_rank,), dtype=dt,
                            device=device),
                torch.zeros(tuple(lead) + (cfg.qk_rope_dim,), dtype=dt,
                            device=device))
    hd = cfg.resolved_head_dim
    shape = tuple(lead) + (cfg.n_kv_heads, hd)
    if cfg.kv_precision == "int4":
        ng = hd // kv_group_size(hd)
        codes = lambda: torch.zeros(shape[:-1] + (hd // 2,),  # noqa: E731
                                    dtype=torch.int8, device=device)
        scale = lambda: torch.zeros(shape[:-1] + (ng,),  # noqa: E731
                                    dtype=torch.float16, device=device)
        return codes(), scale(), codes(), scale()
    if cfg.kv_precision == "int8":
        codes = lambda: torch.zeros(shape, dtype=torch.int8, device=device)  # noqa: E731
        scale = lambda: torch.zeros(shape[:-1], dtype=torch.float32,  # noqa: E731
                                    device=device)
        return codes(), scale(), codes(), scale()
    dt = cfg.activation_dtype
    return (torch.zeros(shape, dtype=dt, device=device),
            torch.zeros(shape, dtype=dt, device=device))


def _cache_len(cfg: ModelConfig, seq_len: int) -> int:
    return min(seq_len, cfg.window) if cfg.window else seq_len


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Zeroed dense caches for ``batch`` sequences of up to ``seq_len``
    tokens: KV leaves (a window's ring holds ``min(seq_len, window)``
    slots), an SSM layer's ``(state f32, conv_state)``, a recurrent
    layer's ``(h, conv_state)`` in the activation dtype."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = cfg.activation_dtype
    w1 = cfg.conv_width - 1

    def kv():
        return kv_leaves(cfg, (batch, _cache_len(cfg, seq_len)), dev)

    def ssm():
        conv_dim = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
        return (torch.zeros((batch, cfg.ssm_nheads, cfg.ssm_headdim,
                             cfg.ssm_state), dtype=torch.float32, device=dev),
                torch.zeros((batch, w1, conv_dim), dtype=dt, device=dev))

    def rec():
        return (torch.zeros((batch, cfg.d_inner), dtype=dt, device=dev),
                torch.zeros((batch, w1, cfg.d_inner), dtype=dt, device=dev))

    def unit(key):
        if key == "groups":
            return {"rec1": rec(), "rec2": rec(), "attn": kv()}
        if key == "tail":
            return rec()
        return ssm() if cfg.arch_type == "ssm" else kv()

    return {key: [unit(key) for _ in range(n)]
            for key, n in stack_sizes(cfg).items()}
