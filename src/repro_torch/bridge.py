"""Bridge from a JAX param tree (as numpy arrays) to the port's tree.

The caller converts the JAX tree to numpy first (``jax.tree.map(np.asarray,
params)``), so this module never imports JAX. Layer-stacked ``[L, ...]``
leaves under ``layers``, for an MoE model ``head_layers``, and for a hybrid
``groups`` (nested ``{rec1, rec2, attn}`` dicts) and ``tail``
(``repro.models.transformer.init_params``) are unstacked into the port's
per-unit lists; quantized leaf dicts unstack field by field (``w_int8
[L,K,N]``, ``scale [L,1,N]``, ``act_scale [L]``; an expert leaf's
``w_int8 [L,E,d,2ff]``).

``stack_layers`` / ``unstack_layers`` move a port param tree to the JAX
layout and back with the tensors left as they are (the checkpoint format
of ``training/checkpoint.py`` is the JAX tree's). The frontend projector
``frontend_proj`` and musicgen's codebook stacks ``extra_embeds`` ``[K-1,
V, d]`` / ``out_heads`` ``[K-1, d, V]`` (fp or quantized, field by field)
are top-level leaves and cross as they are.

Caches and block pools convert in both directions: the JAX package keeps
one ``[L, ...]`` leaf per cache field and stack (``{"layers": (k, v)}``
with ``k`` ``[L, B, S, Hkv, hd]`` dense or ``[L, N, bs, Hkv, hd]`` pooled,
or the quantized tiers' ``(k_q, k_scale, v_q, v_scale)``: int8 codes with
f32 scales, or int4 packed codes with f16 group scales; MLA's ``(c_kv,
k_rope)``; an MoE model's ``head_layers`` beside ``layers``), the port one
tuple of the same fields per layer. Every dtype round-trips bit for bit (f16 as
f16, bfloat16 through its 16-bit pattern).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig, check_supported
from repro_torch.models.transformer import STACKS
from repro_torch.tree import leaves_with_path, map_with_path


def to_torch(a, device) -> torch.Tensor:
    """numpy -> torch tensor on ``device``; bfloat16 arrives as
    ``ml_dtypes.bfloat16`` (from JAX) or as the 2-byte void type ``|V2``
    (from an npz file)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def params_from_jax(tree, cfg: ModelConfig, device: DeviceLike = None) -> Any:
    """JAX param tree of numpy arrays -> port param tree on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    return unstack_layers(map_with_path(lambda _, a: to_torch(a, dev), tree))


def stack_layers(params) -> Any:
    """The port's tree -> the JAX layout, tensors kept: each per-layer list
    (``layers``, and ``head_layers`` of an MoE model) becomes one dict
    whose leaves are stacked ``[L, ...]`` (quantized dicts field by field,
    a static ``act_scale`` as ``[L]``)."""
    out = {k: v for k, v in params.items() if k not in STACKS}

    def stack(node, *rest):
        if isinstance(node, dict):
            return {k: stack(v, *(r[k] for r in rest))
                    for k, v in node.items()}
        return torch.stack([node, *rest])

    for key in STACKS:
        if key in params:
            out[key] = stack(*params[key])
    return out


def unstack_layers(tree, n_layers: int = 0) -> Any:
    """Inverse of ``stack_layers``: the ``[L, ...]`` leaves of each stack
    become the port's list of per-layer dicts, L read from the leaves
    (``n_layers``, when given, must be the layers of all stacks)."""
    out = {k: v for k, v in tree.items() if k not in STACKS}
    for key in STACKS:
        if key in tree:
            n = next(t.shape[0] for _, t in leaves_with_path(tree[key]))
            out[key] = [map_with_path(lambda _, t, i=i: t[i], tree[key])
                        for i in range(n)]
    got = sum(len(out[key]) for key in STACKS if key in out)
    if n_layers and got != n_layers:
        raise ValueError(f"the tree holds {got} layers, not {n_layers}")
    return out


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """torch tensor -> numpy on the host; bfloat16 comes back as
    ``ml_dtypes.bfloat16`` (the dtype JAX arrays convert to)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def opt_state_from_jax(state, cfg: ModelConfig, device: DeviceLike = None
                       ) -> Any:
    """JAX AdamW state of numpy arrays (``{"mu": ..., "step"}``, fp32
    ``{"m", "v"}`` or int8 ``{"q", "scale"}`` moments, ``[L, ...]`` under
    ``layers``) -> the port's state on ``device``, unstacked as
    ``params_from_jax`` unstacks the params: an int8 scale ``[L, 1]``
    becomes each layer's ``[1]``."""
    dev = resolve_device(device)
    return {"mu": params_from_jax(state["mu"], cfg, dev),
            "step": to_torch(state["step"], dev)}


def grads_to_jax(tree) -> Any:
    """A port tree shaped like the params (grads, moments) -> numpy leaves
    in the JAX layout (``stack_layers``), to compare leaf by leaf."""
    return map_with_path(lambda _, t: to_numpy(t), stack_layers(tree))


def _unstack_cache(node, dev) -> list:
    """A stack's ``[L, ...]`` fields (a tuple, or a hybrid group's dict of
    tuples) -> one tuple (or dict of tuples) per unit."""
    if isinstance(node, dict):
        per = {k: _unstack_cache(v, dev) for k, v in node.items()}
        n = len(next(iter(per.values())))
        return [{k: per[k][i] for k in per} for i in range(n)]
    fields = [np.asarray(a) for a in node]
    return [tuple(to_torch(f[i], dev) for f in fields)
            for i in range(fields[0].shape[0])]


def _stack_cache(units: list):
    """Inverse of ``_unstack_cache``, to numpy."""
    if isinstance(units[0], dict):
        return {k: _stack_cache([u[k] for u in units]) for k in units[0]}
    return tuple(np.stack([to_numpy(t[j]) for t in units])
                 for j in range(len(units[0])))


def cache_from_jax(tree, device: DeviceLike = None) -> Any:
    """JAX cache or pools as numpy (``{"layers": (k, v)}``, the int8 /
    int4 4-tuple, MLA's ``(c_kv, k_rope)`` or an SSM layer's ``(state,
    conv_state)``, leaves ``[L, ...]``; an MoE model's ``head_layers``
    alike; a hybrid's ``{"groups": {"rec1": (h, conv), "rec2": ..., "attn":
    kv}, "tail": (h, conv)}``) -> the port's ``{"layers": [(k, v), ...]}``
    (a hybrid: ``{"groups": [{"rec1", "rec2", "attn"}, ...], "tail":
    [...]}``), stack by stack."""
    dev = resolve_device(device)
    return {key: _unstack_cache(tree[key], dev)
            for key in STACKS if key in tree}


def cache_to_jax(cache) -> Any:
    """The port's per-layer tuples -> numpy leaves stacked as the JAX
    package holds them: ``{"layers": (k [L, ...], v [L, ...])}`` (or the
    int8 / int4 4-tuple, MLA's pair, an SSM layer's pair, a hybrid's group
    dict), stack by stack."""
    return {key: _stack_cache(cache[key]) for key in STACKS if key in cache}
