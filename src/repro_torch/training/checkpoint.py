"""Checkpoints and registry artifacts: the port of
``repro.training.checkpoint``, in the JAX package's on-disk format.

    <dir>/weights.npz     the param tree in the JAX layout (layers stacked
                          ``[L, ...]``), flat keys joined with "::", e.g.
                          ``layers::attn::wq`` or ``layers::mlp::wi::w_int8``
    <dir>/manifest.json   model_config (``dataclasses.asdict``), sha256 and
                          size_bytes of weights.npz, meta

Either package reads what the other wrote. The port holds layers as a
list, so ``save_checkpoint`` restacks them and ``load_checkpoint``
unstacks them (``bridge.stack_layers`` / ``unstack_layers``). bfloat16
leaves are written as numpy's 2-byte void type ``|V2``, the bytes
``np.savez`` writes for a JAX bf16 leaf, and a ``|V2`` leaf loads as
bfloat16 (the JAX loader cannot read one back; the port can). The sha256
covers the npz bytes, zip timestamps included: compare two packages'
artifacts leaf by leaf, not by hash.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.bridge import stack_layers, to_torch, unstack_layers
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig

_SEP = "::"
_BF16 = np.dtype("V2")


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16)
    return t.numpy()


def _flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for k in sorted(tree):            # the JAX flatten's key order
        key = f"{prefix}{_SEP}{k}" if prefix else str(k)
        v = tree[k]
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        else:
            flat[key] = _leaf_to_numpy(v)
    return flat


def _unflatten(flat: Dict[str, np.ndarray], device) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = to_torch(val, device)
    return tree


def file_sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def save_checkpoint(directory: str, params, cfg: ModelConfig,
                    meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    os.makedirs(directory, exist_ok=True)
    wpath = os.path.join(directory, "weights.npz")
    np.savez(wpath, **_flatten(stack_layers(params)))
    manifest = {
        "model_config": dataclasses.asdict(cfg),
        "sha256": file_sha256(wpath),
        "size_bytes": os.path.getsize(wpath),
        "meta": meta or {},
    }
    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2, default=str)
    return manifest


def load_checkpoint(directory: str, device: DeviceLike = None
                    ) -> Tuple[Any, ModelConfig, Dict[str, Any]]:
    """(params on ``device``, config, manifest); raises ``IOError`` when
    weights.npz does not match the manifest's sha256."""
    dev = resolve_device(device)
    with open(os.path.join(directory, "manifest.json")) as f:
        manifest = json.load(f)
    wpath = os.path.join(directory, "weights.npz")
    if file_sha256(wpath) != manifest["sha256"]:
        raise IOError(f"checkpoint corrupted: sha mismatch in {directory}")
    mc = dict(manifest["model_config"])
    mc["layer_pattern"] = tuple(mc.get("layer_pattern") or ())
    cfg = ModelConfig(**mc)
    with np.load(wpath) as npz:
        tree = _unflatten({k: npz[k] for k in npz.files}, dev)
    return unstack_layers(tree, cfg.n_layers), cfg, manifest
