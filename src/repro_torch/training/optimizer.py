"""AdamW with fp32 or int8 moments: the port of
``repro.training.optimizer``.

State layout (the param tree's structure, per-layer list included)::

    fp32:  {"mu": {... leaf: {"m": f32, "v": f32}}, "step": int32 []}
    int8:  {"mu": {... leaf: {"m": {"q": i8, "scale": f32[..., 1]},
                               "v": {...}}}, "step": int32 []}

Two rules follow the JAX package's stacked layout ``[L, ...]`` of the
leaves under ``layers``, not the port's per-layer list:

- weight decay applies to a leaf of rank >= 2 in that layout, so each
  layer's norm gains ``ln1`` / ``ln2`` (``[d]`` here, ``[L, d]`` there)
  are decayed and ``final_norm`` is not;
- the int8 moments keep one scale per row of the last axis, so a ``[d]``
  leaf has a ``[1]`` scale, the per-layer row of JAX's ``[L, 1]``.

Every update is functional: new tensors come back and the inputs are
left as they were. Constants divide as same-device tensors (IEEE
division on every device) and each product and sum is its own op, as the
JAX function computes eagerly; under ``jax.jit`` XLA multiplies by
``f32(1/127)`` and contracts ``b1 * m + (1 - b1) * g`` into a fused
multiply-add, which moves a moment by an ulp.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from repro_torch.models.transformer import STACKS
from repro_torch.tree import get_path, leaves_with_path, map_with_path


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    int8_state: bool = False


def lr_at(step, oc: OptimizerConfig) -> torch.Tensor:
    """Linear warmup to ``oc.lr``, then a cosine to a tenth of it, in f32;
    ``step`` is an int or an integer tensor (its device is kept)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp((step + 1) / max(oc.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - oc.warmup_steps)
                       / max(oc.total_steps - oc.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return oc.lr * warm * (0.1 + 0.9 * cos)


# ---- int8 moment compression ------------------------------------------ #
def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _q8(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-row absmax int8: ``scale = max(absmax, 1e-20) / 127`` over the
    last axis (kept), codes rounded half to even; a 0-d leaf is lifted to
    ``[1]``."""
    if x.dim() == 0:
        x = x[None]
    absmax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.maximum(absmax, _const(1e-20, x)) / _const(127.0, x)
    return {"q": torch.round(x / scale).to(torch.int8), "scale": scale}


def _dq8(q: Dict[str, torch.Tensor]) -> torch.Tensor:
    return q["q"].to(torch.float32) * q["scale"]


def _jax_rank(path: str, p: torch.Tensor) -> int:
    """The leaf's rank in the JAX layout: one more under a layer stack."""
    return p.dim() + (1 if path.startswith(tuple(f"{k}/" for k in STACKS))
                      else 0)


def adamw_init(params, oc: OptimizerConfig):
    """Zero moments (fp32, or int8 codes with their scales) and step 0."""
    def zeros(_, p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if oc.int8_state:
            return {"m": _q8(z), "v": _q8(z)}
        return {"m": z, "v": z}

    device = next(leaves_with_path(params))[1].device
    step = torch.zeros((), dtype=torch.int32, device=device)
    return {"mu": map_with_path(zeros, params), "step": step}


def adamw_update(params, grads, state, oc: OptimizerConfig):
    """(new params, new state, {"grad_norm", "lr"}): global-norm clip to
    ``oc.grad_clip``, bias-corrected moments, decoupled weight decay on
    leaves of JAX rank >= 2."""
    step = state["step"] + 1
    lr = lr_at(step, oc)
    step_f = step.to(torch.float32)
    b1c = 1.0 - torch.pow(oc.b1, step_f)
    b2c = 1.0 - torch.pow(oc.b2, step_f)

    # global-norm clip
    gnorm = torch.sqrt(torch.stack([g.to(torch.float32).square().sum()
                                    for _, g in leaves_with_path(grads)]).sum())
    scale = torch.clamp(_const(oc.grad_clip, gnorm)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)

    new_p, new_mu = {}, {}
    for path, p in leaves_with_path(params):
        g, mu = get_path(grads, path), get_path(state["mu"], path)
        g = g.to(torch.float32) * scale
        m = _dq8(mu["m"]) if oc.int8_state else mu["m"]
        v = _dq8(mu["v"]) if oc.int8_state else mu["v"]
        if oc.int8_state and p.dim() == 0:
            m, v = m[0], v[0]
        m = oc.b1 * m + (1 - oc.b1) * g
        v = oc.b2 * v + (1 - oc.b2) * torch.square(g)
        update = (m / b1c) / (torch.sqrt(v / b2c) + oc.eps)
        pf = p.to(torch.float32)
        if _jax_rank(path, p) >= 2:
            update = update + oc.weight_decay * pf
        new_p[path] = (pf - lr * update).to(p.dtype)
        new_mu[path] = ({"m": _q8(m), "v": _q8(v)} if oc.int8_state
                        else {"m": m, "v": v})
    mu = map_with_path(lambda path, _: new_mu[path], params)
    params = map_with_path(lambda path, _: new_p[path], params)
    return params, {"mu": mu, "step": step}, {"grad_norm": gnorm, "lr": lr}
