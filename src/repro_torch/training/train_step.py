"""Train step with gradient-accumulation micro-batching: the port of
``repro.training.train_step``.

Grads come from ``torch.autograd.grad`` over detached leaves that require
grad, so the caller's params never carry a graph. Every attention layer of
the forward runs the ``flash_prefill`` kernel on the card, under its
autograd Function (``kernels/flash_prefill.py``). Under a mesh
(``models.sharding.set_mesh``) the same code runs on DTensor params,
moments and batches: detached DTensor leaves, the activation checkpoints
and the int8 moments' per-row absmax over a sharded last dim all work as
they are.
"""
from __future__ import annotations

import functools
from typing import Dict

import torch

from repro_torch.models import forward
from repro_torch.models.config import ModelConfig
from repro_torch.training.loss import total_loss
from repro_torch.training.optimizer import OptimizerConfig, adamw_update
from repro_torch.tree import leaves_with_path, map_with_path


def _microbatches(batch: Dict[str, torch.Tensor], accum: int):
    """``accum`` micro-batches of consecutive rows (the JAX reshape
    ``[accum, B // accum, ...]``)."""
    return [{k: torch.chunk(v, accum)[i] for k, v in batch.items()}
            for i in range(accum)]


def _value_and_grad(params, batch, cfg: ModelConfig):
    """(loss, metrics, grads) of one batch; loss and metrics detached."""
    leaves = dict(leaves_with_path(params))
    live = {path: t.detach().requires_grad_(True)
            for path, t in leaves.items()}
    with torch.enable_grad():
        p = map_with_path(lambda path, _: live[path], params)
        logits, aux = forward(p, batch, cfg)
        loss, metrics = total_loss(logits, aux, batch, cfg)
        grads = torch.autograd.grad(loss, list(live.values()))
    by_path = dict(zip(live, grads))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            map_with_path(lambda path, _: by_path[path], params))


def loss_and_grads(params, batch, cfg: ModelConfig):
    """(loss, metrics, grads). With ``cfg.grad_accum > 1`` the grads (in
    f32), the loss and the metrics are summed over the micro-batches and
    multiplied by ``1 / accum``."""
    accum = max(cfg.grad_accum, 1)
    if accum == 1:
        return _value_and_grad(params, batch, cfg)
    g_acc = l_acc = m_acc = None
    for mb in _microbatches(batch, accum):
        loss, metrics, grads = _value_and_grad(params, mb, cfg)
        grads = dict(leaves_with_path(grads))
        if g_acc is None:
            g_acc, l_acc, m_acc = ({path: g.to(torch.float32)
                                    for path, g in grads.items()},
                                   loss, metrics)
            continue
        g_acc = {path: a + grads[path].to(torch.float32)
                 for path, a in g_acc.items()}
        l_acc = l_acc + loss
        m_acc = {k: m_acc[k] + metrics[k] for k in m_acc}
    inv = 1.0 / accum
    return (l_acc * inv, {k: m * inv for k, m in m_acc.items()},
            map_with_path(lambda path, _: g_acc[path] * inv, params))


def train_step(params, opt_state, batch, cfg: ModelConfig,
               oc: OptimizerConfig):
    loss, metrics, grads = loss_and_grads(params, batch, cfg)
    params, opt_state, opt_metrics = adamw_update(params, grads, opt_state,
                                                  oc)
    metrics = dict(metrics, loss=loss, **opt_metrics)
    return params, opt_state, metrics


def make_train_step(cfg: ModelConfig, oc: OptimizerConfig):
    return functools.partial(train_step, cfg=cfg, oc=oc)
