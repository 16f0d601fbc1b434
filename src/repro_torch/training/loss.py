"""Cross-entropy with ignore-index masking plus the MoE aux terms: the port
of ``repro.training.loss``."""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig

IGNORE = -100


def xent(logits: torch.Tensor, labels: torch.Tensor):
    """logits [..., V] f32; labels [...] int with IGNORE at masked
    positions -> (mean loss, token accuracy) over the valid positions."""
    valid = labels != IGNORE
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    n = valid.sum().clamp(min=1)
    loss = torch.where(valid, nll, torch.zeros_like(nll)).sum() / n
    acc = (valid & (logits.argmax(-1) == safe)).sum() / n
    return loss, acc


def total_loss(logits, aux, batch, cfg: ModelConfig):
    """Pads the labels with IGNORE over the frontend positions, then adds
    ``router_aux_coef * lb_loss + router_z_coef * z_loss``."""
    labels = batch["labels"]
    if cfg.frontend != "none" and logits.shape[1] != labels.shape[1]:
        pad = logits.shape[1] - labels.shape[1]
        pad_block = torch.full(labels.shape[:1] + (pad,) + labels.shape[2:],
                               IGNORE, dtype=labels.dtype,
                               device=labels.device)
        labels = torch.cat([pad_block, labels], dim=1)
    loss, acc = xent(logits, labels)
    loss = loss + cfg.router_aux_coef * aux["lb_loss"] \
        + cfg.router_z_coef * aux["z_loss"]
    metrics = {"xent": loss, "token_acc": acc,
               "lb_loss": aux["lb_loss"], "dropped": aux["fraction_dropped"]}
    return loss, metrics
