"""Synthetic data: the port of ``repro.data.pipeline``.

``lm_batch`` / ``lm_stream``: a Zipf-like token stream with first-order
structure, so a language model's training loss falls.

``vqi_batch`` / ``vqi_stream``: the synthetic VQI dataset (TTPLA-like
visual quality inspection, the paper's use case). Each sample is a set of
patch embeddings (the stubbed vision frontend's output) drawn around a
centroid fixed by its (asset type, condition); the model must emit the two
class tokens. Layout, shapes and the label scheme are the JAX package's;
tokens are int64, as torch indexes with them.

The numbers are not the JAX package's, for either dataset: ``jax.random``
cannot be drawn in torch, so the distributions are the same and the draws
are not. The VQI centroids come from a ``torch.Generator`` seeded with
``CENTROID_SEED`` and the rest from the caller's generator. Every draw is
made on the host and moved to ``device``, so a seed gives the same batch on
every device. Tests that compare the packages feed both the same JAX-made
batches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.training.loss import IGNORE

ASSET_TYPES = ("transmission_tower", "power_line", "transformer", "switchgear")
CONDITIONS = ("good", "degraded", "critical")
# the class centroids are part of the dataset's definition, not of the
# sampling stream: every caller sees the same clusters
CENTROID_SEED = 1234


# --------------------------------------------------------------------- #
# Language-model stream
# --------------------------------------------------------------------- #
def lm_batch(gen: torch.Generator, cfg: ModelConfig, batch: int, seq: int,
             device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """``tokens`` / ``labels`` [B, S] int64: Pareto(1.2) * 8 steps clipped
    to the vocab, tokens ``(cumsum * 31 + base) % V`` with a uniform
    ``base`` per row, labels the tokens rolled left by one with the last
    position IGNORE. With K > 1 codebooks both are [B, S, K]: codebook k
    holds ``(tokens + 7k) % V``, and every codebook's last label is IGNORE.
    ``gen`` is a host generator."""
    dev = resolve_device(device)
    v = cfg.vocab_size
    # Pareto(1.2) on [1, inf) is exp(Exponential(1) / 1.2); the clip to
    # V - 1 comes before the integer cast, as XLA's cast saturates
    pareto = torch.exp(torch.empty((batch, seq)).exponential_(
        generator=gen) / 1.2)
    zipf = torch.clamp(pareto * 8, 0, v - 1).to(torch.int64)
    base = torch.randint(0, v, (batch, 1), generator=gen)
    toks = (torch.cumsum(zipf, dim=1) * 31 + base) % v
    if cfg.n_codebooks > 1:
        toks = torch.stack([(toks + 7 * k) % v
                            for k in range(cfg.n_codebooks)], dim=-1)
    labels = torch.roll(toks, -1, dims=1)
    labels[:, -1] = IGNORE
    return {"tokens": toks.to(dev), "labels": labels.to(dev)}


def lm_stream(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
              device: DeviceLike = None
              ) -> Iterator[Dict[str, torch.Tensor]]:
    gen = torch.Generator().manual_seed(seed)
    while True:
        yield lm_batch(gen, cfg, batch, seq, device)


# --------------------------------------------------------------------- #
# VQI synthetic dataset (TTPLA-like)
# --------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class VQITask:
    """Token layout: [frontend patches] [BOS] -> predict asset, condition."""
    n_assets: int = len(ASSET_TYPES)
    n_conditions: int = len(CONDITIONS)
    noise: float = 0.6

    def vocab_layout(self, cfg: ModelConfig) -> Dict[str, int]:
        # the top of the vocab is reserved for the class tokens
        base = cfg.vocab_size - self.n_assets - self.n_conditions - 1
        return {"bos": base,
                "asset0": base + 1,
                "cond0": base + 1 + self.n_assets}


def _centroids(cfg: ModelConfig, task: VQITask) -> torch.Tensor:
    gen = torch.Generator().manual_seed(CENTROID_SEED)
    return torch.randn((task.n_assets, task.n_conditions, cfg.frontend_dim),
                       generator=gen) * 2.0


def vqi_batch(gen: torch.Generator, cfg: ModelConfig, task: VQITask,
              batch: int, device: DeviceLike = None
              ) -> Dict[str, torch.Tensor]:
    """Patch embeddings drawn from class-conditioned Gaussian clusters:
    ``tokens`` / ``labels`` [B, 3] int64, ``frontend_embeds`` [B,
    n_frontend_tokens, frontend_dim] f32, ``asset`` / ``cond`` [B]. ``gen``
    is a host generator."""
    dev = resolve_device(device)
    lay = task.vocab_layout(cfg)
    asset = torch.randint(0, task.n_assets, (batch,), generator=gen)
    cond = torch.randint(0, task.n_conditions, (batch,), generator=gen)
    mu = _centroids(cfg, task)[asset, cond]                       # [B, fd]
    patches = mu[:, None, :] + task.noise * torch.randn(
        (batch, cfg.n_frontend_tokens, cfg.frontend_dim), generator=gen)
    toks = torch.stack([torch.full((batch,), lay["bos"]),
                        lay["asset0"] + asset,
                        lay["cond0"] + cond], dim=1)
    labels = torch.stack([lay["asset0"] + asset,      # asset from BOS
                          lay["cond0"] + cond,        # condition from asset
                          torch.full((batch,), IGNORE)], dim=1)
    out = {"tokens": toks, "labels": labels,
           "frontend_embeds": patches.to(torch.float32),
           "asset": asset, "cond": cond}
    return {k: v.to(dev) for k, v in out.items()}


def vqi_stream(cfg: ModelConfig, batch: int, seed: int = 0,
               task: VQITask = VQITask(), device: DeviceLike = None
               ) -> Iterator[Dict[str, torch.Tensor]]:
    gen = torch.Generator().manual_seed(seed)
    while True:
        yield vqi_batch(gen, cfg, task, batch, device)


def vqi_eval_accuracy(logits: torch.Tensor, batch, cfg: ModelConfig,
                      task: VQITask = VQITask()) -> Tuple[float, float]:
    """(asset accuracy, condition accuracy) from teacher-forced logits."""
    lay = task.vocab_layout(cfg)
    off = cfg.n_frontend_tokens
    a_slice = logits[:, off + 0, lay["asset0"]: lay["asset0"] + task.n_assets]
    c_slice = logits[:, off + 1, lay["cond0"]: lay["cond0"] + task.n_conditions]
    a_hit = (a_slice.argmax(-1) == batch["asset"].to(a_slice.device))
    c_hit = (c_slice.argmax(-1) == batch["cond"].to(c_slice.device))
    acc = torch.stack([a_hit.float().mean(), c_hit.float().mean()]).tolist()
    return acc[0], acc[1]
