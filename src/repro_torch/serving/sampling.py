"""Per-request sampling policies: the port of ``repro.serving.sampling``.

A ``SamplingParams`` travels with each request through the continuous-
batching scheduler; ``sample()`` turns one slot's last-position logits into
the next token. Greedy (``temperature == 0``, the default) is
``torch.argmax``, whose first-maximum tie rule is ``jnp.argmax``'s, so greedy
streams match the JAX package token for token.

Sampled tokens draw from a ``torch.Generator`` on the logits' device seeded
from ``(seed, token_index)`` alone, so a request's stream never depends on
which other requests share the batch, when it was admitted or which slot it
landed in. Multi-codebook logits ``[K, V]`` draw one token per codebook,
codebook k from its own generator, seeded from the token's seed and k (the
JAX package splits the token's key K ways). The draws are the port's own:
they cannot match ``jax.random`` bit for bit, and are held to the same
distribution instead.
"""
from __future__ import annotations

import dataclasses

import torch

_MIX = 0x9E3779B97F4A7C15          # golden-ratio odd constant (splitmix64)
_MASK = (1 << 64) - 1


def _seed_for(seed: int, token_index: int) -> int:
    """A 63-bit generator seed that depends only on ``(seed, token_index)``
    (splitmix64 finalizer over the pair, so neighbouring pairs do not give
    neighbouring seeds)."""
    z = (int(seed) * _MIX + int(token_index) + 1) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return (z ^ (z >> 31)) >> 1


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Decoding policy for one request.

    temperature  0.0 -> greedy argmax; >0 softmax-temperature sampling
    top_k        0 -> full vocabulary; >0 restrict to the k best logits
    seed         base of the per-token random stream (deterministic replay)
    """

    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    @classmethod
    def greedy(cls) -> "SamplingParams":
        return cls()

    @property
    def is_greedy(self) -> bool:
        return self.temperature <= 0.0

    def generator_for(self, token_index: int, device=None,
                      codebook: int = -1) -> torch.Generator:
        """Generator for the ``token_index``-th generated token of a
        request (for codebook ``codebook`` of a multi-codebook token).
        Depends only on (seed, token_index, codebook)."""
        gen = torch.Generator(device=device or "cpu")
        seed = _seed_for(self.seed, token_index)
        gen.manual_seed(seed if codebook < 0 else _seed_for(seed, codebook))
        return gen


def filter_logits(logits: torch.Tensor, params: SamplingParams):
    """Temperature-scaled, top-k-masked logits [V] (f32): the distribution
    ``sample`` draws from. The top-k cut is by value, so every logit tied
    with the k-th largest stays eligible."""
    scaled = logits.to(torch.float32) / params.temperature
    if 0 < params.top_k < scaled.shape[-1]:
        kth = torch.sort(scaled).values[-params.top_k]
        scaled = torch.where(scaled >= kth, scaled,
                             torch.full_like(scaled, float("-inf")))
    return scaled


def _sample_row(logits: torch.Tensor, params: SamplingParams,
                gen: torch.Generator = None) -> torch.Tensor:
    """logits [V] -> 0-d int64 token: argmax for greedy params, else a
    Gumbel-max draw from ``filter_logits`` (the categorical sampler
    ``jax.random.categorical`` uses)."""
    if params.is_greedy:
        return torch.argmax(logits, dim=-1)
    scaled = filter_logits(logits, params)
    u = torch.rand(scaled.shape, generator=gen, dtype=torch.float32,
                   device=scaled.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp(min=tiny)))
    return torch.argmax(scaled + gumbel, dim=-1)


def sample(logits: torch.Tensor, params: SamplingParams,
           token_index: int) -> torch.Tensor:
    """Sample the next token from one slot's last-position logits: ``[V]``
    gives a 0-d int64 tensor, multi-codebook ``[K, V]`` a ``[K]`` one (the
    argmax per codebook when greedy, else one draw per codebook, each from
    its own generator), on the logits' device."""
    if logits.dim() == 1 or params.is_greedy:
        gen = (None if params.is_greedy
               else params.generator_for(token_index, logits.device))
        return _sample_row(logits, params, gen)
    return torch.stack([
        _sample_row(logits[k], params,
                    params.generator_for(token_index, logits.device, k))
        for k in range(logits.shape[0])])
