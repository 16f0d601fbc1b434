"""Speculative decoding policies: the port of ``repro.serving.spec_decode``.

A cheap draft variant (the registry's ``dynamic_int8`` by default) proposes
``k`` tokens per step and the target scores all ``k+1`` positions in one
``verify_step`` pass, accepting the longest draft prefix it agrees with:

* greedy (``temperature == 0``): token-match acceptance, so the output is
  token for token the target's own ``InferenceSession.generate``, whatever
  the draft (a bad draft only lowers the acceptance rate);
* ``temperature > 0``: seeded rejection sampling (Leviathan et al. 2023 /
  Chen et al. 2023): accept draft token ``d`` with probability
  ``min(1, p(d)/q(d))``, else resample from ``max(p - q, 0)``.

Every random draw comes from a ``torch.Generator`` seeded from ``(seed,
token index, role tag)`` alone (``sampling._seed_for``), so a stream never
depends on the batch's composition, slot layout or admission order. The
draws are the port's own: they cannot match ``jax.random`` bit for bit, and
are held to the same distribution instead.

The scheduler side (``ContinuousBatchingEngine(spec=SpecConfig(...))``)
lives in ``repro_torch.serving.scheduler``; this module holds the policy
layer: ``SpecConfig``, the support gate and the acceptance functions, in
plain PyTorch as they are plain jnp in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.serving.kvcache import paged_supported
from repro_torch.serving.sampling import (SamplingParams, _sample_row,
                                          _seed_for, filter_logits, sample)

#: tags separating the three random roles of one generated-token index; the
#: untagged stream stays ``sample()``'s (bonus and correction draws)
DRAFT_TAG = 0x5BEC
ACCEPT_TAG = 0xACC1
RESIDUAL_TAG = 0x4E51


@dataclasses.dataclass
class SpecConfig:
    """Speculative-decoding policy for one engine.

    draft            the draft model: a ``ModelArtifact``, an
                     ``InferenceSession`` (its device must be the
                     engine's; its pinned backend is inherited), or a
                     ``(params, cfg)`` tuple
    k                draft tokens proposed per verify step (>= 2)
    draft_backend    kernel backend for the draft's prefill and decode
                     calls (default: the draft session's, else the target
                     engine's)
    allow_moe_target opt-in for capacity-routed MoE targets (no greedy
                     parity guarantee: expert capacity depends on the
                     tokens a pass routes)
    """

    draft: Any
    k: int = 4
    draft_backend: Any = None
    allow_moe_target: bool = False

    def resolve_draft(self) -> Tuple[Any, ModelConfig,
                                     Optional[torch.device], Any]:
        """-> (draft_params, draft_cfg, the draft session's device or None,
        backend or None)."""
        from repro_torch.serving.engine import InferenceSession

        d = self.draft
        if isinstance(d, InferenceSession):
            return d.params, d.cfg, d.device, (
                self.draft_backend if self.draft_backend is not None
                else d.backend)
        if hasattr(d, "params") and hasattr(d, "config"):   # ModelArtifact
            return d.params, d.config, None, self.draft_backend
        params, cfg = d
        return params, cfg, None, self.draft_backend


def spec_supported(target_cfg: ModelConfig, draft_cfg: ModelConfig, k: int,
                   allow_moe_target: bool = False) -> Optional[str]:
    """Why this (target, draft, k) trio cannot run speculative decoding, or
    None if it can: the JAX package's gates and messages. Both models need
    an attention-only, full-attention, single-codebook stack and no
    frontend, and the pair must share one token space."""
    if k < 2:
        # after a fully accepted round the draft is one token behind, so
        # the next draft phase spends one of its k feeds catching up
        return f"k must be >= 2, got {k}"
    for role, cfg in (("target", target_cfg), ("draft", draft_cfg)):
        why = paged_supported(cfg)
        if why is None and cfg.arch_type == "vlm":
            # the JAX paged cache refuses a vlm, and this gate repeats it
            why = f"arch_type {cfg.arch_type!r} has non-attention caches"
        if why is not None:
            return f"{role} {cfg.name}: {why}"
        if cfg.frontend != "none":
            return (f"{role} {cfg.name}: frontend conditioning is not "
                    "supported under speculative decoding yet")
    if target_cfg.n_experts and not allow_moe_target:
        return (f"target {target_cfg.name}: capacity-routed MoE verify has "
                "no greedy bit-parity guarantee (expert capacity depends on "
                "tokens-per-pass) — opt in with "
                "SpecConfig(allow_moe_target=True)")
    if target_cfg.vocab_size != draft_cfg.vocab_size:
        return (f"vocab mismatch: target {target_cfg.vocab_size} vs "
                f"draft {draft_cfg.vocab_size} — draft and target must "
                "share one token space")
    return None


# --------------------------------------------------------------------- #
# Acceptance policies (one request, one step at a time)
# --------------------------------------------------------------------- #
def greedy_accept(draft_tokens: Sequence[int],
                  target_tokens: Sequence[int]) -> Tuple[int, List[int]]:
    """Token-match acceptance: ``target_tokens`` are the target's argmax at
    the k_s+1 scored positions. Returns ``(n_accepted, committed)``: the
    accepted draft prefix, then the target's token at the first divergence
    (correction), or the bonus token when every draft was accepted."""
    committed: List[int] = []
    for i, d in enumerate(draft_tokens):
        t = int(target_tokens[i])
        committed.append(t)
        if int(d) != t:
            return i, committed
    committed.append(int(target_tokens[len(draft_tokens)]))
    return len(draft_tokens), committed


def spec_probs(logits: torch.Tensor, params: SamplingParams) -> torch.Tensor:
    """logits [V] -> f32 probabilities under the temperature and top-k
    filter ``sampling._sample_row`` draws from."""
    return torch.softmax(filter_logits(logits, params), dim=-1)


def tagged_generator(params: SamplingParams, token_index: int, tag: int,
                     device) -> torch.Generator:
    """The generator of one random role (``tag``) at one generated-token
    index: seeded from (seed, token index, tag) alone."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_seed_for(_seed_for(params.seed, token_index), tag))
    return gen


def draft_propose(logits: torch.Tensor, params: SamplingParams,
                  token_index: int) -> Tuple[int, Optional[torch.Tensor]]:
    """One draft proposal from the draft's logits [V]: a draw from the
    filtered draft distribution on the DRAFT_TAG stream (greedy takes the
    argmax). Returns ``(token, q)``, ``q`` the distribution it was drawn
    from (None for greedy)."""
    if params.is_greedy:
        return int(_sample_row(logits, params)), None
    gen = tagged_generator(params, token_index, DRAFT_TAG, logits.device)
    return int(_sample_row(logits, params, gen)), spec_probs(logits, params)


def _categorical(dist: torch.Tensor, gen: torch.Generator) -> int:
    """A draw from ``dist`` [V] by Gumbel-max over its logs."""
    logp = torch.log(torch.clamp(dist, min=1e-38))
    u = torch.rand(logp.shape, generator=gen, dtype=torch.float32,
                   device=logp.device)
    tiny = torch.finfo(torch.float32).tiny
    return int(torch.argmax(logp - torch.log(-torch.log(u.clamp(min=tiny)))))


def rejection_sample(draft_tokens: Sequence[int],
                     draft_probs: Sequence[torch.Tensor],
                     target_logits: torch.Tensor, params: SamplingParams,
                     n_generated: int) -> Tuple[int, List[int]]:
    """Seeded rejection sampling over one verify span (temperature > 0).

    ``draft_probs[i]`` is the filtered distribution proposal i was drawn
    from, ``target_logits`` [>= k_s+1, V] the verify logits, ``n_generated``
    the request's next token index. Returns ``(n_accepted, committed)``
    like ``greedy_accept``; each emitted token is distributed as the
    target's own sampling."""
    committed: List[int] = []
    for i, d in enumerate(draft_tokens):
        d = int(d)
        idx = n_generated + i
        p = spec_probs(target_logits[i], params)
        q = draft_probs[i]
        dev = p.device
        u = torch.rand((), generator=tagged_generator(params, idx, ACCEPT_TAG,
                                                      dev), device=dev)
        if float(u) <= float(p[d] / torch.clamp(q[d], min=1e-20)):
            committed.append(d)
            continue
        residual = torch.clamp(p - q, min=0.0)
        total = residual.sum()
        # p == q exactly leaves an empty residual (and an accept ratio of
        # 1, so this is unreachable in exact arithmetic): fall back to p
        dist = (residual / torch.clamp(total, min=1e-20)
                if float(total) > 0 else p)
        committed.append(_categorical(
            dist, tagged_generator(params, idx, RESIDUAL_TAG, dev)))
        return i, committed
    # every draft accepted: the bonus token from the last scored position
    # on the plain sample() stream (the one a non-spec engine draws from)
    bonus = sample(target_logits[len(draft_tokens)], params,
                   n_generated + len(draft_tokens))
    committed.append(int(bonus))
    return len(draft_tokens), committed
