"""Deterministic open-loop load generator: the port of
``repro.serving.loadgen``.

An ``ArrivalTrace`` is a seeded, reproducible request schedule: prompts,
lengths, decode budgets and arrival ticks. Arrivals are open-loop, on the
tick-driven ``VirtualClock`` (one tick per scheduler step, busy or idle),
so saturation and admission control (queue growth, rejections) show.

``ArrivalTrace.generate`` draws from a seeded numpy generator, so its
traces are the port's own and not the JAX package's; ``from_requests``
builds a trace from given prompts and ticks (e.g. a JAX trace's) so both
engines can replay the same load.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.clock import VirtualClock
from repro_torch.models.config import ModelConfig
from repro_torch.serving.sampling import SamplingParams


@dataclasses.dataclass(frozen=True)
class TracedRequest:
    arrival_step: int                  # virtual-clock tick of arrival
    tokens: torch.Tensor               # [1, S] prompt (int64, host)
    max_new_tokens: int
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    priority: int = 0


@dataclasses.dataclass(frozen=True)
class ArrivalTrace:
    requests: Tuple[TracedRequest, ...]
    seed: int
    mean_interarrival: float

    def __len__(self) -> int:
        return len(self.requests)

    @property
    def offered_tokens(self) -> int:
        return sum(r.max_new_tokens for r in self.requests)

    # ------------------------------------------------------------------ #
    @classmethod
    def generate(cls, cfg: ModelConfig, n_requests: int, seed: int = 0,
                 mean_interarrival: float = 2.0,
                 prompt_len: Tuple[int, int] = (4, 16),
                 max_new: Tuple[int, int] = (4, 12),
                 sampling: Optional[SamplingParams] = None) -> "ArrivalTrace":
        """Poisson-process arrivals (exponential gaps by inverse CDF on
        seeded uniforms, floored to whole ticks) with uniformly drawn prompt
        lengths (inclusive range) and decode budgets. Request i draws from
        its own generator seeded with ``(seed, i)``."""
        reqs = []
        t = 0
        for i in range(n_requests):
            rng = np.random.default_rng([seed, i])
            u = float(rng.uniform(1e-6, 1.0))
            t += int(-mean_interarrival * math.log(u))
            s = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
            n = int(rng.integers(max_new[0], max_new[1] + 1))
            prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, s)))
            reqs.append(TracedRequest(t, prompt, n,
                                      sampling or SamplingParams()))
        return cls(tuple(reqs), seed, mean_interarrival)

    @classmethod
    def from_requests(cls, requests: Iterable, seed: int = 0,
                      mean_interarrival: float = 0.0) -> "ArrivalTrace":
        """A trace of given requests: each item has ``arrival_step``,
        ``tokens`` ([1, S], any array type numpy can read),
        ``max_new_tokens`` and optionally ``sampling`` / ``priority`` (a
        ``TracedRequest`` of either package qualifies). Sampling params
        come over by their fields; arrivals must not go back in time."""
        reqs = []
        for r in requests:
            sp = getattr(r, "sampling", None)
            sampling = (SamplingParams(sp.temperature, sp.top_k, sp.seed)
                        if sp is not None else SamplingParams())
            tokens = torch.from_numpy(np.asarray(r.tokens).astype(np.int64))
            reqs.append(TracedRequest(int(r.arrival_step), tokens,
                                      int(r.max_new_tokens), sampling,
                                      int(getattr(r, "priority", 0))))
        steps = [r.arrival_step for r in reqs]
        if steps != sorted(steps):
            raise ValueError("arrival steps must be non-decreasing")
        return cls(tuple(reqs), seed, mean_interarrival)


def replay(engine, trace: ArrivalTrace, max_ticks: int = 100_000,
           clock: Optional[VirtualClock] = None) -> Dict[str, float]:
    """Drive ``engine`` through ``trace`` on a virtual clock and return the
    stable metrics schema (``scheduler.METRIC_KEYS``) + trace metadata."""
    clock = clock or VirtualClock()
    reqs = []
    i = 0
    while (i < len(trace.requests) or engine.has_work) \
            and clock.ticks < max_ticks:
        while (i < len(trace.requests)
               and trace.requests[i].arrival_step <= clock.ticks):
            tr = trace.requests[i]
            reqs.append(engine.submit(tr.tokens, tr.max_new_tokens,
                                      sampling=tr.sampling,
                                      priority=tr.priority))
            i += 1
        engine.step()
        clock.tick()
    report = engine.metrics(reqs)
    report.update(
        trace_requests=len(trace.requests),
        trace_seed=trace.seed,
        trace_mean_interarrival=trace.mean_interarrival,
        offered_tokens=trace.offered_tokens,
        clock_ticks=clock.ticks,
    )
    return report
