"""Inference runtime: the port of ``repro.serving.engine``.

An ``InferenceSession`` wraps one artifact (params + config, any quant
variant) on one device, pinned to a kernel backend or not; a
``RequestQueue`` batches incoming requests up to ``max_batch`` per pump,
deterministically (no threads).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import decode_step, forward, prefill
from repro_torch.models.config import ModelConfig, check_supported
from repro_torch.models.layers import place_params
from repro_torch.serving.kvcache import bucketed_prefill_ok, pow2_bucket


def interpolated_percentile(xs: Sequence[float], p: float) -> float:
    """Linear-interpolated percentile over raw samples (numpy's default
    method); ``p`` is clamped to [0, 1] and an empty window gives 0.0."""
    if not xs:
        return 0.0
    p = min(max(p, 0.0), 1.0)
    s = sorted(xs)
    if len(s) == 1:
        return s[0]
    rank = p * (len(s) - 1)
    lo = int(rank)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (rank - lo)


@dataclasses.dataclass
class InferenceStats:
    calls: int = 0
    total_ms: float = 0.0
    latencies_ms: Optional[List[float]] = None

    def reset(self) -> None:
        self.calls = 0
        self.total_ms = 0.0
        self.latencies_ms = []

    def record(self, ms: float) -> None:
        self.calls += 1
        self.total_ms += ms
        if self.latencies_ms is None:
            self.latencies_ms = []
        self.latencies_ms.append(ms)

    @property
    def mean_ms(self) -> float:
        return self.total_ms / max(self.calls, 1)

    def percentile_ms(self, p: float) -> float:
        return interpolated_percentile(self.latencies_ms or [], p)


class InferenceSession:
    """One loaded artifact on one device. Entry points: ``logits()`` and
    ``generate()``. ``device=None`` means the card; with no card the
    session raises unless ``device='cpu'`` is passed.

    ``backend`` pins the session to a kernel backend of the registry
    (``repro_torch.api.backends``): every entry point runs under it, so one
    process can serve the same artifact through the ``cuda`` kernels on one
    session and the plain ``ref`` path on another. ``None`` binds ``ref``
    on the CPU and inherits the backend in scope (by default ``cuda``) on
    the card; a ``cuda`` pin on the CPU raises here."""

    def __init__(self, params, cfg: ModelConfig, backend=None,
                 device: DeviceLike = None):
        # local import: repro_torch.api imports the fleet stack, which
        # imports this module
        from repro_torch.api.backends import bind_for, get_backend

        check_supported(cfg)
        self.device = resolve_device(device)
        self.backend = get_backend(backend) if backend is not None else None
        self._bound = bind_for(self.backend, self.device)
        self.params = place_params(params, self.device)
        self.cfg = cfg
        self.stats = InferenceStats()

    @classmethod
    def from_artifact(cls, artifact, backend=None, device: DeviceLike = None
                      ) -> "InferenceSession":
        """Serve an ``api.ModelArtifact`` (any quant variant) on ``device``,
        pinned to ``backend`` if given."""
        return cls(artifact.params, artifact.config, backend=backend,
                   device=device)

    def _scope(self):
        from repro_torch.api.backends import use_backend

        return use_backend(self._bound)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _batch(self, batch: Dict[str, torch.Tensor]):
        return {k: v.to(self.device) for k, v in batch.items()}

    @torch.no_grad()
    def logits(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        batch = self._batch(batch)
        # repro: allow-wallclock -- stats measure real kernel wall time
        t0 = time.perf_counter()
        with self._scope():
            out = forward(self.params, batch, self.cfg)[0]
        self._sync()
        # repro: allow-wallclock -- interval vs t0 above (latency stats)
        self.stats.record((time.perf_counter() - t0) * 1e3)
        return out

    @torch.no_grad()
    def generate(self, batch: Dict[str, torch.Tensor], n_new: int):
        """Greedy decode ``n_new`` tokens after a prefill -> [B, n_new]
        (multi-codebook: [B, n_new, K], every codebook's argmax fed back).

        The cache is padded to the next power-of-two bucket >= prompt +
        n_new; where ``bucketed_prefill_ok`` allows, the prompt tokens are
        padded to their own bucket and the logits read at the true last
        position (``n_valid``)."""
        cfg = self.cfg
        batch = self._batch(batch)
        tok_len = batch["tokens"].shape[1] + cfg.n_frontend_tokens
        pad = pow2_bucket(tok_len + n_new)
        if bucketed_prefill_ok(cfg):
            tb = min(pow2_bucket(tok_len), pad) - cfg.n_frontend_tokens
            t = batch["tokens"]
            if t.shape[1] < tb:
                batch = dict(batch)
                batch["tokens"] = torch.nn.functional.pad(
                    t, (0, tb - t.shape[1]))
        with self._scope():
            last, cache = prefill(self.params, batch, cfg, pad_to=pad,
                                  n_valid=tok_len)
            # the next tokens [B, 1], or [B, 1, K] with K codebooks
            outs = []
            nxt = torch.argmax(last[:, -1:], dim=-1)
            for i in range(n_new):
                outs.append(nxt)
                logits, cache = decode_step(self.params, cache, nxt,
                                            tok_len + i, cfg)
                nxt = torch.argmax(logits[:, -1:], dim=-1)
        return torch.cat(outs, dim=1)


# --------------------------------------------------------------------- #
# Pipeline stages
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class Pipeline:
    """pre -> infer -> post, each a plain callable."""
    preprocess: Callable[[Any], Dict[str, torch.Tensor]]
    infer: Callable[[Dict[str, torch.Tensor]], torch.Tensor]
    postprocess: Callable[[torch.Tensor, Any], Any]

    def __call__(self, raw: Any) -> Any:
        batch = self.preprocess(raw)
        out = self.infer(batch)
        return self.postprocess(out, raw)


# --------------------------------------------------------------------- #
# Micro-batching request queue
# --------------------------------------------------------------------- #
@dataclasses.dataclass
class Request:
    rid: int
    payload: Any
    result: Any = None
    done: bool = False


def _stack(payloads: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: torch.cat([p[k] for p in payloads], dim=0)
            for k in payloads[0]}


class RequestQueue:
    def __init__(self, pipeline: Pipeline, max_batch: int = 8,
                 stack: Optional[Callable[[List[Any]], Any]] = None,
                 unstack: Optional[Callable[[Any, int], List[Any]]] = None):
        self.pipeline = pipeline
        self.max_batch = max_batch
        self._queue: deque[Request] = deque()
        self._next = 0
        # default: payloads are dicts of tensors -> concatenate on axis 0
        self._stack = stack or _stack
        self._unstack = unstack

    def submit(self, payload: Any) -> Request:
        req = Request(self._next, payload)
        self._next += 1
        self._queue.append(req)
        return req

    def pump(self) -> int:
        """Process one micro-batch; returns number of requests served."""
        if not self._queue:
            return 0
        reqs = [self._queue.popleft()
                for _ in range(min(self.max_batch, len(self._queue)))]
        results = self.pipeline(self._stack([r.payload for r in reqs]))
        if self._unstack:
            per = self._unstack(results, len(reqs))
        else:   # keep the batch dim: each requester gets its own row back
            per = [results[i:i + 1] for i in range(len(reqs))]
        for r, res in zip(reqs, per):
            r.result, r.done = res, True
        return len(reqs)

    def drain(self) -> None:
        while self._queue:
            self.pump()
