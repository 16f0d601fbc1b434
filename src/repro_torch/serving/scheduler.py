"""Continuous batching decode scheduler: the port of
``repro.serving.scheduler`` in its dense and paged modes.

A fixed pool of ``n_slots`` decode slots shares one batched KV cache; every
``step()`` decodes ALL occupied slots in one batched decode step with
per-slot positions. Finished sequences free their slot at once, so new
requests join mid-flight.

* Chunked prefill: only the first ``prefill_chunk`` prompt tokens run
  through the batch-1 prefill; the rest of the prompt rides the batched
  decode step, one token per tick. ``prefill_chunk=0`` prefills whole
  prompts in one shot.
* Per-request ``SamplingParams``, seeded per token index; per-slot EOS;
  streaming through ``on_token``; priority admission and
  ``max_queue_depth`` rejection, all visible in ``metrics()``.
* ``paged=True``: K/V live in a block pool behind a ``BlockAllocator``
  (``repro_torch.serving.kvcache``). Admission is by free blocks; full
  prompt blocks found in the prefix registry are attached without
  recompute; cold prompts prefill their full-block prefix straight into
  fresh blocks and register its hashes; when the pool runs dry the
  youngest lowest-priority request is preempted and later resumes by
  re-prefilling prompt + generated tokens.

On the hot loop ``positions`` and ``last_tokens`` are device tensors
updated in place, and each step takes one ``.tolist()`` of the batched
argmax (one stream sync per step, not one per slot).

* ``spec=SpecConfig(...)``: speculative decoding. A draft model proposes
  ``k`` tokens per step from its own dense per-slot cache (last row: a
  scratch position for idle slots); the target scores all ``k+1``
  positions in one ``verify_step`` / ``verify_step_paged`` pass and the
  engine commits the longest agreed prefix plus one target token. Greedy
  output is the target's ``generate`` token for token; sampled requests
  use seeded rejection sampling (``serving.spec_decode``). Dense caches
  roll back by position alone; paged engines also free tail blocks that
  held only rejected tokens (``PagedKVCache.truncate``). Prompt feeds
  (chunked-prefill and prefix-hit tails, preemption resume) ride the
  verify pass, up to ``k+1`` tokens a step.

The dense mode also holds the recurrent models' states (Mamba2's SSM and
conv states, RG-LRU's ``h`` and conv state, beside a sliding window's ring
cache): a slot's states are overwritten whole at admission, so an idle
slot's decode leaks nothing into the next request. ``paged=True`` and
``spec=`` refuse them with the JAX package's reasons.

* Frontend requests (``submit(frontend_embeds=)``: phi-3-vision's patches,
  musicgen's conditioning frames) put the projected embeddings in front of
  the prompt's first chunk: cache positions count the ``n_frontend_tokens``
  rows, and the paged engine hashes no prompt block of a frontend model.
  Multi-codebook models (musicgen) take ``[1, S, K]`` prompts and emit a
  ``[K]`` token a step (``last_tokens`` is ``[n_slots, 1, K]``), dense
  engine only, with per-codebook EOS tuples.
* Disaggregated serving (``shared_kv=SharedKVPool``): paged engines on one
  store, a prefill worker (``submit_prefill``: the prompt's KV plus one
  token, exported as a ``KVHandoff``) and decode workers
  (``submit_handoff``: the blocks attach to a slot, nothing recomputed).
  ``serving.router`` places requests on such workers.
* Tensor-parallel serving (``tp=N``, or ``EngineConfig(tp=N)``): the model
  entry points are a ``serving.sharded.TPContext``'s, which run every shard
  on its own thread. ``params`` and the cache (``kv.shard_pools`` when
  paged) are lists of per-shard trees at every tp (one tree at tp=1), and
  every host-side structure (slots, tables, the allocator) stays one.
  ``tp_combine`` is "exact" (all-gather, the tp=1 contraction) or "psum"
  (row-parallel ``wo``, an all-reduce). A speculative engine's draft
  stays unsharded, on shard 0's device.
"""
from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import (decode_step, decode_step_paged, init_cache,
                                prefill, prefill_paged, verify_step,
                                verify_step_paged)
from repro_torch.models.config import ModelConfig, check_supported
from repro_torch.models.layers import place_params
from repro_torch.models.transformer import layer_caches
from repro_torch.serving.engine import InferenceSession, interpolated_percentile
from repro_torch.serving.kvcache import (KVHandoff, PagedKVCache,
                                         SharedKVPool, blocks_for_budget,
                                         bucketed_prefill_ok,
                                         hash_prompt_blocks, kv_shard_divisor,
                                         paged_supported, pow2_bucket)
from repro_torch.serving.sampling import SamplingParams, sample
from repro_torch.serving.sharded import TPContext, shard_devices
from repro_torch.serving.spec_decode import (SpecConfig, draft_propose,
                                             greedy_accept, rejection_sample,
                                             spec_supported)

#: every metrics() call returns exactly these keys (the JAX package's
#: schema, so reports built on either engine line up)
METRIC_KEYS = (
    "completed", "rejected", "queued", "active", "submitted",
    "decode_steps", "generated_tokens", "prefill_tokens",
    "mean_ttft_s", "p50_ttft_s", "p90_ttft_s", "p99_ttft_s",
    "mean_latency_s", "throughput_tok_s",
    # paged KV cache (zero for dense engines unless noted)
    "preempted",                 # requests evicted back to the queue
    "cancelled",                 # requests withdrawn via cancel()
    "prefix_hit_tokens",         # prompt tokens served from cached blocks
    "prefix_hit_rate",           # hit tokens / submitted prompt tokens
    "prompt_tokens_computed",    # prompt tokens actually recomputed
    "kv_blocks_peak",            # allocator high-water mark (paged)
    "kv_hbm_bytes_per_req",      # peak cache bytes / n_slots (dense + paged)
    # tensor-parallel serving (== kv_hbm_bytes_per_req when tp == 1)
    "tp",                        # shards of this engine
    "kv_hbm_bytes_per_req_per_shard",  # one shard's share of the KV bytes
    # speculative decoding (zero for non-spec engines)
    "spec_events",               # per-slot draft/verify acceptance rounds
    "spec_draft_tokens",         # draft tokens proposed
    "spec_accepted_tokens",      # draft tokens accepted AND committed
    "acceptance_rate",           # accepted / proposed draft tokens
    "accepted_tokens_per_step",  # committed tokens per verify round
)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine-level knobs that travel as one value (fleet profiles, bench
    configs): ``ContinuousBatchingEngine(..., config=EngineConfig(tp=2))``
    shards the model with no call-site changes, and
    ``EngineConfig(backend="cuda-tp")`` pins a backend twin that shards at
    its ``default_tp``; explicit keyword arguments win over the config's
    fields."""
    tp: int = 1                    # shards (1 = unsharded)
    tp_combine: str = "exact"      # "exact" (all-gather) | "psum"
    backend: Optional[str] = None  # kernel backend name to pin


@dataclasses.dataclass
class GenRequest:
    rid: int
    tokens: torch.Tensor               # [1, S_prompt] ([1, S, K] codebooks)
    max_new_tokens: int
    frontend_embeds: Optional[torch.Tensor] = None  # [1, n_frontend, dim]
    eos_id: Union[int, Sequence[int]] = -1   # -1: no EOS; tuple: per-codebook
    out_tokens: Optional[List[int]] = None
    done: bool = False
    submitted_at: float = 0.0
    first_token_at: float = 0.0
    finished_at: float = 0.0
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    priority: int = 0
    on_token: Optional[Callable[["GenRequest", int], None]] = None
    status: str = "queued"   # queued|rejected|cancelled|prefill|decode|done
    n_consumed: int = 0                # feed tokens already in the cache
    # disaggregated serving (paged engines on one SharedKVPool)
    capture_kv: bool = False           # prefill worker: export blocks on done
    kv_handoff: Optional[KVHandoff] = None      # the exported handoff
    _handoff: Optional[KVHandoff] = None        # incoming handoff to consume
    # paged engines
    prefix_hit: int = 0                # prompt tokens attached from cache
    preemptions: int = 0
    cache_pos: int = 0                 # next cache write position (host int)
    _admit_tokens: Optional[torch.Tensor] = None   # resume feed (prompt + gen)
    _resume_last: Optional[int] = None  # last generated token pre-preemption
    _block_hashes: Optional[List[int]] = None      # feed hash chain (cached)
    # speculative decoding (spec engines only)
    spec_events: int = 0               # verify rounds this request ran
    spec_accepted: int = 0             # draft tokens accepted + committed
    # committed tokens the draft cache still lacks: normally [last]; two
    # right after a fully accepted round emitted a bonus token
    _spec_pending: Optional[List[int]] = None

    @property
    def prompt_len(self) -> int:
        return self.tokens.shape[1]

    @property
    def feed_tokens(self) -> torch.Tensor:
        """Tokens driving prefill / decode-tail: the original prompt, or
        prompt + already-generated tokens after a preemption resume."""
        return (self._admit_tokens if self._admit_tokens is not None
                else self.tokens)

    @property
    def feed_len(self) -> int:
        return self.feed_tokens.shape[1]

    @property
    def rejected(self) -> bool:
        return self.status == "rejected"


def _hits_eos(token, eos_id) -> bool:
    """token: int or [K] list; eos_id: -1 (never), int (codebook 0), or a
    per-codebook sequence (all codebooks must match)."""
    if isinstance(eos_id, (list, tuple)):
        toks = token if isinstance(token, list) else [token]
        return len(toks) == len(eos_id) and all(
            t == e for t, e in zip(toks, eos_id))
    if eos_id < 0:
        return False
    first = token[0] if isinstance(token, list) else token
    return first == eos_id


def _under(backend, fn):
    """``fn`` run under ``backend`` (``use_backend``) at every call; ``fn``
    itself where there is nothing to bind (None: the backend in scope)."""
    if backend is None:
        return fn
    from repro_torch.api.backends import use_backend

    def call(*args):
        with use_backend(backend):
            return fn(*args)

    return call


def _tree_insert(batched, single, slot: int) -> None:
    """Copy a batch-1 cache (per-layer leaves ``[1, S, ...]``) into slot
    ``slot`` of the batched cache, in place."""
    for leaves, new in zip(layer_caches(batched), layer_caches(single)):
        for c, c1 in zip(leaves, new):
            c[slot:slot + 1].copy_(c1)


class ContinuousBatchingEngine:
    """``model`` is a port ``InferenceSession`` (its device and pinned
    backend are inherited unless ``device`` / ``backend`` are given) or a
    params tree with ``cfg`` passed separately. ``device=None`` means the
    card: with no card the engine raises unless ``device='cpu'`` is passed.

    ``backend`` pins a kernel backend of the registry
    (``repro_torch.api.backends``) for every prefill, decode and verify
    call; the draft of a speculative engine runs under
    ``SpecConfig.draft_backend`` (default: the draft session's, else the
    engine's). A pinned ``*-tp`` backend shards the engine at its
    ``default_tp`` when ``tp`` is 1, and an explicit ``tp > 1`` swaps a
    pinned backend for its ``*-tp`` twin. Unpinned, the engine binds
    ``ref`` on the CPU and inherits the backend in scope on the card."""

    def __init__(self, model, cfg: Optional[ModelConfig] = None,
                 n_slots: int = 4, max_len: int = 512, *,
                 backend=None, prefill_chunk: int = 0,
                 max_queue_depth: int = 0,
                 paged: bool = False, block_size: int = 16,
                 n_blocks: Optional[int] = None,
                 kv_budget_bytes: Optional[int] = None,
                 spec: Optional[SpecConfig] = None, tp: int = 1,
                 tp_combine: str = "exact",
                 shared_kv: Optional[SharedKVPool] = None,
                 config: Optional[EngineConfig] = None,
                 device: DeviceLike = None):
        # local import: repro_torch.api imports the fleet stack, which
        # imports serving
        from repro_torch.api.backends import (TPBackend, available_backends,
                                              bind_for, get_backend)

        if config is not None:
            tp = config.tp if tp == 1 else tp
            if tp_combine == "exact":
                tp_combine = config.tp_combine
            if backend is None:
                backend = config.backend
        if shared_kv is not None and not paged:
            raise ValueError("shared_kv requires paged=True")
        if isinstance(model, InferenceSession):
            params, cfg = model.params, model.cfg
            if device is None:
                device = model.device
            if backend is None:
                backend = model.backend
        elif cfg is None:
            raise TypeError("ContinuousBatchingEngine(params, cfg) requires a "
                            "ModelConfig when given a raw params tree")
        else:
            params = model
        check_supported(cfg)
        if cfg.window and max_len < cfg.window:
            # the dense ring cache holds exactly `window` slots after a
            # prefill; a shorter engine cache could not take it in
            raise ValueError(
                f"max_len {max_len} is below {cfg.name}'s sliding window "
                f"{cfg.window}: a windowed model's engine needs max_len >= "
                "window (its ring cache holds window slots)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.backend = get_backend(backend) if backend is not None else None
        if isinstance(self.backend, TPBackend) and tp == 1:
            tp = self.backend.default_tp
        if tp > 1 and self.backend is not None \
                and not isinstance(self.backend, TPBackend):
            twin = f"{self.backend.name}-tp"
            if twin in available_backends():
                self.backend = get_backend(twin)
        self._bound = bind_for(self.backend, self.device)
        self.tp = tp
        if tp > 1:
            # the shards: shard 0 on the engine's device, the draft beside
            # it; params become one tree per shard
            self._tp_ctx: Optional[TPContext] = TPContext(
                cfg, tp, combine=tp_combine, params=params,
                devices=shard_devices(tp, self.device))
            self.params = self._tp_ctx.shard_params(params)
        else:
            self._tp_ctx = None
            self.params = [place_params(params, self.device)]
        self.n_slots = n_slots
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.max_queue_depth = max_queue_depth
        self.paged = paged
        self.spec = spec
        self.spec_k = 0
        self._spec_m = 1               # verify span (k + 1) for spec engines
        if spec is not None:
            draft_params, draft_cfg, draft_dev, draft_backend = \
                spec.resolve_draft()
            why = spec_supported(cfg, draft_cfg, spec.k,
                                 allow_moe_target=spec.allow_moe_target)
            if why is not None:
                raise ValueError(f"speculative decoding unsupported: {why}")
            check_supported(draft_cfg)
            if draft_dev is not None and draft_dev != self.device:
                raise ValueError(f"the draft session is on {draft_dev}, the "
                                 f"engine on {self.device}")
            self.spec_k = spec.k
            self._spec_m = spec.k + 1
            self.draft_params = place_params(draft_params, self.device)
            self.draft_cfg = draft_cfg
            self.draft_backend = (get_backend(draft_backend)
                                  if draft_backend is not None
                                  else self.backend)
            draft_bound = bind_for(self.draft_backend, self.device)
        # cache length: max_len plus the verify span's headroom, so
        # speculative writes near the sequence cap never clamp into valid
        # rows
        self._pad_len = max_len + (self._spec_m if spec is not None else 0)
        dev = self.device
        self.positions = torch.zeros((n_slots,), dtype=torch.int64, device=dev)
        k = cfg.n_codebooks
        self.last_tokens = torch.zeros(
            (n_slots, 1, k) if k > 1 else (n_slots, 1), dtype=torch.int64,
            device=dev)
        self.active: List[Optional[GenRequest]] = [None] * n_slots
        self._pending: List[Tuple[int, int, GenRequest]] = []  # heap
        self.all_requests: List[GenRequest] = []
        self._next_rid = 0
        self.steps = 0
        self.rejected_total = 0
        self.prefill_tokens = 0        # prompt tokens processed by prefill
        self.preempted_total = 0
        self.cancelled_total = 0
        self.prefix_hit_tokens = 0
        self.prompt_tokens_computed = 0
        self.prompt_tokens_submitted = 0
        self.spec_events = 0           # per-slot verify acceptance rounds
        self.spec_committed = 0        # tokens committed by those rounds
        self.draft_proposed = 0
        self.draft_accepted = 0
        if spec is not None:
            # the draft keeps a dense per-slot cache even under a paged
            # target; its last row is a scratch position where idle and
            # prefilling slots' batched draft writes land harmlessly
            self.draft_cache = init_cache(self.draft_cfg, n_slots,
                                          self._pad_len, device=dev)
            self.draft_positions = torch.zeros((n_slots,), dtype=torch.int64,
                                               device=dev)
            self._draft_trash = self._pad_len - 1
            dcfg, pad_to = self.draft_cfg, self._pad_len
            self._draft_prefill = _under(draft_bound, lambda p, b, nv: prefill(
                p, b, dcfg, pad_to=pad_to, n_valid=nv))
            self._draft_decode = _under(draft_bound, lambda p, c, t, pos:
                                        decode_step(p, c, t, pos, dcfg))
        if paged:
            why = paged_supported(cfg)
            if why is not None:
                raise ValueError(
                    f"paged=True unsupported for {cfg.name}: {why} "
                    "(use the dense compat path)")
            if shared_kv is not None:
                # block ids are shared with the peer engines, so the
                # geometry comes from the store, not these arguments
                if shared_kv.shards != self.tp:
                    raise ValueError(
                        f"shared pool built for shards={shared_kv.shards}, "
                        f"engine has tp={self.tp}")
                block_size = shared_kv.block_size
                n_blocks = shared_kv.alloc.n_blocks
            max_blocks = -(-self._pad_len // block_size)
            if n_blocks is None:
                if kv_budget_bytes is not None:
                    # budget-sized pool, capped at what n_slots max-length
                    # sequences could ever touch. The budget is per
                    # device: under tp each shard holds only its kv-head
                    # slice of a block, so it admits more blocks (MLA
                    # pools are whole on every shard)
                    n_blocks = min(blocks_for_budget(cfg, block_size,
                                                     kv_budget_bytes,
                                                     shards=self.tp),
                                   n_slots * max_blocks + 1)
                else:
                    n_blocks = n_slots * max_blocks + 1
            self.kv: Optional[PagedKVCache] = PagedKVCache(
                cfg, n_slots, n_blocks, block_size, max_blocks,
                shards=self.tp,
                pool_sharding=(self._tp_ctx.shard_cache
                               if self._tp_ctx is not None else None),
                shared=shared_kv, device=dev)
            self.cache = self.kv.shard_pools    # alias: pools ARE the cache
        else:
            self.kv = None
            split = (self._tp_ctx.shard_cache if self._tp_ctx is not None
                     else lambda tree: [tree])
            self.cache = split(init_cache(cfg, n_slots, self._pad_len,
                                          device=dev))
        self._bind_entry_points()

    def _bind_entry_points(self) -> None:
        """The target's model entry points, with the scheduler's calling
        conventions: per-shard lists of params and caches in, the logits
        and the list of caches out. With tp > 1 they are the
        ``TPContext``'s; at tp=1 the model functions on the one tree. Each
        runs under the engine's backend (``_under``)."""
        # locals only: a closure over self would make a cycle that keeps
        # a dropped engine's shards alive until the collector runs
        tpx, cfg, pad_to = self._tp_ctx, self.cfg, self._pad_len
        if tpx is not None:
            fns = {"decode": tpx.decode_step, "verify": tpx.verify_step,
                   "decode_paged": tpx.decode_step_paged,
                   "verify_paged": tpx.verify_step_paged,
                   "prefill_paged": tpx.prefill_paged,
                   "prefill": lambda p, b, nv: tpx.prefill(
                       p, b, nv, pad_to=pad_to)}
        else:
            def one(out):
                return out[0], [out[1]]

            fns = {"decode": lambda p, c, t, pos: one(decode_step(
                       p[0], c[0], t, pos, cfg)),
                   "verify": lambda p, c, t, pos: one(verify_step(
                       p[0], c[0], t, pos, cfg)),
                   "decode_paged": lambda p, c, t, pos, tabs: one(
                       decode_step_paged(p[0], c[0], t, pos, tabs, cfg)),
                   "verify_paged": lambda p, c, t, pos, tabs: one(
                       verify_step_paged(p[0], c[0], t, pos, tabs, cfg)),
                   "prefill_paged": lambda p, c, b, nv, tabs: one(
                       prefill_paged(p[0], c[0], b, nv, tabs, cfg)),
                   "prefill": lambda p, b, nv: one(prefill(
                       p[0], b, cfg, pad_to=pad_to, n_valid=nv))}
        for name, fn in fns.items():
            setattr(self, f"_{name}", _under(self._bound, fn))

    # ---------------------------------------------------------------- #
    @property
    def queue_depth(self) -> int:
        # cancelled requests stay heap entries until _admit drops them
        return sum(1 for _, _, r in self._pending if r.status != "cancelled")

    @property
    def has_work(self) -> bool:
        return (any(r.status != "cancelled" for _, _, r in self._pending)
                or any(r is not None for r in self.active))

    def warmup(self, prompt_len: int = 0, max_new_tokens: int = 2) -> None:
        """Serve one throwaway request, then reset every counter (and, when
        paged, the allocator), so measurements start cold. ``prompt_len``
        defaults to the prefill chunk size."""
        s = prompt_len or self.prefill_chunk or 8
        k = self.cfg.n_codebooks
        self.submit(torch.zeros((1, s, k) if k > 1 else (1, s),
                                dtype=torch.int64), max_new_tokens)
        self.run()
        self.all_requests.clear()
        self.steps = 0
        self.prefill_tokens = 0
        self.rejected_total = 0
        self.preempted_total = 0
        self.cancelled_total = 0
        self.prefix_hit_tokens = 0
        self.prompt_tokens_computed = 0
        self.prompt_tokens_submitted = 0
        self.spec_events = 0
        self.spec_committed = 0
        self.draft_proposed = 0
        self.draft_accepted = 0
        if self.paged:
            self.kv.reset()

    # ---------------------------------------------------------------- #
    def submit(self, tokens, max_new_tokens: int = 16, frontend_embeds=None,
               eos_id: Union[int, Sequence[int]] = -1,
               sampling: Optional[SamplingParams] = None, priority: int = 0,
               on_token: Optional[Callable] = None) -> GenRequest:
        """Queue a request (``tokens`` [1, S], or [1, S, K] for a K-codebook
        model; any int tensor or array). ``frontend_embeds`` ([1,
        n_frontend_tokens, frontend_dim]) condition a frontend model.
        Higher ``priority`` admits first (FIFO within a level). When the
        queue already holds ``max_queue_depth`` requests the submission is
        REJECTED: ``req.status == "rejected"``, never scheduled, counted in
        ``metrics()["rejected"]``."""
        tokens = torch.as_tensor(tokens).to(device=self.device,
                                            dtype=torch.int64)
        k = self.cfg.n_codebooks
        if tokens.dim() != (3 if k > 1 else 2) or tokens.shape[0] != 1 \
                or (k > 1 and tokens.shape[2] != k):
            raise ValueError(f"tokens must be {'[1, S, K]' if k > 1 else '[1, S]'}"
                             f" (K = {k}), got {tuple(tokens.shape)}")
        if frontend_embeds is not None:
            frontend_embeds = torch.as_tensor(frontend_embeds).to(self.device)
        req = GenRequest(self._next_rid, tokens, max_new_tokens,
                         frontend_embeds, eos_id, out_tokens=[],
                         # repro: allow-wallclock -- TTFT/e2e measure real compute
                         submitted_at=time.perf_counter(),
                         sampling=sampling or SamplingParams(),
                         priority=priority, on_token=on_token)
        self._next_rid += 1
        self.all_requests.append(req)
        if self.max_queue_depth and len(self._pending) >= self.max_queue_depth:
            req.status = "rejected"
            self.rejected_total += 1
            return req
        if self.paged:
            # memory-based admission: a request that could NEVER fit the
            # pool (even alone, every cached block evicted) is rejected now
            total = (self.cfg.n_frontend_tokens + req.prompt_len
                     + max_new_tokens)
            if (total > self.max_len
                    or self.kv.blocks_for_tokens(total) + 1
                    > self.kv.alloc.usable_blocks):
                req.status = "rejected"
                self.rejected_total += 1
                return req
        self.prompt_tokens_submitted += req.prompt_len
        heapq.heappush(self._pending, (-priority, req.rid, req))
        return req

    # ---------------------------------------------------------------- #
    # Disaggregated serving entry points (paged engines on a SharedKVPool)
    # ---------------------------------------------------------------- #
    def submit_prefill(self, tokens, sampling: Optional[SamplingParams] = None,
                       priority: int = 0,
                       on_token: Optional[Callable] = None) -> GenRequest:
        """Queue a prompt on a *prefill worker*: the engine computes the
        prompt's paged KV plus exactly one generated token, then exports
        the blocks as ``req.kv_handoff`` for a decode worker on the same
        pool instead of dropping them. Every full prompt block is also
        hash-registered, so the prefix stays as cache even if the handoff
        is never consumed."""
        if not self.paged:
            raise ValueError("submit_prefill requires a paged engine")
        if self.spec is not None:
            raise ValueError("prefill workers do not run speculative decode")
        if self.cfg.n_frontend_tokens:
            raise ValueError("frontend-token archs cannot hash prompt blocks")
        req = self.submit(tokens, max_new_tokens=1, eos_id=-1,
                          sampling=sampling, priority=priority,
                          on_token=on_token)
        if not req.rejected:
            req.capture_kv = True
        return req

    def submit_handoff(self, handoff: KVHandoff, max_new_tokens: int = 16,
                       eos_id: Union[int, Sequence[int]] = -1,
                       sampling: Optional[SamplingParams] = None,
                       priority: int = 0,
                       on_token: Optional[Callable] = None) -> GenRequest:
        """Queue a prefilled request on a *decode worker*: ``handoff`` came
        from a peer engine's ``submit_prefill`` on the same
        ``SharedKVPool``, so the prompt's blocks attach to a slot with no
        recompute and decoding resumes from the token already sampled.

        Ownership: an ACCEPTED request takes the handoff's block references
        (released when it finishes or is cancelled). A REJECTED submission
        leaves them with the caller, who re-dispatches the handoff to
        another worker or releases it."""
        if not self.paged:
            raise ValueError("submit_handoff requires a paged engine")
        if handoff.consumed:
            raise ValueError("handoff already consumed or released")
        req = GenRequest(self._next_rid, handoff.tokens, max_new_tokens,
                         None, eos_id, out_tokens=[],
                         # repro: allow-wallclock -- TTFT/e2e measure real compute
                         submitted_at=time.perf_counter(),
                         sampling=sampling or SamplingParams(),
                         priority=priority, on_token=on_token)
        self._next_rid += 1
        self.all_requests.append(req)
        if self.max_queue_depth and self.queue_depth >= self.max_queue_depth:
            req.status = "rejected"
            self.rejected_total += 1
            return req
        total = req.prompt_len + max_new_tokens
        if (total > self.max_len
                or self.kv.blocks_for_tokens(total) + 1
                > self.kv.alloc.usable_blocks
                # KV pressure: the shared pool cannot give even one block of
                # decode headroom now, so reject rather than queue work this
                # worker cannot start (the router re-dispatches)
                or self.kv.alloc.available() < 1):
            req.status = "rejected"
            self.rejected_total += 1
            return req
        self.prompt_tokens_submitted += req.prompt_len
        req._handoff = handoff
        # the prefill worker sampled the first token: record it here, so
        # streaming callbacks and the EOS / budget checks see it once
        self._record(req, handoff.first_token)
        if req.done:
            # max_new_tokens == 1 or the first token IS the EOS: nothing to
            # decode, so consume the handoff without taking a slot
            req._handoff = None
            handoff.release(self.kv.alloc)
            return req
        heapq.heappush(self._pending, (-priority, req.rid, req))
        return req

    def cancel(self, req: GenRequest) -> bool:
        """Withdraw an unfinished request. Queued entries are marked and
        lazily dropped from the heap; active ones release their slot (and
        blocks, in paged mode). A queued handoff request also releases the
        handoff's blocks, which the engine took at submit: otherwise every
        router-side cancel would leak pool blocks."""
        if req.done or req.status in ("rejected", "cancelled"):
            return False
        if req._handoff is not None:
            req._handoff.release(self.kv.alloc)
            req._handoff = None
        req.status = "cancelled"
        slot = next((i for i, r in enumerate(self.active) if r is req), None)
        if slot is not None:
            self._release(slot)
        self.cancelled_total += 1
        return True

    # ---------------------------------------------------------------- #
    def _admit(self) -> None:
        """Prefill the first chunk of pending requests into free slots."""
        for slot in range(self.n_slots):
            if self.active[slot] is not None:
                continue
            while self._pending and self._pending[0][2].status == "cancelled":
                heapq.heappop(self._pending)     # lazily drop cancellations
            if not self._pending:
                continue
            if self.paged:
                if not self._admit_paged(slot):
                    break        # pool cannot take the head request yet
            else:
                _, _, req = heapq.heappop(self._pending)
                self._admit_dense(slot, req)

    def _pad_tokens(self, batch: dict, cfg: ModelConfig, total: int) -> dict:
        """Bucket-pad the token axis to a power of two (capped at the cache
        length), as the JAX engine does to share compiled prefills.
        ``total`` counts the frontend rows; the padded tokens plus them
        never exceed the cache (``_pad_len``)."""
        if not bucketed_prefill_ok(cfg):
            return batch
        tb = min(pow2_bucket(total), self._pad_len) - cfg.n_frontend_tokens
        t = batch["tokens"]
        if t.shape[1] < tb:
            batch = dict(batch)
            batch["tokens"] = torch.nn.functional.pad(t, (0, tb - t.shape[1]))
        return batch

    def _admit_dense(self, slot: int, req: GenRequest) -> None:
        s = req.prompt_len
        chunk = min(self.prefill_chunk, s) if self.prefill_chunk else s
        batch = {"tokens": req.tokens[:, :chunk]}
        if req.frontend_embeds is not None:
            # frontend embeds are put in front, so they ride the first chunk
            batch["frontend_embeds"] = req.frontend_embeds
        n_valid = chunk + self.cfg.n_frontend_tokens
        batch = self._pad_tokens(batch, self.cfg, n_valid)
        last, single = self._prefill(self.params, batch, n_valid)
        for cache, new in zip(self.cache, single):
            _tree_insert(cache, new, slot)
        self.positions[slot] = n_valid
        req.n_consumed = chunk
        self.prefill_tokens += chunk
        self.prompt_tokens_computed += chunk
        self.active[slot] = req
        if self.spec is not None:
            self._admit_draft(slot, req)
        if chunk == s:
            # whole prompt in cache: prefill logits give the first token
            nxt = sample(last[0, -1], req.sampling, 0)
            req.status = "decode"
            self._record(req, nxt)
            self._set_last(slot, nxt)
            if req.done:        # max_new_tokens=1 / EOS on the first token
                self._release(slot)
        else:
            # chunked: the rest of the prompt rides the batched decode step
            req.status = "prefill"
            self._set_last(slot, self._prompt_token(req, chunk))

    def _admit_paged(self, slot: int) -> bool:
        """Admission by free blocks (head of the priority queue only).

        Prefix hits attach the cached full prompt blocks (refcount bump, no
        recompute) and the tail rides the batched decode step. Cold prompts
        prefill their full-block prefix straight into fresh blocks and
        register the hashes; the sub-block tail rides decode, so a later
        hit replays the cold run's numerics. A *partial* hit whose uncached
        remainder is longer than 2 blocks is demoted to the cold path (one
        batched prefill, and the longer chain gets registered). A frontend
        model hashes nothing (its blocks hold the frontend rows first), and
        its cold prefill puts them in front of the prompt's chunk. A
        queued handoff attaches its blocks instead (``_admit_handoff``).
        Returns False (head stays queued) when the pool cannot supply the
        blocks; that probe leaves the allocator unchanged."""
        kv = self.kv
        bs = kv.block_size
        nf = self.cfg.n_frontend_tokens
        req = self._pending[0][2]
        if req._handoff is not None:
            return self._admit_handoff(slot, req)
        tokens = req.feed_tokens
        s = tokens.shape[1]
        hashing = req.frontend_embeds is None and nf == 0
        n_hit = cached_hits = 0
        hashes: List[int] = []
        if hashing:
            if req._block_hashes is None:      # one host sync per admission
                req._block_hashes = hash_prompt_blocks(tokens[0].tolist(), bs)
            hashes = req._block_hashes
            for h in hashes[:(s - 1) // bs]:   # always recompute >= 1 token
                bid = kv.alloc.peek(h)
                if bid is None:
                    break
                n_hit += 1
                if kv.alloc.refcount(bid) == 0:
                    cached_hits += 1           # revival consumes a cached slot
            if n_hit and s - n_hit * bs > 2 * bs:
                n_hit = cached_hits = 0        # long remainder: go cold
        hit = n_hit * bs
        if hit:
            chunk = 0                          # tail rides decode from `hit`
            cache_tokens = hit
        else:
            chunk = ((s - 1) // bs) * bs or s  # full-block prefix (or tiny)
            cache_tokens = nf + chunk
        needed = kv.blocks_for_tokens(cache_tokens) - n_hit
        if kv.alloc.available() - cached_hits < needed + 1:  # +1: decode block
            return False
        heapq.heappop(self._pending)
        for h in hashes[:n_hit]:
            kv.attach(slot, kv.alloc.lookup(h))
        req.prefix_hit += hit
        self.prefix_hit_tokens += hit
        last = None
        if chunk:
            # allocate the prompt's blocks first (the check above guarantees
            # them), then prefill writes K/V straight into the pools
            while (len(kv.slot_blocks[slot])
                   < kv.blocks_for_tokens(cache_tokens)):
                kv.grow(slot)
            batch = {"tokens": tokens[:, :chunk]}
            if req.frontend_embeds is not None:
                batch["frontend_embeds"] = req.frontend_embeds
            batch = self._pad_tokens(batch, self.cfg, cache_tokens)
            last, _ = self._prefill_paged(self.params, kv.shard_pools, batch,
                                          cache_tokens,
                                          kv.tables[slot:slot + 1])
            if hashing:
                for i in range(chunk // bs):
                    kv.alloc.register(kv.slot_blocks[slot][i], hashes[i])
            self.prefill_tokens += chunk
            # a resume feed appends generated tokens: only the true prompt
            # portion counts as prompt recompute
            self.prompt_tokens_computed += min(chunk, req.prompt_len)
        self.positions[slot] = cache_tokens
        req.cache_pos = cache_tokens
        req.n_consumed = hit or chunk
        self.active[slot] = req
        if self.spec is not None:
            self._admit_draft(slot, req)
        if req.n_consumed == s:
            # whole feed in cache (tiny cold prompt): prefill logits give
            # the next token, or the pre-preemption token on resume
            req.status = "decode"
            if req._resume_last is not None:
                self._set_last(slot, req._resume_last)
                req._resume_last = None
            else:
                nxt = sample(last[0, -1], req.sampling, 0)
                self._record(req, nxt)
                self._set_last(slot, nxt)
                if req.done:    # max_new_tokens=1 / EOS on the first token
                    self._release(slot)
        else:
            req.status = "prefill"
            self._set_last(slot, self._prompt_token(req, req.n_consumed))
        return True

    def _admit_handoff(self, slot: int, req: GenRequest) -> bool:
        """Admit a prefilled handoff: attach the peer engine's blocks to
        this slot's table (the handoff's references move over: no
        recompute, no refcount change) and decode from the first token the
        prefill worker sampled. One available block of decode headroom is
        required, so the next ``_ensure_blocks`` cannot preempt the request
        just admitted."""
        kv = self.kv
        if kv.alloc.available() < 1:
            return False
        heapq.heappop(self._pending)
        h = req._handoff
        req._handoff = None
        # ownership was taken at submit; a handoff consumed while queued
        # means a caller submitted it twice: refcounts would be corrupt
        assert not h.consumed, "handoff consumed while queued"
        h.consumed = True
        kv.import_blocks(slot, h.block_ids)
        self.positions[slot] = h.cache_pos
        req.cache_pos = h.cache_pos
        req.n_consumed = req.prompt_len
        req.prefix_hit += h.cache_pos          # served from the pool, not
        self.prefix_hit_tokens += h.cache_pos  # recomputed by this engine
        self.active[slot] = req
        if self.spec is not None:
            self._admit_draft(slot, req)
        req.status = "decode"
        self._set_last(slot, h.first_token)
        return True

    def _capture_handoff(self, slot: int, req: GenRequest) -> KVHandoff:
        """Export a finished prefill request's blocks for a decode worker.
        Registers every FULL prompt block under the prompt's hash chain
        (the cold prefill registered only the chain before the tail; the
        last full block may have been filled by decode ticks), then retains
        each block so they all outlive this slot's release."""
        kv = self.kv
        hashes = (req._block_hashes if req._block_hashes is not None
                  else hash_prompt_blocks(req.tokens[0].tolist(),
                                          kv.block_size))
        for i, h in enumerate(hashes):
            kv.alloc.register(kv.slot_blocks[slot][i], h)
        return KVHandoff(tokens=req.tokens, first_token=req.out_tokens[0],
                         block_ids=kv.export_blocks(slot),
                         cache_pos=req.cache_pos,
                         block_hashes=tuple(hashes))

    def _release(self, slot: int) -> None:
        """Free a slot whose request finished or was cancelled (its blocks
        drop in paged mode; a finished prefill-worker request exports them
        first)."""
        req = self.active[slot]
        if (req is not None and req.capture_kv and req.done and self.paged
                and req.kv_handoff is None):
            req.kv_handoff = self._capture_handoff(slot, req)
        self.active[slot] = None
        self.positions[slot] = 0
        if self.paged:
            self.kv.release_slot(slot)

    def _admit_draft(self, slot: int, req: GenRequest) -> None:
        """Prefill the draft's dense cache with the request's whole feed.
        The draft has no prefix cache: it re-prefills prompt (+ generated
        tokens on a preemption resume) even when the target got a prefix
        hit."""
        req._spec_pending = None
        dcfg = self.draft_cfg
        n_valid = req.feed_len
        batch = self._pad_tokens({"tokens": req.feed_tokens}, dcfg, n_valid)
        _, single = self._draft_prefill(self.draft_params, batch, n_valid)
        _tree_insert(self.draft_cache, single, slot)
        self.draft_positions[slot] = req.feed_len

    # ---------------------------------------------------------------- #
    def _pick_victim(self) -> Optional[int]:
        """Slot to preempt under block exhaustion: lowest priority first,
        youngest (highest rid) within a priority level."""
        best, best_key = None, None
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            key = (req.priority, -req.rid)
            if best_key is None or key < best_key:
                best, best_key = slot, key
        return best

    def _preempt(self, slot: int) -> None:
        """Evict ``slot`` back to the queue, freeing its blocks. On
        re-admission it re-prefills prompt + generated-so-far and resumes
        decoding from the pre-preemption token, token-identical to an
        uninterrupted run (greedy is exact argmax; sampling is seeded per
        token index)."""
        req = self.active[slot]
        gen = req.out_tokens or []
        if gen:
            if len(gen) > 1:
                tail = torch.tensor(gen[:-1], dtype=req.tokens.dtype,
                                    device=req.tokens.device)[None]
                req._admit_tokens = torch.cat([req.tokens, tail], dim=1)
            else:
                req._admit_tokens = req.tokens
            req._resume_last = gen[-1]
        else:
            req._admit_tokens = None
            req._resume_last = None
        req._block_hashes = None               # feed changed: re-hash on admit
        self.kv.release_slot(slot)
        self.active[slot] = None
        self.positions[slot] = 0
        req.status = "queued"
        req.n_consumed = 0
        req.cache_pos = 0
        req.preemptions += 1
        self.preempted_total += 1
        heapq.heappush(self._pending, (-req.priority, req.rid, req))

    def _ensure_blocks(self) -> None:
        """Grow every active slot's table to cover its next write position
        (the whole k+1 verify span for spec engines), preempting victims
        when the pool is exhausted."""
        kv = self.kv
        bs = kv.block_size
        span = self._spec_m
        for slot in range(self.n_slots):
            req = self.active[slot]
            if req is None:
                continue
            while (req.cache_pos + span - 1) // bs >= len(kv.slot_blocks[slot]):
                if kv.grow(slot):
                    continue
                victim = self._pick_victim()
                if victim is None:      # unreachable: submit() guards size
                    raise MemoryError("paged KV pool exhausted with no "
                                      "preemptible request")
                self._preempt(victim)
                if victim == slot:
                    break               # this slot itself was evicted

    def _prompt_token(self, req: GenRequest, i: int) -> torch.Tensor:
        return req.feed_tokens[0, i]

    def _set_last(self, slot: int, token) -> None:
        # an int fills in place; a device tensor (a [K] one for codebooks)
        # copies on the device; a [K] list crosses from the host
        if isinstance(token, list):
            token = torch.tensor(token, dtype=torch.int64)
        self.last_tokens[slot, 0] = token

    def _record(self, req: GenRequest, token) -> None:
        tok = token.tolist() if hasattr(token, "tolist") else token
        if not req.out_tokens:
            # repro: allow-wallclock -- TTFT interval vs submitted_at
            req.first_token_at = time.perf_counter()
        req.out_tokens.append(tok)
        if req.on_token is not None:
            req.on_token(req, tok)
        if len(req.out_tokens) >= req.max_new_tokens or _hits_eos(tok, req.eos_id):
            req.done = True
            req.status = "done"
            # repro: allow-wallclock -- e2e-latency interval vs submitted_at
            req.finished_at = time.perf_counter()

    # ---------------------------------------------------------------- #
    # Speculative decoding step (spec engines)
    # ---------------------------------------------------------------- #
    def _draft_phase(self, decode_slots: List[int]
                     ) -> Tuple[Dict[int, List[int]], Dict[int, List[Any]]]:
        """k batched draft decode steps. A decode slot feeds its pending
        tokens (committed tokens the draft cache lacks), then the draft's
        own proposals; idle and prefilling slots feed token 0 at the
        scratch position. Returns (proposals, the draft distributions of
        sampled slots' proposals)."""
        proposals: Dict[int, List[int]] = {s: [] for s in decode_slots}
        dprobs: Dict[int, List[Any]] = {s: [] for s in decode_slots}
        pend: Dict[int, List[int]] = {}
        n0: Dict[int, int] = {}
        for s in decode_slots:
            req = self.active[s]
            pend[s] = list(req._spec_pending or [req.out_tokens[-1]])
            n0[s] = len(req.out_tokens)
        in_decode = torch.tensor([r is not None and r.status == "decode"
                                  for r in self.active]).to(self.device)
        base_pos = torch.where(in_decode, self.draft_positions,
                               torch.full_like(self.draft_positions,
                                               self._draft_trash))
        for i in range(self.spec_k):
            feed = [0] * self.n_slots
            for s in decode_slots:
                j = i - len(pend[s])
                feed[s] = int(pend[s][i] if j < 0 else proposals[s][j])
            toks = torch.tensor(feed, dtype=torch.int64).reshape(
                self.n_slots, 1).to(self.device)
            logits, _ = self._draft_decode(self.draft_params,
                                           self.draft_cache, toks,
                                           base_pos + i)
            last = logits[:, -1]
            batch_argmax = None
            for s in decode_slots:
                j = i - len(pend[s]) + 1     # proposal produced this round
                if j < 0:
                    continue                 # still catching up on pending
                req = self.active[s]
                if req.sampling.is_greedy:
                    if batch_argmax is None:
                        batch_argmax = torch.argmax(last, dim=-1).tolist()
                    proposals[s].append(int(batch_argmax[s]))
                else:
                    tok, probs = draft_propose(last[s], req.sampling,
                                               n0[s] + j)
                    proposals[s].append(tok)
                    dprobs[s].append(probs)
        return proposals, dprobs

    def _step_spec(self) -> int:
        """Admit -> draft k proposals -> one multi-token verify -> per-slot
        accept and commit with rollback. Prompt-feeding slots ride the same
        verify pass, consuming up to k+1 feed tokens. Returns #occupied."""
        self._admit()
        if self.paged:
            self._ensure_blocks()            # covers the whole verify span
        active_idx = [s for s in range(self.n_slots)
                      if self.active[s] is not None]
        if not active_idx:
            return 0
        m = self._spec_m
        decode_slots = [s for s in active_idx
                        if self.active[s].status == "decode"]
        proposals, dprobs = (self._draft_phase(decode_slots)
                             if decode_slots else ({}, {}))
        # candidates [B, m]: the last committed token and the proposals of
        # a decode slot, the next feed tokens of a feeding slot, padded
        # with 0 (pad writes are stale by position and overwritten)
        cand = [[0] * m for _ in range(self.n_slots)]
        t_feed: Dict[int, int] = {}
        for s in active_idx:
            req = self.active[s]
            if req.status == "decode":
                row = [int(req.out_tokens[-1])] + proposals[s]
            else:
                t_f = min(m, req.feed_len - req.n_consumed)
                t_feed[s] = t_f
                row = req.feed_tokens[0, req.n_consumed:
                                      req.n_consumed + t_f].tolist()
            cand[s][:len(row)] = row
        cand_t = torch.tensor(cand, dtype=torch.int64).to(self.device)
        if self.paged:
            logits, _ = self._verify_paged(self.params, self.kv.shard_pools,
                                           cand_t, self.positions,
                                           self.kv.tables)
        else:
            logits, _ = self._verify(self.params, self.cache, cand_t,
                                     self.positions)
        self.steps += 1
        tgt_argmax = None
        pos_delta = [0] * self.n_slots
        n_occupied = 0
        for s in active_idx:
            req = self.active[s]
            if req.status != "decode":
                n_occupied += self._commit_feed(s, req, t_feed[s], logits)
                pos_delta[s] = t_feed[s]
            else:
                k_s = len(proposals[s])
                if req.sampling.is_greedy:
                    if tgt_argmax is None:
                        tgt_argmax = torch.argmax(logits, dim=-1).tolist()
                    n_acc, toks = greedy_accept(proposals[s],
                                                tgt_argmax[s][:k_s + 1])
                else:
                    n_acc, toks = rejection_sample(
                        proposals[s], dprobs[s], logits[s], req.sampling,
                        len(req.out_tokens))
                occupied, c = self._commit_spec(s, req, n_acc, k_s, toks)
                n_occupied += occupied
                pos_delta[s] = c
                req.cache_pos += c
            if req.done:
                self._release(s)
                pos_delta[s] = 0
        self.positions += torch.tensor(pos_delta,
                                       dtype=torch.int64).to(self.device)
        if self.paged:
            # rollback: drop tail blocks that only ever held rejected
            # verify writes (or pad), so the pool carries no dead
            # speculation between steps
            for s in active_idx:
                req = self.active[s]
                if req is not None:
                    self.kv.truncate(
                        s, self.kv.blocks_for_tokens(req.cache_pos))
        return n_occupied

    def _commit_feed(self, slot: int, req: GenRequest, t_f: int,
                     logits) -> int:
        """Advance a prompt-feeding slot by the ``t_f`` feed tokens the
        verify pass just wrote; on completion emit the first new token (or
        take back the pre-preemption token on resume)."""
        start = req.n_consumed
        req.n_consumed += t_f
        req.cache_pos += t_f
        self.prompt_tokens_computed += (min(req.n_consumed, req.prompt_len)
                                        - min(start, req.prompt_len))
        if req.n_consumed < req.feed_len:
            self._set_last(slot, self._prompt_token(req, req.n_consumed))
            return 1
        req.status = "decode"
        if req._resume_last is not None:
            self._set_last(slot, req._resume_last)
            req._resume_last = None
            return 1
        nxt = sample(logits[slot, t_f - 1], req.sampling,
                     len(req.out_tokens))
        self._record(req, int(nxt))
        self._set_last(slot, nxt)
        return 0 if req.done else 1

    def _commit_spec(self, slot: int, req: GenRequest, n_acc: int,
                     k_s: int, toks: List[int]) -> Tuple[int, int]:
        """Commit one verify round's tokens (stopping at EOS or budget),
        update the acceptance counts and the draft's bookkeeping. Returns
        (still occupied, tokens committed)."""
        c = 0
        for t in toks:
            self._record(req, int(t))
            c += 1
            if req.done:
                break
        self.spec_events += 1
        self.spec_committed += c
        self.draft_proposed += k_s
        accepted = min(n_acc, c)
        self.draft_accepted += accepted
        req.spec_events += 1
        req.spec_accepted += accepted
        if req.done:
            req._spec_pending = None
            return 0, c
        if c == k_s + 1 and n_acc == k_s:
            # bonus round: the draft never consumed its own last proposal,
            # so the next draft phase feeds it before the bonus token
            req._spec_pending = [toks[c - 2], toks[c - 1]]
        else:
            req._spec_pending = [toks[c - 1]]
        self._set_last(slot, toks[c - 1])
        total = req.prompt_len + len(req.out_tokens)
        self.draft_positions[slot] = total - len(req._spec_pending)
        return 1, c

    # ---------------------------------------------------------------- #
    @torch.no_grad()
    def step(self) -> int:
        """Admit -> one batched decode step -> harvest. Returns #occupied."""
        if self.spec is not None:
            return self._step_spec()
        self._admit()
        if self.paged:
            self._ensure_blocks()                # may preempt under pressure
        if not any(r is not None for r in self.active):
            return 0
        if self.paged:
            logits, _ = self._decode_paged(self.params, self.kv.shard_pools,
                                           self.last_tokens, self.positions,
                                           self.kv.tables)
        else:
            logits, _ = self._decode(self.params, self.cache,
                                     self.last_tokens, self.positions)
        self.positions += 1
        last = logits[:, -1]                     # [B, V] or [B, K, V]
        # one batched argmax serves every greedy slot, with one host sync
        # per step; only non-greedy requests sample per slot
        greedy = (torch.argmax(last, dim=-1).tolist()
                  if any(r is not None and r.sampling.is_greedy
                         for r in self.active) else None)
        self.steps += 1
        n_occupied = 0
        for slot, req in enumerate(self.active):
            if req is None:
                continue
            req.cache_pos += 1                   # host mirror of positions
            if req.n_consumed < req.feed_len:
                # this tick consumed one feed token (chunked-prefill tail,
                # prefix-hit tail, or preemption-resume replay)
                req.n_consumed += 1
                if req.n_consumed <= req.prompt_len:
                    # replayed generated tokens (resume) are not prompt work
                    self.prompt_tokens_computed += 1
                if req.n_consumed < req.feed_len:
                    self._set_last(slot, self._prompt_token(req, req.n_consumed))
                    n_occupied += 1
                    continue
                req.status = "decode"   # logits now predict the next token
                if req._resume_last is not None:
                    # resume: the "next token" was generated before the
                    # preemption — feed it, don't re-record it
                    self._set_last(slot, req._resume_last)
                    req._resume_last = None
                    n_occupied += 1
                    continue
            nxt = (greedy[slot] if req.sampling.is_greedy
                   else sample(last[slot], req.sampling, len(req.out_tokens)))
            self._record(req, nxt)
            self._set_last(slot, nxt)
            if req.done:
                self._release(slot)              # slot frees mid-flight
            else:
                n_occupied += 1
        return n_occupied

    def run(self, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.has_work:
                break
            self.step()

    # ---------------------------------------------------------------- #
    def metrics(self, reqs: Optional[List[GenRequest]] = None
                ) -> Dict[str, float]:
        """Aggregate serving metrics over ``reqs`` (default: every request
        ever submitted). Always returns the full ``METRIC_KEYS`` set, zeroed
        where nothing finished."""
        if reqs is None:
            reqs = self.all_requests
        done = [r for r in reqs if r.done]
        m = dict.fromkeys(METRIC_KEYS, 0.0)
        m.update(
            completed=len(done),
            rejected=sum(1 for r in reqs if r.rejected),
            queued=self.queue_depth,
            active=sum(1 for r in self.active if r is not None),
            submitted=len(reqs),
            decode_steps=self.steps,
            generated_tokens=sum(len(r.out_tokens or []) for r in reqs),
            prefill_tokens=self.prefill_tokens,
            preempted=self.preempted_total,
            cancelled=sum(1 for r in reqs if r.status == "cancelled"),
            prefix_hit_tokens=self.prefix_hit_tokens,
            prompt_tokens_computed=self.prompt_tokens_computed,
            prefix_hit_rate=(self.prefix_hit_tokens
                             / self.prompt_tokens_submitted
                             if self.prompt_tokens_submitted else 0.0),
            kv_blocks_peak=(self.kv.alloc.stats.peak_in_use
                            if self.paged else 0),
            tp=self.tp,
            spec_events=self.spec_events,
            spec_draft_tokens=self.draft_proposed,
            spec_accepted_tokens=self.draft_accepted,
            acceptance_rate=(self.draft_accepted / self.draft_proposed
                             if self.draft_proposed else 0.0),
            accepted_tokens_per_step=(self.spec_committed / self.spec_events
                                      if self.spec_events else 0.0),
        )
        if not done:
            return m
        # peak cache bytes per concurrent request: dense reserves the whole
        # (n_slots, max_len) cache up front; paged holds only the blocks
        # actually touched (high-water mark), shared prefixes counted once
        # tensor parallelism: the per-device share (GQA caches split on the
        # kv heads; MLA caches are whole on every shard)
        if self.paged:
            peak = self.kv.alloc.stats.peak_in_use
            kv_bytes = self.kv.kv_bytes_in_use(peak)
            shard_bytes = self.kv.kv_bytes_in_use_per_shard(peak)
        else:
            shard_bytes = sum(t.numel() * t.element_size()
                              for leaves in layer_caches(self.cache[0])
                              for t in leaves)
            kv_bytes = shard_bytes * kv_shard_divisor(self.cfg, self.tp)
        m["kv_hbm_bytes_per_req"] = kv_bytes / self.n_slots
        m["kv_hbm_bytes_per_req_per_shard"] = shard_bytes / self.n_slots
        ttft = [r.first_token_at - r.submitted_at for r in done]
        total = [r.finished_at - r.submitted_at for r in done]
        toks = sum(len(r.out_tokens) for r in done)
        wall = max(r.finished_at for r in done) - min(r.submitted_at
                                                      for r in done)
        m.update(
            mean_ttft_s=sum(ttft) / len(ttft),
            p50_ttft_s=interpolated_percentile(ttft, 0.5),
            p90_ttft_s=interpolated_percentile(ttft, 0.9),
            p99_ttft_s=interpolated_percentile(ttft, 0.99),
            mean_latency_s=sum(total) / len(total),
            throughput_tok_s=toks / max(wall, 1e-9),
        )
        return m
