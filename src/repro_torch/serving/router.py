"""SLO-aware request router over disaggregated prefill / decode workers:
the port of ``repro.serving.router``.

One ``ContinuousBatchingEngine`` doing both chunked prefill and decode
couples the two latency regimes: a long prompt holds a slot for its whole
generation, so under bursty traffic interactive requests queue behind
batch-class decodes and TTFT grows. This module splits the roles:

* **prefill workers** run ``submit_prefill``: compute a prompt's paged KV
  plus exactly one token, then export the blocks as a ``KVHandoff``. Their
  slots recycle after the prompt, not after the generation.
* **decode workers** run ``submit_handoff``: attach the handoff's blocks to
  a slot with ZERO prompt recompute (the blocks live in the same
  ``SharedKVPool``) and stream the remaining tokens, bit-identical to a
  single engine serving the same request.
* the **router** owns admission and placement on a deterministic
  ``VirtualClock``: queue-depth backpressure at the front door, SLO
  classes (``INTERACTIVE`` is TTFT-bound and dispatches first, ``BATCH``
  is throughput-bound), least-loaded dispatch over the worker replicas,
  and starvation-free re-dispatch: a handoff a decode worker rejects under
  KV pressure ages in the ready queue, gains effective priority, and
  pauses new prefill dispatch until it lands, so prefill never consumes
  the pool out from under committed work.

Request state machine (``RoutedRequest.state``)::

    queued -> prefill -> ready -> decode -> done
       \\-> rejected (admission)     \\-> ready (re-dispatch on rejection)

Everything is tick-driven and thread-free: one ``step()`` dispatches, steps
every worker once, harvests, and advances the clock. The router reads no
wall time and orders its heaps by ``(-priority, rid)`` alone, so its
metrics, in virtual seconds, equal the JAX router's on the same trace.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.clock import VirtualClock
from repro_torch.serving.engine import interpolated_percentile
from repro_torch.serving.loadgen import ArrivalTrace
from repro_torch.serving.sampling import SamplingParams


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A service-level class: ``priority`` orders dispatch (higher first),
    ``ttft_target_s`` is the virtual-seconds TTFT objective benchmarks
    report against (not enforced per-request — the router optimizes it by
    construction, the bench gates it)."""
    name: str
    priority: int = 0
    ttft_target_s: float = float("inf")


#: TTFT-bound traffic: dispatched ahead of batch at every stage.
INTERACTIVE = SLOClass("interactive", priority=1, ttft_target_s=8.0)
#: Throughput-bound traffic: fills whatever capacity interactive leaves.
BATCH = SLOClass("batch", priority=0)


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    max_queue_depth: int = 0       # front-door backpressure (0 = unbounded)
    age_boost_ticks: int = 16      # ready-queue wait that buys +1 priority
    starvation_ticks: int = 32     # ready-queue wait that pauses prefill
    max_ready_backlog: int = 0     # committed handoffs that pause prefill
                                   # (0 = auto: total decode slots). Every
                                   # committed handoff retains pool blocks,
                                   # so an unbounded backlog starves decode
                                   # of KV and the system livelocks on
                                   # re-dispatch.
    max_ticks: int = 1_000_000     # run() safety valve


@dataclasses.dataclass
class RoutedRequest:
    """Router-side view of one request across both workers."""
    rid: int
    tokens: Any                    # [1, S] prompt
    max_new_tokens: int
    slo: SLOClass = BATCH
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    eos_id: int = -1
    state: str = "queued"   # queued|rejected|prefill|ready|decode|done
    arrived_t: float = 0.0         # virtual seconds (clock.now() at submit)
    first_token_t: float = -1.0    # virtual seconds of the first token
    finished_t: float = -1.0
    ready_t: float = -1.0          # when the handoff entered the ready queue
    redispatches: int = 0          # decode-worker rejections survived
    handoff: Any = None
    prefill_req: Any = None        # GenRequest on the prefill worker
    decode_req: Any = None         # GenRequest on the decode worker

    @property
    def out_tokens(self) -> List[int]:
        """The generated stream: decode worker's view once dispatched (its
        first entry is the prefill worker's token), else the prefill one."""
        if self.decode_req is not None:
            return self.decode_req.out_tokens or []
        if self.prefill_req is not None:
            return self.prefill_req.out_tokens or []
        return []

    @property
    def ttft_s(self) -> float:
        return self.first_token_t - self.arrived_t


class ServingRouter:
    """Admission + placement over role-typed engine replicas.

    Every engine must be paged and attached to the SAME ``SharedKVPool`` —
    block ids in a handoff are raw indices into that pool, so a foreign
    pool would read garbage. ``step()`` order is fixed (decode dispatch,
    prefill dispatch, prefill workers, harvest, decode workers, harvest,
    tick) to keep replays deterministic.
    """

    def __init__(self, prefill_engines: Sequence, decode_engines: Sequence,
                 *, clock: Optional[VirtualClock] = None,
                 config: Optional[RouterConfig] = None):
        if not prefill_engines or not decode_engines:
            raise ValueError("need >= 1 prefill and >= 1 decode engine")
        self.prefill = list(prefill_engines)
        self.decode = list(decode_engines)
        store = self.prefill[0].kv.store
        for e in self.prefill + self.decode:
            if not e.paged or e.kv.store is not store:
                raise ValueError(
                    "router engines must share one SharedKVPool "
                    "(block ids are raw pool indices)")
        self.store = store
        self.clock = clock or VirtualClock()
        self.config = config or RouterConfig()
        self._queue: List[Tuple[int, int, RoutedRequest]] = []   # prefill
        self._ready: List[Tuple[int, int, RoutedRequest]] = []   # decode
        self._inflight: List[RoutedRequest] = []   # dispatched, not done
        self.requests: List[RoutedRequest] = []
        self._next_rid = 0
        self.rejected_total = 0
        self.redispatch_total = 0

    # ------------------------------------------------------------- #
    @property
    def queue_depth(self) -> int:
        return len(self._queue) + len(self._ready)

    @property
    def has_work(self) -> bool:
        return (bool(self._queue) or bool(self._ready)
                or bool(self._inflight)
                or any(e.has_work for e in self.prefill + self.decode))

    def warmup(self) -> None:
        """Compile every worker's entry points, then reset the shared pool
        once (engine-level ``kv.reset`` only drops the engine's own slots
        when the store is shared — see ``PagedKVCache.reset``)."""
        for e in self.prefill + self.decode:
            e.warmup()
        self.store.reset()

    # ------------------------------------------------------------- #
    def submit(self, tokens, max_new_tokens: int = 16, *,
               slo: SLOClass = BATCH, eos_id: int = -1,
               sampling: Optional[SamplingParams] = None) -> RoutedRequest:
        """Admission control. Rejects immediately (``state == "rejected"``)
        when the router queue is at ``max_queue_depth`` or the request
        could never fit a decode worker — backpressure belongs at the
        front door, not deep in a worker queue."""
        rr = RoutedRequest(self._next_rid, tokens, max_new_tokens, slo,
                           sampling or SamplingParams(), eos_id,
                           arrived_t=self.clock.now())
        self._next_rid += 1
        self.requests.append(rr)
        total = tokens.shape[1] + max_new_tokens
        never_fits = any(
            total > e.max_len
            or e.kv.blocks_for_tokens(total) + 1 > e.kv.alloc.usable_blocks
            for e in self.decode)
        if never_fits or (self.config.max_queue_depth
                          and self.queue_depth >= self.config.max_queue_depth):
            rr.state = "rejected"
            self.rejected_total += 1
            return rr
        heapq.heappush(self._queue, (-slo.priority, rr.rid, rr))
        return rr

    # ------------------------------------------------------------- #
    def _least_loaded(self, engines: List) -> List:
        """Replicas by (active + queued) load; ties resolve to the lower
        replica index so placement is deterministic."""
        return sorted(
            engines,
            key=lambda e: (sum(1 for r in e.active if r is not None)
                           + e.queue_depth,
                           self._engine_index(e)))

    def _engine_index(self, engine) -> int:
        pool = self.prefill if engine in self.prefill else self.decode
        return pool.index(engine)

    def _stamp_first_token(self, rr: RoutedRequest):
        def on_token(req, tok) -> None:
            if rr.first_token_t < 0:
                rr.first_token_t = self.clock.now()
        return on_token

    def _effective_priority(self, rr: RoutedRequest) -> int:
        """Aging: every ``age_boost_ticks`` of ready-queue wait buys one
        priority level, so a KV-pressure-rejected handoff eventually
        outranks even fresh interactive work — no starvation."""
        waited = self.clock.now() - rr.ready_t
        return rr.slo.priority + int(waited // self.config.age_boost_ticks)

    def _starved(self) -> bool:
        return any(self.clock.now() - rr.ready_t
                   >= self.config.starvation_ticks
                   for _, _, rr in self._ready)

    def _committed(self) -> int:
        """Handoffs holding pool blocks that decode has not absorbed yet:
        ready-queue entries plus prompts still in prefill flight."""
        return len(self._ready) + sum(
            1 for rr in self._inflight if rr.state == "prefill")

    def _dispatch_prefill(self) -> None:
        # a starved ready queue freezes prefill dispatch: finished decodes
        # free blocks and no new prompt may consume them first
        if self._starved():
            return
        backlog_cap = (self.config.max_ready_backlog
                       or sum(e.n_slots for e in self.decode))
        while self._queue:
            if self._committed() >= backlog_cap:
                return              # decode is the bottleneck: stop filling
            rr = self._queue[0][2]
            target = None
            for e in self._least_loaded(self.prefill):
                if sum(1 for r in e.active if r is not None) + e.queue_depth \
                        < 2 * e.n_slots:
                    target = e
                    break
            if target is None:
                return                      # every prefill worker saturated
            heapq.heappop(self._queue)
            rr.prefill_req = target.submit_prefill(
                rr.tokens, sampling=rr.sampling, priority=rr.slo.priority,
                on_token=self._stamp_first_token(rr))
            if rr.prefill_req.rejected:     # worker-side guard tripped
                rr.state = "rejected"
                self.rejected_total += 1
                continue
            rr.state = "prefill"
            self._inflight.append(rr)

    def _dispatch_decode(self) -> None:
        requeue = []
        while self._ready:
            _, seq, rr = heapq.heappop(self._ready)
            accepted = False
            for e in self._least_loaded(self.decode):
                req = e.submit_handoff(
                    rr.handoff, max_new_tokens=rr.max_new_tokens,
                    eos_id=rr.eos_id, sampling=rr.sampling,
                    priority=self._effective_priority(rr),
                    on_token=self._stamp_first_token(rr))
                if not req.rejected:
                    rr.decode_req = req
                    rr.state = "done" if req.done else "decode"
                    if req.done:
                        rr.finished_t = self.clock.now()
                    else:
                        self._inflight.append(rr)
                    accepted = True
                    break
                rr.redispatches += 1
                self.redispatch_total += 1
            if not accepted:
                requeue.append((seq, rr))   # every decode worker rejected
        for seq, rr in requeue:
            heapq.heappush(self._ready,
                           (-self._effective_priority(rr), seq, rr))

    def _harvest_prefill(self) -> None:
        for rr in list(self._inflight):
            if rr.state != "prefill" or not rr.prefill_req.done:
                continue
            self._inflight.remove(rr)
            rr.handoff = rr.prefill_req.kv_handoff
            assert rr.handoff is not None, "prefill worker exported no KV"
            if rr.max_new_tokens <= 1 or (
                    rr.eos_id >= 0 and rr.handoff.first_token == rr.eos_id):
                # the one prefill token completes the request: nothing to
                # decode, release the handoff's blocks (full prompt blocks
                # stay behind as registered prefix cache)
                rr.handoff.release(self.store.alloc)
                rr.state = "done"
                rr.finished_t = self.clock.now()
                continue
            rr.state = "ready"
            rr.ready_t = self.clock.now()
            heapq.heappush(self._ready,
                           (-rr.slo.priority, rr.rid, rr))

    def _harvest_decode(self) -> None:
        for rr in list(self._inflight):
            if rr.state == "decode" and rr.decode_req.done:
                self._inflight.remove(rr)
                rr.state = "done"
                rr.finished_t = self.clock.now()

    # ------------------------------------------------------------- #
    def step(self) -> None:
        """One router tick: dispatch, step every worker once, harvest."""
        self._dispatch_decode()
        self._dispatch_prefill()
        for e in self.prefill:
            e.step()
        self._harvest_prefill()
        self._dispatch_decode()    # hand fresh handoffs over this same tick
        for e in self.decode:
            e.step()
        self._harvest_decode()
        self.clock.tick()

    def run(self, max_ticks: Optional[int] = None) -> None:
        limit = max_ticks if max_ticks is not None else self.config.max_ticks
        for _ in range(limit):
            if not self.has_work:
                break
            self.step()

    # ------------------------------------------------------------- #
    def metrics(self) -> Dict[str, Any]:
        """Virtual-time serving report. All latencies are in virtual
        seconds (1 tick == 1 s), so two runs of the same trace produce the
        same numbers, and the same as the JAX router's on that trace."""
        done = [rr for rr in self.requests if rr.state == "done"]
        elapsed = max(self.clock.now(), 1e-9)
        gen = sum(len(rr.out_tokens) for rr in self.requests)
        m: Dict[str, Any] = {
            "router_requests": len(self.requests),
            "router_completed": len(done),
            "router_rejected": self.rejected_total,
            "router_redispatches": self.redispatch_total,
            "router_queue_depth": self.queue_depth,
            "router_ticks": self.clock.ticks,
            "router_generated_tokens": gen,
            "router_tok_s": gen / elapsed,
            "router_prefill_workers": len(self.prefill),
            "router_decode_workers": len(self.decode),
            "router_p99_ttft_s": 0.0,
            "router_mean_ttft_s": 0.0,
            "kv_blocks_peak": self.store.alloc.stats.peak_in_use,
            "decode_prompt_tokens_recomputed": sum(
                e.prompt_tokens_computed for e in self.decode),
        }
        for slo in {rr.slo.name: rr.slo for rr in self.requests}.values():
            cls_done = [rr for rr in done if rr.slo is slo
                        and rr.first_token_t >= 0]
            m[slo.name] = _ttft_stats(
                [rr.ttft_s for rr in cls_done],
                [rr.finished_t - rr.arrived_t for rr in cls_done])
            m[slo.name]["rejected"] = sum(
                1 for rr in self.requests
                if rr.slo is slo and rr.state == "rejected")
        # headline gate: the interactive class when present, else everyone
        head = [rr for rr in done if rr.first_token_t >= 0
                and (rr.slo.name == "interactive" or INTERACTIVE.name
                     not in m)]
        ttfts = [rr.ttft_s for rr in head]
        m["router_p99_ttft_s"] = interpolated_percentile(ttfts, 0.99)
        m["router_mean_ttft_s"] = (sum(ttfts) / len(ttfts)) if ttfts else 0.0
        return m


def _ttft_stats(ttfts: List[float], e2e: List[float]) -> Dict[str, float]:
    n = len(ttfts)
    return {
        "completed": n,
        "mean_ttft_s": (sum(ttfts) / n) if n else 0.0,
        "p50_ttft_s": interpolated_percentile(ttfts, 0.5),
        "p90_ttft_s": interpolated_percentile(ttfts, 0.9),
        "p99_ttft_s": interpolated_percentile(ttfts, 0.99),
        "mean_e2e_s": (sum(e2e) / n) if n else 0.0,
        "p99_e2e_s": interpolated_percentile(e2e, 0.99),
    }


def default_classify(i: int, traced) -> SLOClass:
    """Deterministic SLO assignment for trace replay: every other request
    is interactive — a mixed workload without touching the trace schema."""
    return INTERACTIVE if i % 2 == 0 else BATCH


def route_trace(router: ServingRouter, trace: ArrivalTrace,
                classify: Optional[Callable[[int, Any], SLOClass]] = None,
                max_ticks: int = 1_000_000) -> Dict[str, Any]:
    """Open-loop replay of ``trace`` through the router (the disaggregated
    analog of ``loadgen.replay``): arrivals land on the router's virtual
    clock whether or not the workers keep up, so admission control and
    queue growth are observable. Returns ``router.metrics()`` + trace
    metadata."""
    classify = classify or default_classify
    clock = router.clock
    i = 0
    while (i < len(trace.requests) or router.has_work) \
            and clock.ticks < max_ticks:
        while (i < len(trace.requests)
               and trace.requests[i].arrival_step <= clock.ticks):
            tr = trace.requests[i]
            router.submit(tr.tokens, tr.max_new_tokens,
                          slo=classify(i, tr), sampling=tr.sampling)
            i += 1
        router.step()
    report = router.metrics()
    report.update(trace_requests=len(trace.requests),
                  trace_seed=trace.seed,
                  trace_mean_interarrival=trace.mean_interarrival,
                  clock_ticks=clock.ticks)
    return report


def single_engine_trace(engine, trace: ArrivalTrace,
                        classify: Optional[Callable] = None,
                        max_ticks: int = 1_000_000) -> Dict[str, Any]:
    """The router bench's control arm: the same trace, same SLO classes,
    same virtual-tick TTFT measurement, served by ONE combined engine.
    Interactive requests still get engine-level priority, so the
    comparison isolates disaggregation, not priority scheduling."""
    classify = classify or default_classify
    clock = VirtualClock()
    rows: List[Tuple[SLOClass, Dict[str, float]]] = []
    i = 0
    while (i < len(trace.requests) or engine.has_work) \
            and clock.ticks < max_ticks:
        while (i < len(trace.requests)
               and trace.requests[i].arrival_step <= clock.ticks):
            tr = trace.requests[i]
            slo = classify(i, tr)
            row = {"arrived": clock.now(), "first": -1.0, "finished": -1.0}

            def on_token(req, tok, row=row) -> None:
                if row["first"] < 0:
                    row["first"] = clock.now()
                # on_token fires before _record's done check: detect the
                # final token by budget (trace requests carry no EOS)
                if len(req.out_tokens) >= req.max_new_tokens:
                    row["finished"] = clock.now()

            req = engine.submit(tr.tokens, tr.max_new_tokens,
                                sampling=tr.sampling, priority=slo.priority,
                                on_token=on_token)
            row["req"] = req
            rows.append((slo, row))
            i += 1
        engine.step()
        clock.tick()
    gen = sum(len(row["req"].out_tokens or []) for _, row in rows)
    m: Dict[str, Any] = {
        "single_requests": len(rows),
        "single_completed": sum(1 for _, r in rows if r["req"].done),
        "single_rejected": sum(1 for _, r in rows if r["req"].rejected),
        "single_ticks": clock.ticks,
        "single_tok_s": gen / max(clock.now(), 1e-9),
    }
    for name in sorted({slo.name for slo, _ in rows}):
        cls = [r for slo, r in rows
               if slo.name == name and r["req"].done and r["first"] >= 0]
        m[name] = _ttft_stats(
            [r["first"] - r["arrived"] for r in cls],
            [r["finished"] - r["arrived"] for r in cls])
    inter = m.get("interactive", m.get("batch", {}))
    m["single_p99_ttft_s"] = inter.get("p99_ttft_s", 0.0)
    m["single_mean_ttft_s"] = inter.get("mean_ttft_s", 0.0)
    return m
