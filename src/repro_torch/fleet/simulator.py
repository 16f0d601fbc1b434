"""Deterministic event-driven fleet simulator: the port of
``repro.fleet.simulator``.

Scales the fleet layer from a handful of synchronous in-process devices to
1000+ heterogeneous virtual devices on the shared ``repro_torch.clock``
``VirtualClock``. Everything is discrete-event:

* **Devices** are real ``EdgeAgent``s (``SimAgent``) whose lifecycle ops
  flow through the ``repro_torch.api`` registry, but whose fetch/serve
  steps are routed through a shared ``EnginePool``: a thousand devices
  share a handful of backend- and device-pinned ``InferenceSession``s
  instead of loading weights per device.
* **Rollouts** run the ``RolloutPolicy`` state machine (canary -> waves ->
  fleet-wide) over virtual time: installs take transfer time proportional
  to artifact size and link speed, waves soak before health probes, gates
  compare the telemetry generated since the rollout started against the
  incumbent baseline, and a failed gate, an over-budget wave, or too many
  unreachable probes roll back every touched device.
* **Failure injection** (``FaultPlan``): device offline windows, failed
  installs (with retries), slow links, flaky health probes. Offline
  devices defer their install and re-converge on reconnect.
* **Inspections** arrive per device on a seeded schedule; service times and
  error outcomes come from a deterministic ``WorkloadModel`` (virtual-time
  latency: per-variant, per-device-class, with seeded jitter and optional
  per-version regression injection), and land in the windowed
  ``TelemetryHub``.

Determinism: all randomness flows through per-device seeded streams and
events fire in ``(time, seq)`` order, so the same seed produces a
byte-identical event log (``event_log_json()``) on every run. The event
log is pure Python (no tensor reduction enters it) and equals the JAX
package's byte for byte on the same scenario: artifact sizes, the only
model-dependent input, are the same in both packages' registries.

``backend=`` (a kernel backend name, ``repro_torch.api.backends``) pins
sessions and engines as in the JAX package; ``device=`` places them
(``None``: the card). Sessions and engines are cached per ``(artifact,
backend, device)``, artifacts per ``(key, device)``.
"""
from __future__ import annotations

import dataclasses
import json
import random
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from repro_torch.clock import VirtualClock
from repro_torch.device import DeviceLike
from repro_torch.fleet.agent import DeviceProfile, EdgeAgent, InstallError
from repro_torch.fleet.orchestrator import RolloutPolicy
from repro_torch.fleet.telemetry import InferenceRecord

GiB = 1024**3


# ------------------------------------------------------------------ #
# Shared serving pool
# ------------------------------------------------------------------ #
class EnginePool:
    """Fetch-once, serve-many: artifacts are sha-verified on first fetch
    and ``InferenceSession``s are cached per ``(artifact, backend,
    device)``: the whole fleet shares one engine per variant / backend /
    device.

    KV-cache v2: the pool also hands out *paged serving engines* with
    per-device-class memory accounting: ``kv_budget_bytes`` carves a
    fraction of the device profile's RAM into KV blocks, so a Pi-4-class
    profile gets a small block budget (and visibly preempts under load)
    while a standard edge box gets a full pool. Engines are cached per
    (artifact, backend, device, profile-budget) so a thousand devices of
    one class share one engine.

    ``device`` (``None``: the card) is where an artifact is loaded and its
    sessions and engines run; ``backend`` (``None``: the default) the
    kernel backend they are pinned to. Stats and memory-report keys read
    ``<artifact>@<backend or device or 'default'>``. The pool keeps every
    artifact and engine it built for its own lifetime: drop the pool to
    free them."""

    #: default fraction of device RAM granted to the KV block pool
    KV_FRACTION = 0.25

    def __init__(self, registry):
        self.registry = registry
        self._artifacts: Dict[Tuple[str, DeviceLike], Any] = {}
        self._sessions: Dict[Tuple[str, Any, DeviceLike], Any] = {}
        self._engines: Dict[Tuple, Any] = {}
        self.fetches = 0

    def artifact(self, ref, device: DeviceLike = None):
        k = (ref.key, device)
        art = self._artifacts.get(k)
        if art is None:
            art = self._artifacts[k] = self.registry.fetch_artifact(ref,
                                                                    device)
            self.fetches += 1
        return art

    def session(self, ref, device: DeviceLike = None, *, backend=None):
        k = (ref.key, backend, device)
        s = self._sessions.get(k)
        if s is None:
            s = self._sessions[k] = self.artifact(ref, device).session(
                backend=backend, device=device)
        return s

    # ---------------------------------------------------------------- #
    def kv_budget_bytes(self, profile: DeviceProfile,
                        fraction: Optional[float] = None) -> int:
        """Device-class KV budget: ``fraction`` of the profile's RAM."""
        return int(profile.memory_bytes * (fraction if fraction is not None
                                           else self.KV_FRACTION))

    def serving_engine(self, ref, device: DeviceLike = None,
                       profile: Optional[DeviceProfile] = None, *,
                       kv_fraction: Optional[float] = None,
                       n_slots: int = 2, max_len: int = 128,
                       block_size: int = 16, tp: int = 1, backend=None):
        """Paged ``ContinuousBatchingEngine`` sized for ``profile``'s KV
        budget (full pool when no profile), cached per class so the whole
        device class shares one engine. ``tp > 1`` profiles serve one model
        tensor-parallel across that many shards: the profile budget is read
        as *per-shard* memory, so the engine divides its per-block charge
        by the shard count and admits proportionally more blocks."""
        from repro_torch.serving.scheduler import ContinuousBatchingEngine

        budget = (self.kv_budget_bytes(profile, kv_fraction)
                  if profile is not None else None)
        key = (ref.key, backend, device,
               profile.name if profile else None, budget, n_slots, max_len,
               block_size, tp)
        eng = self._engines.get(key)
        if eng is None:
            art = self.artifact(ref, device)
            eng = ContinuousBatchingEngine(
                art.params, art.config, backend=backend, n_slots=n_slots,
                max_len=max_len, paged=True, block_size=block_size,
                kv_budget_bytes=budget, tp=tp, device=device)
            self._engines[key] = eng
        return eng

    def request_router(self, ref, device: DeviceLike = None,
                       profile: Optional[DeviceProfile] = None, *,
                       kv_fraction: Optional[float] = None,
                       n_prefill: int = 1, n_decode: int = 2,
                       slots_per_worker: int = 2, max_len: int = 128,
                       block_size: int = 16, prefill_chunk: int = 8,
                       router_config=None, backend=None):
        """Disaggregated serving for one device class: ``n_prefill``
        prefill workers + ``n_decode`` decode workers on ONE
        ``SharedKVPool`` sized from the profile's KV budget, fronted by an
        SLO-aware ``ServingRouter``. Cached per class like
        ``serving_engine``: a site's worth of gateways shares one router.

        The budget buys the *pool*, not per-engine caches: role-splitting
        reuses the same blocks a combined engine would hold, it just stops
        long prompts from pinning decode slots."""
        from repro_torch.serving.kvcache import SharedKVPool, blocks_for_budget
        from repro_torch.serving.router import ServingRouter
        from repro_torch.serving.scheduler import ContinuousBatchingEngine

        budget = (self.kv_budget_bytes(profile, kv_fraction)
                  if profile is not None else None)
        key = ("router", ref.key, backend, device,
               profile.name if profile else None, budget, n_prefill,
               n_decode, slots_per_worker, max_len, block_size,
               prefill_chunk)
        router = self._engines.get(key)
        if router is None:
            art = self.artifact(ref, device)
            cfg = art.config
            total_slots = (n_prefill + n_decode) * slots_per_worker
            n_blocks = (blocks_for_budget(cfg, block_size, budget)
                        if budget is not None
                        else total_slots * (-(-max_len // block_size)) + 1)
            store = SharedKVPool(cfg, n_blocks, block_size, device)
            workers = [ContinuousBatchingEngine(
                art.params, cfg, backend=backend, n_slots=slots_per_worker,
                max_len=max_len, paged=True, shared_kv=store,
                prefill_chunk=chunk, max_queue_depth=2 * slots_per_worker,
                device=device)
                for chunk in [prefill_chunk] * n_prefill + [0] * n_decode]
            router = ServingRouter(workers[:n_prefill], workers[n_prefill:],
                                   config=router_config)
            self._engines[key] = router
        return router

    def memory_report(self) -> Dict[str, Dict[str, Any]]:
        """Per-engine KV accounting: pool capacity, bytes/block, peak
        blocks touched: the fleet-side view of cache memory pressure."""
        out: Dict[str, Dict[str, Any]] = {}
        for key, eng in self._engines.items():
            if key[0] == "router":
                (_, akey, backend, device, pname, budget, n_prefill,
                 n_decode, spw, max_len, block_size, _) = key
                alloc = eng.store.alloc
                bpb = eng.decode[0].kv.bytes_per_block
                out[f"{akey}@{backend or device or 'default'}"
                    f"/{pname or 'unbounded'}/{budget or 'full'}b"
                    f"/router{n_prefill}p{n_decode}d"
                    f"x{spw}/{max_len}/bs{block_size}"] = {
                    "budget_bytes": budget,
                    "router": f"{n_prefill}p+{n_decode}d",
                    "n_blocks": alloc.usable_blocks,
                    "bytes_per_block": bpb,
                    "kv_capacity_bytes": bpb * alloc.usable_blocks,
                    "kv_blocks_peak": alloc.stats.peak_in_use,
                    "kv_peak_bytes": bpb * alloc.stats.peak_in_use,
                    "preempted": sum(e.preempted_total
                                     for e in eng.prefill + eng.decode),
                    "prefix_hit_tokens": sum(
                        e.prefix_hit_tokens
                        for e in eng.prefill + eng.decode),
                }
                continue
            (akey, backend, device, pname, budget, n_slots, max_len,
             block_size, tp) = key
            kv = eng.kv
            # key mirrors the full cache key: engines differing only in
            # budget/geometry must not overwrite each other in the report
            out[f"{akey}@{backend or device or 'default'}"
                f"/{pname or 'unbounded'}"
                f"/{budget or 'full'}b/{n_slots}x{max_len}/bs{block_size}"
                f"/tp{tp}"] = {
                "budget_bytes": budget,
                "tp": tp,
                "n_blocks": kv.alloc.usable_blocks,
                "bytes_per_block": kv.bytes_per_block,
                # per-shard view: what each shard actually holds
                "bytes_per_block_per_shard": kv.bytes_per_block_per_shard,
                "kv_capacity_bytes": kv.bytes_per_block
                * kv.alloc.usable_blocks,
                "kv_capacity_bytes_per_shard": kv.bytes_per_block_per_shard
                * kv.alloc.usable_blocks,
                "kv_blocks_peak": kv.alloc.stats.peak_in_use,
                "kv_peak_bytes": kv.kv_bytes_in_use(
                    kv.alloc.stats.peak_in_use),
                "preempted": eng.preempted_total,
                "prefix_hit_tokens": eng.prefix_hit_tokens,
            }
        return out

    def stats(self) -> Dict[str, Any]:
        return {f"{key}@{backend or device or 'default'}": sess.stats
                for (key, backend, device), sess in self._sessions.items()}


class SimAgent(EdgeAgent):
    """An ``EdgeAgent`` whose artifact fetches and sessions go through the
    shared ``EnginePool``; carries simulator-side state (online flag)."""

    def __init__(self, device_id: str, registry, profile: DeviceProfile,
                 backend=None, device: DeviceLike = None, clock=None,
                 pool: Optional[EnginePool] = None):
        super().__init__(device_id, registry, profile, backend=backend,
                         device=device, clock=clock)
        self.pool = pool
        self.online = True

    def _fetch_verify(self, ref) -> None:
        if self.pool is not None:
            self.pool.artifact(ref, self.device)
        else:
            super()._fetch_verify(ref)

    def _fetch_artifact(self, ref):
        if self.pool is not None:
            return self.pool.artifact(ref, self.device)
        return super()._fetch_artifact(ref)

    def _build_session(self, artifact):
        if self.pool is not None and artifact.ref is not None:
            return self.pool.session(artifact.ref, device=self.device,
                                     backend=self.backend)
        return super()._build_session(artifact)

    def health(self):
        h = super().health()
        if self.pool is not None:
            # the pool session is shared: calls/latency aggregate fleet-wide
            h["stats_scope"] = "fleet-shared"
        return h


# ------------------------------------------------------------------ #
# Device / fault / workload declarations
# ------------------------------------------------------------------ #
@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    device_id: str
    profile: DeviceProfile = DeviceProfile()
    backend: Optional[str] = None        # kernel backend (None: the default)
    device: DeviceLike = None            # where its session runs (None: card)
    link_mbps: float = 40.0              # OTA download bandwidth
    inspection_interval_s: float = 10.0  # mean time between inspections
    compute_factor: float = 1.0          # service-time multiplier (device class)


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seeded failure injection. Rates draw from per-device streams;
    the explicit fields force deterministic scenarios in tests."""
    offline_rate_per_hour: float = 0.0        # Poisson offline events/device
    mean_offline_s: float = 120.0
    offline_windows: Mapping[str, Tuple[Tuple[float, float], ...]] = \
        dataclasses.field(default_factory=dict)   # device -> ((t_off, t_on),)
    install_fail_rate: float = 0.0
    install_fail_devices: frozenset = frozenset()  # these always fail installs
    slow_link_rate: float = 0.0
    slow_link_factor: float = 8.0
    flaky_probe_rate: float = 0.0


@dataclasses.dataclass(frozen=True)
class WorkloadModel:
    """Deterministic virtual-time inspection model: per-variant base service
    time scaled by device class, seeded jitter, and per-version overrides
    for injecting regressions (a "bad release" has a latency factor or an
    elevated error rate)."""
    base_ms: Mapping[str, float] = dataclasses.field(
        default_factory=lambda: {"fp32": 24.0, "static_int8": 7.0,
                                 "dynamic_int8": 9.0})
    jitter: float = 0.3                  # +/- relative spread
    base_error_rate: float = 0.02
    version_latency_factor: Mapping[str, float] = \
        dataclasses.field(default_factory=dict)
    version_error_rate: Mapping[str, float] = \
        dataclasses.field(default_factory=dict)

    def latency_ms(self, variant: str, version: str, compute_factor: float,
                   u: float) -> float:
        base = self.base_ms.get(variant, 16.0) * compute_factor
        base *= self.version_latency_factor.get(version, 1.0)
        return base * (1.0 + self.jitter * (2.0 * u - 1.0))

    def is_error(self, version: str, u: float) -> bool:
        return u < self.version_error_rate.get(version, self.base_error_rate)


#: canonical heterogeneous device classes (name, profile, factor, link)
DEVICE_CLASSES: Tuple[Tuple[str, DeviceProfile, float, float], ...] = (
    ("std", DeviceProfile("edge-standard", 8 * GiB), 1.0, 40.0),
    ("pi4", DeviceProfile("edge-pi4-4gb", 4 * GiB,
                          allowed_variants=("static_int8", "dynamic_int8")),
     2.2, 20.0),
    ("lite", DeviceProfile("edge-lite-2gb", 2 * GiB,
                           allowed_variants=("dynamic_int8",)),
     3.5, 8.0),
)


def profile_variant_policy(agent: EdgeAgent) -> str:
    """Variant selection by device class: standard -> fp32, Pi-4 ->
    static_int8, lite -> dynamic_int8 (the paper's heterogeneity story)."""
    name = agent.profile.name
    if "lite" in name:
        return "dynamic_int8"
    if "pi4" in name or agent.profile.memory_bytes <= 4 * GiB:
        return "static_int8"
    return "fp32"


# ------------------------------------------------------------------ #
# Rollout state (event-driven twin of orchestrator.staged_rollout)
# ------------------------------------------------------------------ #
class _Rollout:
    def __init__(self, version: str, policy: RolloutPolicy):
        self.version = version
        self.policy = policy
        self.status = "scheduled"    # running | complete | aborted
        self.reason = ""
        self.waves: List[List[str]] = []
        self.wave_idx = 0
        self.t_start: Optional[float] = None
        self.t_converged: Optional[float] = None
        self.t_abort: Optional[float] = None
        self.t_recovered: Optional[float] = None
        self.baseline: Dict[str, Dict[str, float]] = {}
        self.activated: List[str] = []
        self.failed: set = set()
        self.pending: set = set()            # offline-deferred devices
        self.installing: set = set()         # transfers in flight
        self.cand_base: Dict[str, Dict[str, Any]] = {}  # telemetry snapshots
        self.installs = 0
        self.retries = 0
        self.rolled_back: List[str] = []
        self._wave_state: Dict[int, Dict[str, Any]] = {}

    @property
    def convergence_s(self) -> Optional[float]:
        if self.t_start is None or self.t_converged is None:
            return None
        return self.t_converged - self.t_start

    @property
    def mttr_s(self) -> Optional[float]:
        if self.t_abort is None or self.t_recovered is None:
            return None
        return self.t_recovered - self.t_abort

    def summary(self) -> Dict[str, Any]:
        return {
            "version": self.version, "status": self.status,
            "reason": self.reason, "waves": len(self.waves),
            "installs": self.installs, "retries": self.retries,
            "activated": len(self.activated), "failed": len(self.failed),
            "stragglers": len(self.pending),
            "rolled_back": len(self.rolled_back),
            "convergence_s": self.convergence_s, "mttr_s": self.mttr_s,
        }


class FleetSimulator:
    """Event-driven fleet over a ``repro_torch.api.Deployment``: every
    lifecycle op (publish/install/activate/rollback) flows through the
    deployment's
    registry; the simulator adds virtual time, scale, and failure."""

    def __init__(self, deployment, *, seed: int = 0,
                 faults: FaultPlan = FaultPlan(),
                 workload: WorkloadModel = WorkloadModel(),
                 pool: Optional[EnginePool] = None,
                 clock: Optional[VirtualClock] = None,
                 log_inspections: bool = False,
                 real_every: int = 0,
                 real_batch: Optional[Callable[[EdgeAgent], Any]] = None):
        self.dep = deployment
        self.registry = deployment.registry
        self.model = deployment.model
        self.hub = deployment.telemetry
        self.seed = seed
        self.faults = faults
        self.workload = workload
        self.clock = clock or VirtualClock()
        self.pool = pool or EnginePool(self.registry)
        self.log_inspections = log_inspections
        self.real_every = real_every
        self._real_batch = real_batch
        self.specs: Dict[str, DeviceSpec] = {}
        self.events: List[Dict[str, Any]] = []
        self.rollouts: List[_Rollout] = []
        self.inspections = 0
        self._seq = 0
        self._started = False
        self._rngs: Dict[Tuple[str, str], random.Random] = {}

    # ------------------------------------------------------------- #
    def add_device(self, spec: DeviceSpec) -> SimAgent:
        agent = SimAgent(spec.device_id, self.registry, spec.profile,
                         backend=spec.backend, device=spec.device,
                         clock=self.clock, pool=self.pool)
        self.specs[spec.device_id] = spec
        self.dep.register_agent(agent)
        return agent

    def add_heterogeneous_fleet(self, n: int, mix: Tuple[float, ...] =
                                (0.5, 0.3, 0.2), backend: Optional[str] = None,
                                device: DeviceLike = None,
                                inspection_interval_s: float = 10.0
                                ) -> List[str]:
        """``n`` devices split across the canonical classes (std/pi4/lite),
        interleaved so every rollout wave is heterogeneous. Also installs
        ``profile_variant_policy`` on the deployment's fleet."""
        counts = [int(n * f) for f in mix]
        counts[0] += n - sum(counts)
        classes: List[Tuple[str, DeviceProfile, float, float]] = []
        for (cls, profile, factor, link), c in zip(DEVICE_CLASSES, counts):
            classes.extend([(cls, profile, factor, link)] * c)
        # deterministic interleave: round-robin over classes
        order: List[Tuple[str, DeviceProfile, float, float]] = []
        buckets = [[x for x in classes if x[0] == cls]
                   for cls, *_ in DEVICE_CLASSES]
        while any(buckets):
            for b in buckets:
                if b:
                    order.append(b.pop())
        ids = []
        for i, (cls, profile, factor, link) in enumerate(order):
            did = f"edge-{cls}-{i:04d}"
            self.add_device(DeviceSpec(
                did, profile, backend=backend, device=device, link_mbps=link,
                inspection_interval_s=inspection_interval_s,
                compute_factor=factor))
            ids.append(did)
        self.dep.fleet.variant_policy = profile_variant_policy
        return ids

    # ------------------------------------------------------------- #
    def _rng(self, device_id: str, purpose: str) -> random.Random:
        key = (device_id, purpose)
        rng = self._rngs.get(key)
        if rng is None:
            rng = self._rngs[key] = random.Random(
                f"{self.seed}:{purpose}:{device_id}")
        return rng

    def _log(self, kind: str, **kw) -> Dict[str, Any]:
        self._seq += 1
        ev = {"t": round(self.clock.now(), 6), "seq": self._seq,
              "kind": kind, **kw}
        self.events.append(ev)
        return ev

    def event_log_json(self) -> str:
        """Canonical serialization — byte-identical across same-seed runs."""
        return json.dumps(self.events, sort_keys=True,
                          separators=(",", ":"))

    @property
    def _current(self) -> Optional[_Rollout]:
        return self.rollouts[-1] if self.rollouts else None

    def _agent(self, did: str) -> SimAgent:
        return self.dep.devices[did]

    def _ref_for(self, agent: EdgeAgent, version: str):
        return self.dep.fleet._ref_for(agent, self.model, version)

    # ------------------------------------------------------------- #
    # Inspections (telemetry-generating workload)
    # ------------------------------------------------------------- #
    def _schedule_inspection(self, did: str, first: bool = False) -> None:
        spec = self.specs[did]
        rng = self._rng(did, "inspect")
        gap = (spec.inspection_interval_s * rng.random() if first else
               spec.inspection_interval_s * (0.7 + 0.6 * rng.random()))
        self.clock.schedule(gap, self._ev_inspection, did)

    def _ev_inspection(self, did: str) -> None:
        agent = self._agent(did)
        if agent.online and agent.active is not None:
            rng = self._rng(did, "work")
            spec = self.specs[did]
            ref = agent.active
            lat = self.workload.latency_ms(ref.variant, ref.version,
                                           spec.compute_factor, rng.random())
            err = self.workload.is_error(ref.version, rng.random())
            self.inspections += 1
            if (self.real_every and self._real_batch is not None
                    and agent.session is not None
                    and self.inspections % self.real_every == 0):
                # real device-pinned inference through the shared engine;
                # measured wall time lands in the pool session stats, never
                # in the (virtual, deterministic) event log
                try:
                    agent.infer(self._real_batch(agent))
                except Exception:
                    pass
            self.hub.push(InferenceRecord(
                device_id=did, model_key=ref.key, latency_ms=lat,
                confidence=0.4 if err else 0.9, correct=not err,
                t=self.clock.now()))
            if self.log_inspections:
                self._log("inspection", device=did, artifact=ref.key)
        self._schedule_inspection(did)

    # ------------------------------------------------------------- #
    # Fault timeline
    # ------------------------------------------------------------- #
    def _schedule_faults(self, until: float) -> None:
        plan = self.faults
        for did in self.specs:
            windows = list(plan.offline_windows.get(did, ()))
            if not windows and plan.offline_rate_per_hour > 0:
                rng = self._rng(did, "faults")
                rate = plan.offline_rate_per_hour / 3600.0
                t = 0.0
                while True:
                    t += rng.expovariate(rate)
                    if t >= until:
                        break
                    dur = max(5.0, rng.expovariate(1.0 / plan.mean_offline_s))
                    windows.append((t, min(t + dur, until)))
                    t += dur
            for t_off, t_on in windows:
                self.clock.schedule_at(t_off, self._ev_offline, did)
                self.clock.schedule_at(t_on, self._ev_online, did)

    def _ev_offline(self, did: str) -> None:
        self._agent(did).online = False
        self._log("device_offline", device=did)

    def _ev_online(self, did: str) -> None:
        self._agent(did).online = True
        self._log("device_online", device=did)
        # resume the NEWEST started rollout that deferred this device (the
        # latest-scheduled one may not have started yet); older rollouts'
        # pendings are superseded. A transfer already in flight is never
        # duplicated by a reconnect.
        for ro in reversed(self.rollouts):
            if ro.status in ("running", "complete") and did in ro.pending:
                if did not in ro.installing:
                    self._log("install_resumed", device=did,
                              version=ro.version)
                    self.clock.schedule(0.0, self._ev_install_start,
                                        ro, None, did, 0)
                for older in self.rollouts:
                    if older is ro:
                        break
                    older.pending.discard(did)
                break

    # ------------------------------------------------------------- #
    # Event-driven staged rollout
    # ------------------------------------------------------------- #
    def schedule_rollout(self, version: str,
                         policy: RolloutPolicy = RolloutPolicy(),
                         at: float = 0.0) -> _Rollout:
        ro = _Rollout(version, policy)
        self.rollouts.append(ro)
        self.clock.schedule_at(at, self._ev_rollout_start, ro)
        return ro

    def _ev_rollout_start(self, ro: _Rollout) -> None:
        for other in self.rollouts:
            if other is not ro and other.status == "running":
                self._log("rollout_deferred", version=ro.version)
                self.clock.schedule(30.0, self._ev_rollout_start, ro)
                return
        ro.status = "running"
        ro.t_start = self.clock.now()
        dids = list(self.dep.devices)
        ro.waves = [[a.device_id for a in wave]
                    for wave in ro.policy.partition(
                        list(self.dep.devices.values()))]
        # incumbent baseline per variant, from the full-stream aggregates
        for did in dids:
            ref = self._agent(did).active
            if ref is not None and ref.variant not in ro.baseline:
                m = self.hub.model_metrics(ref.key)
                if m["calls"]:
                    ro.baseline[ref.variant] = m
        # candidate snapshots: gates must judge only the telemetry this
        # rollout generates (a re-roll after an aborted attempt would
        # otherwise drag the failed attempt's records into the gate)
        for variant in self.registry.variants(self.model, ro.version):
            ro.cand_base[variant] = self.hub.snapshot(
                f"{self.model}:{ro.version}:{variant}")
        self._log("rollout_started", version=ro.version, devices=len(dids),
                  waves=len(ro.waves))
        self._start_wave(ro, 0)

    def _start_wave(self, ro: _Rollout, wi: int) -> None:
        wave = ro.waves[wi]
        ro.wave_idx = wi
        ro._wave_state[wi] = {"members": set(wave), "activated": set(),
                              "failed": set(), "deferred": set(),
                              "probed": False}
        self._log("wave_started", wave=wi, devices=len(wave),
                  gated=ro.policy.is_gated(wi))
        for k, did in enumerate(wave):
            self.clock.schedule(k * ro.policy.install_stagger_s,
                                self._ev_install_start, ro, wi, did, 0)

    def _ev_install_start(self, ro: _Rollout, wi: Optional[int], did: str,
                          attempt: int) -> None:
        if ro.status == "aborted" or (wi is not None and ro.status != "running"):
            return
        if did in ro.installing:       # a transfer is already in flight
            return
        agent = self._agent(did)
        ws = ro._wave_state.get(wi) if wi is not None else None
        if not agent.online:
            ro.pending.add(did)
            if ws is not None:
                ws["deferred"].add(did)
            self._log("install_deferred", device=did, wave=wi,
                      version=ro.version)
            self._check_wave(ro, wi)
            return
        try:
            ref = self._ref_for(agent, ro.version)
        except KeyError as e:
            self._install_failed_final(ro, wi, did, f"no artifact: {e}")
            return
        rng = self._rng(did, "install")
        spec = self.specs[did]
        slow = rng.random() < self.faults.slow_link_rate
        transfer_s = (ref.size_bytes * 8.0 / (spec.link_mbps * 1e6)
                      * (self.faults.slow_link_factor if slow else 1.0))
        fail = (did in self.faults.install_fail_devices
                or rng.random() < self.faults.install_fail_rate)
        ro.installs += 1
        ro.installing.add(did)
        self._log("install_started", device=did, wave=wi, attempt=attempt,
                  artifact=ref.key, slow_link=slow)
        if fail:
            self.clock.schedule(max(0.5, 0.6 * transfer_s),
                                self._ev_install_failed, ro, wi, did, attempt)
        else:
            self.clock.schedule(transfer_s + 1.0,
                                self._ev_install_done, ro, wi, did)

    def _ev_install_failed(self, ro: _Rollout, wi: Optional[int], did: str,
                           attempt: int) -> None:
        if ro.status == "aborted":
            return
        ro.installing.discard(did)
        self._log("install_failed", device=did, wave=wi, attempt=attempt)
        if attempt < ro.policy.max_install_retries:
            ro.retries += 1
            self.clock.schedule(2.0 * (attempt + 1), self._ev_install_start,
                                ro, wi, did, attempt + 1)
            return
        self._install_failed_final(ro, wi, did, "install retries exhausted")

    def _install_failed_final(self, ro: _Rollout, wi: Optional[int],
                              did: str, reason: str) -> None:
        ro.failed.add(did)
        ro.pending.discard(did)
        ro.installing.discard(did)
        self._log("device_failed", device=did, wave=wi, reason=reason)
        if wi is None:
            return
        ws = ro._wave_state[wi]
        ws["failed"].add(did)
        if (wi < ro.policy.abort_install_waves
                or len(ws["failed"]) / len(ws["members"])
                > ro.policy.max_wave_failure_fraction):
            self._abort(ro, f"wave {wi}: {len(ws['failed'])}/"
                            f"{len(ws['members'])} installs failed "
                            f"({reason} on {did})")
        else:
            self._check_wave(ro, wi)

    def _ev_install_done(self, ro: _Rollout, wi: Optional[int],
                         did: str) -> None:
        if ro.status == "aborted" or (wi is not None and ro.status != "running"):
            return
        agent = self._agent(did)
        ro.installing.discard(did)
        try:
            agent.activate(self._ref_for(agent, ro.version))
        except (InstallError, KeyError) as e:
            self._install_failed_final(ro, wi, did, str(e))
            return
        ro.activated.append(did)
        ro.t_converged = self.clock.now()
        late = did in ro.pending
        ro.pending.discard(did)
        self._log("device_activated", device=did, wave=wi,
                  artifact=agent.active.key, late=late)
        if late:
            self._log("device_reconverged", device=did,
                      version=ro.version)
        if wi is not None:
            ro._wave_state[wi]["activated"].add(did)
            self._check_wave(ro, wi)

    def _check_wave(self, ro: _Rollout, wi: Optional[int]) -> None:
        if wi is None or ro.status != "running":
            return
        ws = ro._wave_state[wi]
        terminal = ws["activated"] | ws["failed"] | ws["deferred"]
        if ws["probed"] or terminal != ws["members"]:
            return
        ws["probed"] = True
        if ro.policy.is_gated(wi) and ws["activated"]:
            self.clock.schedule(ro.policy.soak_s, self._ev_wave_probe, ro, wi)
        else:
            self._ev_wave_complete(ro, wi)

    def _ev_wave_probe(self, ro: _Rollout, wi: int) -> None:
        if ro.status != "running":
            return
        activated = ro._wave_state[wi]["activated"]
        unreachable = []
        for did in sorted(activated):
            rng = self._rng(did, "probe")
            if rng.random() < self.faults.flaky_probe_rate:
                self._log("probe_flaky", device=did, wave=wi)
                # one retry: only a second consecutive miss is a failure
                if rng.random() < self.faults.flaky_probe_rate:
                    unreachable.append(did)
                    self._log("probe_failed", device=did, wave=wi)
        self._log("wave_probed", wave=wi, failed=len(unreachable))
        if (len(unreachable) / len(activated)
                > ro.policy.max_wave_failure_fraction):
            self._abort(ro, f"wave {wi}: {len(unreachable)}/{len(activated)} "
                            f"health probes failed")
            return
        self.clock.schedule(ro.policy.probe_flaky_retry_s,
                            self._ev_wave_gate, ro, wi, 0)

    def _ev_wave_gate(self, ro: _Rollout, wi: int, extensions: int) -> None:
        if ro.status != "running":
            return
        activated = ro._wave_state[wi]["activated"]
        variants = sorted({self._agent(d).active.variant for d in activated
                           if self._agent(d).active is not None})
        cands = {v: self.hub.metrics_since(f"{self.model}:{ro.version}:{v}",
                                           ro.cand_base.get(v))
                 for v in variants}
        # a verdict on a handful of inspections is noise — extend the soak
        # (deterministically, bounded) until the wave has real data
        if (extensions < ro.policy.max_gate_extensions
                and any(0 < c["calls"] < ro.policy.gate_min_calls
                        and ro.baseline.get(v) is not None
                        for v, c in cands.items())):
            self._log("gate_extended", wave=wi, extension=extensions + 1)
            self.clock.schedule(ro.policy.soak_s, self._ev_wave_gate,
                                ro, wi, extensions + 1)
            return
        for variant in variants:
            cand = cands[variant]
            base = ro.baseline.get(variant)
            if not cand["calls"] or base is None:
                self._log("gate_skipped", wave=wi, variant=variant,
                          reason="no baseline" if cand["calls"] else "no data")
                continue
            why = ro.policy.gate.reason(base, cand)
            if why is not None:
                self._log("gate_failed", wave=wi, variant=variant, reason=why)
                self._abort(ro, f"wave {wi} health gate [{variant}]: {why}")
                return
        self._log("gate_passed", wave=wi, variants=variants)
        self._ev_wave_complete(ro, wi)

    def _ev_wave_complete(self, ro: _Rollout, wi: int) -> None:
        ws = ro._wave_state[wi]
        self._log("wave_completed", wave=wi, activated=len(ws["activated"]),
                  failed=len(ws["failed"]), deferred=len(ws["deferred"]))
        if wi + 1 < len(ro.waves):
            self._start_wave(ro, wi + 1)
        else:
            ro.status = "complete"
            self._log("rollout_completed", version=ro.version,
                      activated=len(ro.activated), failed=len(ro.failed),
                      stragglers=len(ro.pending),
                      convergence_s=round(ro.convergence_s or 0.0, 6))

    def _abort(self, ro: _Rollout, reason: str) -> None:
        if ro.status == "aborted":
            return
        ro.status = "aborted"
        ro.reason = reason
        ro.t_abort = self.clock.now()
        ro.pending.clear()
        self._log("rollout_aborted", version=ro.version, reason=reason,
                  to_roll_back=len(ro.activated))
        for j, did in enumerate(reversed(ro.activated)):
            self.clock.schedule(j * ro.policy.rollback_stagger_s,
                                self._ev_rollback_device, ro, did)
        self.clock.schedule(
            len(ro.activated) * ro.policy.rollback_stagger_s + 0.5,
            self._ev_rollback_complete, ro)

    def _ev_rollback_device(self, ro: _Rollout, did: str) -> None:
        agent = self._agent(did)
        try:
            prev = agent.rollback()
            ro.rolled_back.append(did)
            self._log("device_rolled_back", device=did, to=prev.key)
        except InstallError as e:
            self._log("rollback_failed", device=did, reason=str(e))

    def _ev_rollback_complete(self, ro: _Rollout) -> None:
        ro.t_recovered = self.clock.now()
        self._log("rollout_rolled_back", version=ro.version,
                  devices=len(ro.rolled_back),
                  mttr_s=round(ro.mttr_s or 0.0, 6))

    # ------------------------------------------------------------- #
    def run(self, until: float) -> Dict[str, Any]:
        """Advance the simulation to virtual time ``until``; returns
        ``metrics()``. First call wires the fault timeline and per-device
        inspection schedules."""
        if not self._started:
            self._started = True
            self._log("sim_started", devices=len(self.specs), seed=self.seed)
            self._schedule_faults(until)
            for did in self.specs:
                self._schedule_inspection(did, first=True)
        self.clock.run(until=until)
        return self.metrics()

    def variant_metrics(self, version: str) -> Dict[str, Dict[str, float]]:
        """Full-stream fleet telemetry (rolling aggregates) per variant of
        ``version``."""
        out = {}
        for variant in self.registry.variants(self.model, version):
            m = self.hub.model_metrics(f"{self.model}:{version}:{variant}")
            if m["calls"]:
                out[variant] = m
        return out

    def metrics(self) -> Dict[str, Any]:
        active = {}
        for did, agent in self.dep.devices.items():
            key = agent.active.key if agent.active else None
            active[key] = active.get(key, 0) + 1
        return {
            "devices": len(self.specs),
            "virtual_time_s": self.clock.now(),
            "events": len(self.events),
            "inspections": self.inspections,
            "active_artifacts": active,
            "rollouts": [ro.summary() for ro in self.rollouts],
            "telemetry": self.hub.summary(),
            "pool_fetches": self.pool.fetches,
        }
