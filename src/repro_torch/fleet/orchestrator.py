"""Fleet orchestrator, the Cumulocity *Device Management* + OTA analog: the
port of ``repro.fleet.orchestrator``.

Rollouts are staged (canary -> waves -> fleet-wide) behind a declarative
``RolloutPolicy``:

    1. partition the fleet into waves by cumulative fraction,
    2. deploy a wave (per-device variant selection via ``variant_policy``),
    3. gate the wave on health (accuracy/latency vs the incumbent); a
       failed gate, or too many failed installs, aborts the rollout and
       rolls back every device it touched,
    4. healthy -> next wave, until fleet-wide.

Every transition lands in the audit log with a timestamp from
``repro_torch.clock``. This is the synchronous form; the event-driven
thousand-device version of the same state machine is
``repro_torch.fleet.simulator``, and both share ``RolloutPolicy`` /
``HealthGate``. Each device's profile selects the artifact variant (4
GB-class devices get int8) via ``variant_policy``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch import clock as _clock
from repro_torch.fleet.agent import EdgeAgent, InstallError
from repro_torch.fleet.telemetry import TelemetryHub


@dataclasses.dataclass(frozen=True)
class HealthGate:
    max_accuracy_drop: float = 0.02      # absolute, vs incumbent
    max_latency_ratio: float = 1.5       # vs incumbent mean latency
    max_p99_ratio: Optional[float] = None   # vs incumbent p99 (None: off)
    max_error_rate: float = 1.0          # absolute ceiling on error rate

    def ok(self, base: Dict[str, float], cand: Dict[str, float]) -> bool:
        return self.reason(base, cand) is None

    def reason(self, base: Dict[str, float],
               cand: Dict[str, float]) -> Optional[str]:
        """None when healthy, else a human-readable violation."""
        if base.get("accuracy") is not None and cand.get("accuracy") is not None:
            if cand["accuracy"] < base["accuracy"] - self.max_accuracy_drop:
                return (f"accuracy {cand['accuracy']:.3f} < baseline "
                        f"{base['accuracy']:.3f} - {self.max_accuracy_drop}")
        if base.get("mean_latency_ms") and cand.get("mean_latency_ms") is not None:
            if cand["mean_latency_ms"] > self.max_latency_ratio * base["mean_latency_ms"]:
                return (f"mean latency {cand['mean_latency_ms']:.2f}ms > "
                        f"{self.max_latency_ratio}x baseline "
                        f"{base['mean_latency_ms']:.2f}ms")
        if (self.max_p99_ratio is not None and base.get("p99_latency_ms")
                and cand.get("p99_latency_ms") is not None):
            if cand["p99_latency_ms"] > self.max_p99_ratio * base["p99_latency_ms"]:
                return (f"p99 latency {cand['p99_latency_ms']:.2f}ms > "
                        f"{self.max_p99_ratio}x baseline "
                        f"{base['p99_latency_ms']:.2f}ms")
        if cand.get("error_rate", 0.0) > self.max_error_rate:
            return (f"error rate {cand['error_rate']:.3f} > "
                    f"{self.max_error_rate}")
        return None


@dataclasses.dataclass(frozen=True)
class RolloutPolicy:
    """Staged rollout shape: cumulative wave fractions + gating knobs.

    ``waves=(0.05, 0.25, 1.0)`` means canary 5%, then up to 25%, then the
    whole fleet. ``gated_waves=None`` gates every wave; an int gates only
    the first N. The ``*_s`` fields are virtual-time knobs consumed by the
    event-driven simulator (soak before probing, install stagger, ...)."""
    waves: Tuple[float, ...] = (0.05, 0.25, 1.0)
    gate: HealthGate = HealthGate()
    gated_waves: Optional[int] = None        # None -> gate every wave
    abort_install_waves: int = 1             # install error in wave<N aborts
    max_wave_failure_fraction: float = 0.25  # install-failure budget per wave
    max_install_retries: int = 1
    gate_min_calls: int = 20                 # simulator: min telemetry calls
    max_gate_extensions: int = 3             # simulator: extra soaks allowed
    soak_s: float = 20.0                     # simulator: soak before probe
    install_stagger_s: float = 0.25          # simulator: per-device stagger
    rollback_stagger_s: float = 0.05         # simulator: rollback pacing
    probe_flaky_retry_s: float = 2.0         # simulator: flaky-probe retry

    def partition(self, devices: Sequence) -> List[List]:
        """Deterministic wave partition (registration order)."""
        n = len(devices)
        waves, prev = [], 0
        for frac in self.waves:
            hi = min(n, max(int(n * frac), prev + 1))
            if hi > prev:
                waves.append(list(devices[prev:hi]))
                prev = hi
        if prev < n:
            waves.append(list(devices[prev:]))
        return waves

    def is_gated(self, wave_idx: int) -> bool:
        return self.gated_waves is None or wave_idx < self.gated_waves


@dataclasses.dataclass
class RolloutReport:
    model: str
    version: str
    succeeded: bool
    deployed: List[str]
    rolled_back: List[str]               # devices reverted to the incumbent
    reason: str = ""
    canary_metrics: Optional[Dict[str, Dict[str, float]]] = None
    waves: int = 0
    failed_installs: List[str] = dataclasses.field(default_factory=list)


class FleetOrchestrator:
    def __init__(self, registry,
                 telemetry: Optional[TelemetryHub] = None,
                 variant_policy: Optional[Callable[[EdgeAgent], str]] = None,
                 clock=None):
        self.registry = registry                 # repro_torch.api.registry
        self.telemetry = telemetry or TelemetryHub()
        self.clock = clock
        self.devices: Dict[str, EdgeAgent] = {}
        # default policy: small-memory devices get static int8
        self.variant_policy = variant_policy or (
            lambda agent: "static_int8"
            if agent.profile.memory_bytes <= 4 * 1024**3 else "fp32")
        self.history: List[RolloutReport] = []
        self.audit: List[Dict[str, Any]] = []

    def register_device(self, agent: EdgeAgent) -> None:
        self.devices[agent.device_id] = agent

    # ---------------------------------------------------------------- #
    def _now(self) -> float:
        return self.clock.now() if self.clock is not None else _clock.now()

    def _audit(self, kind: str, **kw) -> Dict[str, Any]:
        ev = {"t": self._now(), "kind": kind, **kw}
        self.audit.append(ev)
        return ev

    def _ref_for(self, agent: EdgeAgent, name: str, version: str):
        variant = self.variant_policy(agent)
        available = self.registry.variants(name, version)
        if variant not in available:
            # degrade gracefully: any admissible variant
            for v in available:
                if agent.profile.admits(self.registry.ref(name, version, v)) is None:
                    variant = v
                    break
        return self.registry.ref(name, version, variant)

    # ---------------------------------------------------------------- #
    def staged_rollout(self, name: str, version: str,
                       validate: Callable[[EdgeAgent], Dict[str, float]],
                       policy: RolloutPolicy = RolloutPolicy()
                       ) -> RolloutReport:
        """Synchronous staged rollout: canary -> waves -> fleet-wide.

        ``validate(agent)`` runs a validation workload on the *active*
        model and returns ``{"accuracy": ..., "mean_latency_ms": ...}``;
        it is invoked before activation (baseline) and after (candidate)
        on every device of a gated wave. A gate failure or an
        over-budget wave rolls back every device this rollout touched."""
        agents = list(self.devices.values())
        waves = policy.partition(agents)
        self._audit("rollout_started", model=name, version=version,
                    devices=len(agents), waves=len(waves))
        activated: List[EdgeAgent] = []
        deployed: List[str] = []
        rolled_back: List[str] = []
        failed_installs: List[str] = []
        canary_metrics: Dict[str, Dict[str, float]] = {}

        def abort(reason: str) -> RolloutReport:
            for a in reversed(activated):
                try:
                    a.rollback()
                    rolled_back.append(a.device_id)
                    self._audit("device_rolled_back", device=a.device_id)
                except InstallError:
                    pass
            self._audit("rollout_aborted", model=name, version=version,
                        reason=reason)
            report = RolloutReport(name, version, False, [], rolled_back,
                                   reason, canary_metrics, waves=len(waves),
                                   failed_installs=failed_installs)
            self.history.append(report)
            return report

        for wi, wave in enumerate(waves):
            gated = policy.is_gated(wi)
            self._audit("wave_started", wave=wi, devices=len(wave),
                        gated=gated)
            failures = 0
            for agent in wave:
                baseline = (validate(agent)
                            if gated and agent.session else None)
                try:
                    agent.activate(self._ref_for(agent, name, version))
                except InstallError as e:
                    self._audit("device_install_failed",
                                device=agent.device_id, wave=wi,
                                reason=str(e))
                    if wi < policy.abort_install_waves:
                        return abort(f"canary install: {e}")
                    failures += 1
                    failed_installs.append(agent.device_id)
                    if failures / len(wave) > policy.max_wave_failure_fraction:
                        return abort(
                            f"wave {wi}: {failures}/{len(wave)} installs "
                            f"failed (budget "
                            f"{policy.max_wave_failure_fraction:.0%})")
                    continue
                activated.append(agent)
                self._audit("device_activated", device=agent.device_id,
                            wave=wi, artifact=agent.active.key)
                if gated:
                    cand = validate(agent)
                    canary_metrics[agent.device_id] = cand
                    why = (policy.gate.reason(baseline, cand)
                           if baseline else None)
                    if why is not None:
                        self._audit("gate_failed", device=agent.device_id,
                                    wave=wi, reason=why)
                        return abort(
                            f"health gate failed on {agent.device_id}: {why} "
                            f"(baseline={baseline} candidate={cand})")
                deployed.append(agent.device_id)
            self._audit("wave_completed", wave=wi,
                        deployed=len(wave) - failures, failed=failures)
        self._audit("rollout_completed", model=name, version=version,
                    deployed=len(deployed))
        report = RolloutReport(name, version, True, deployed, rolled_back,
                               "ok", canary_metrics, waves=len(waves),
                               failed_installs=failed_installs)
        self.history.append(report)
        return report

    def rollout(self, name: str, version: str,
                validate: Callable[[EdgeAgent], Dict[str, float]],
                canary_fraction: float = 0.25,
                gate: HealthGate = HealthGate()) -> RolloutReport:
        """Classic canary rollout — a two-wave staged rollout (canary
        fraction, then the rest, gated only on the canaries)."""
        policy = RolloutPolicy(waves=(canary_fraction, 1.0), gate=gate,
                               gated_waves=1, abort_install_waves=1,
                               max_wave_failure_fraction=1.0)
        return self.staged_rollout(name, version, validate, policy)

    def fleet_rollback(self, devices: Optional[Sequence[str]] = None) -> List[str]:
        out = []
        for did in (devices or list(self.devices)):
            try:
                self.devices[did].rollback()
                self._audit("device_rolled_back", device=did)
                out.append(did)
            except InstallError:
                pass
        return out

    def status(self) -> Dict[str, Any]:
        return {did: agent.health() for did, agent in self.devices.items()}
