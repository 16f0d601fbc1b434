"""``Deployment``: the rollout facade over registry + fleet orchestrator,
the port of ``repro.api.deployment``.

One object drives a model's fleet lifecycle end to end (the Cumulocity
"single pane of glass" of the paper): register devices, publish variants,
roll a version out behind health gates, inspect status, roll back.

    dep = Deployment(registry, model="vqi")
    dep.add_device("edge-std-0", DeviceProfile("edge-standard", 8 * 1024**3))
    dep.publish(model, specs, calib_data=batches, evaluate=eval_fn)
    report = dep.rollout("v1", validate=validate_fn)
    spec = dep.spec_config(k=3)     # a draft_of pair, for the engine's spec=
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.api.artifact import ModelArtifact
from repro_torch.api.registry import ArtifactRegistry
from repro_torch.api.variants import DEFAULT_VARIANTS, VariantSpec
from repro_torch.device import DeviceLike
from repro_torch.fleet.agent import DeviceProfile, EdgeAgent
from repro_torch.fleet.orchestrator import (FleetOrchestrator, HealthGate,
                                            RolloutPolicy, RolloutReport)
from repro_torch.fleet.telemetry import TelemetryHub


class Deployment:
    def __init__(self, registry: ArtifactRegistry, model: str,
                 fleet: Optional[FleetOrchestrator] = None,
                 telemetry: Optional[TelemetryHub] = None,
                 variant_policy: Optional[Callable[[EdgeAgent], str]] = None):
        self.registry = registry
        self.model = model
        if fleet is not None and (telemetry is not None
                                  or variant_policy is not None):
            raise ValueError("pass telemetry/variant_policy only when the "
                             "Deployment constructs its own fleet; an "
                             "explicit fleet already carries both")
        self.fleet = fleet or FleetOrchestrator(
            registry, telemetry=telemetry, variant_policy=variant_policy)

    # ------------------------------------------------------------------ #
    @property
    def telemetry(self) -> TelemetryHub:
        return self.fleet.telemetry

    @property
    def devices(self) -> Dict[str, EdgeAgent]:
        return self.fleet.devices

    @property
    def history(self) -> List[RolloutReport]:
        return self.fleet.history

    @property
    def audit(self) -> List[Dict[str, Any]]:
        return self.fleet.audit

    def add_device(self, device_id: str,
                   profile: DeviceProfile = DeviceProfile(), backend=None,
                   device: DeviceLike = None, clock=None) -> EdgeAgent:
        agent = EdgeAgent(device_id, self.registry, profile, backend=backend,
                          device=device, clock=clock)
        self.fleet.register_device(agent)
        return agent

    def register_agent(self, agent: EdgeAgent) -> EdgeAgent:
        """Register an externally constructed agent (e.g. the simulator's
        pool-backed ``SimAgent``)."""
        self.fleet.register_device(agent)
        return agent

    def simulator(self, **kwargs):
        """An event-driven ``FleetSimulator`` over this deployment: virtual
        clock, failure injection, 1000+ devices sharing an
        ``EnginePool``."""
        from repro_torch.fleet.simulator import FleetSimulator

        return FleetSimulator(self, **kwargs)

    # ------------------------------------------------------------------ #
    def publish(self, model: ModelArtifact,
                specs: Sequence[VariantSpec] = DEFAULT_VARIANTS,
                calib_data=None,
                evaluate: Optional[Callable] = None
                ) -> Dict[str, ModelArtifact]:
        """Publish ``model``'s variants into this deployment's registry."""
        if model.name != self.model:
            raise ValueError(f"deployment manages {self.model!r}, "
                             f"got artifact for {model.name!r}")
        return self.registry.publish_variants(model, specs,
                                              calib_data=calib_data,
                                              evaluate=evaluate)

    def rollout(self, version: Optional[str] = None, *,
                validate: Callable[[EdgeAgent], Dict[str, float]],
                canary_fraction: float = 0.25,
                gate: HealthGate = HealthGate()) -> RolloutReport:
        """Canary-roll ``version`` (default: latest) across the fleet."""
        return self.fleet.rollout(self.model, self._resolve_version(version),
                                  validate, canary_fraction=canary_fraction,
                                  gate=gate)

    def staged_rollout(self, version: Optional[str] = None, *,
                       validate: Callable[[EdgeAgent], Dict[str, float]],
                       policy: RolloutPolicy = RolloutPolicy()
                       ) -> RolloutReport:
        """Staged rollout (canary -> waves -> fleet-wide) of ``version``
        (default: latest) with per-wave health gates and auto-rollback."""
        return self.fleet.staged_rollout(self.model,
                                         self._resolve_version(version),
                                         validate, policy)

    def spec_config(self, version: Optional[str] = None, *,
                    target_variant: str = "fp32", k: int = 4,
                    draft_backend=None, device: DeviceLike = None):
        """This model version's draft/target pair (declared with
        ``VariantSpec(draft_of=...)`` at publish time) as a serving
        ``SpecConfig`` for ``ContinuousBatchingEngine(target, spec=...)``;
        the draft is fetched onto ``device`` and runs under
        ``draft_backend`` (default: the engine's backend)."""
        from repro_torch.serving.spec_decode import SpecConfig

        version = self._resolve_version(version)
        ref = self.registry.draft_for(self.model, version, target_variant)
        if ref is None:
            raise KeyError(
                f"no draft variant published for {self.model}:{version} "
                f"target {target_variant!r}: publish one with "
                "VariantSpec(..., draft_of=target)")
        return SpecConfig(draft=self.registry.fetch_artifact(ref, device),
                          k=k, draft_backend=draft_backend)

    def _resolve_version(self, version: Optional[str]) -> str:
        if version is not None:
            return version
        versions = self.registry.versions(self.model)
        if not versions:
            raise KeyError(f"no published versions for {self.model!r}")
        return versions[-1]

    def rollback(self, devices: Optional[Sequence[str]] = None) -> List[str]:
        return self.fleet.fleet_rollback(devices)

    def status(self) -> Dict[str, Any]:
        return self.fleet.status()

    def active_versions(self) -> Dict[str, Optional[str]]:
        return {did: (a.active.version if a.active else None)
                for did, a in self.fleet.devices.items()}
