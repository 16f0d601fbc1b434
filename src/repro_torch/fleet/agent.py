"""Edge device agent, the thin-edge.io analog: the port of
``repro.fleet.agent``.

An ``EdgeAgent`` manages the artifact lifecycle on one device: install from
the registry (with device-profile admission checks), activate (build an
``InferenceSession``), keep the previous version for instant rollback,
expose health metrics. ``DeviceProfile`` models heterogeneous fleets: small
devices admit only int8 variants. Event timestamps come from
``repro_torch.clock`` (a ``VirtualClock`` inside ``use_clock``, wall time
otherwise).

``backend=`` names the kernel backend the agent's sessions are pinned to
(``repro_torch.api.backends``; None: the default) and ``device=`` where
they run (None: the card). Each agent loads and serves its own copy of the
active artifact, through three overridable lifecycle hooks (fetch +
verify, fetch, build the session) that the fleet simulator's ``SimAgent``
routes through a shared ``EnginePool``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch

from repro_torch import clock as _clock
from repro_torch.device import DeviceLike


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    name: str = "edge-standard"
    memory_bytes: int = 4 * 1024**3          # Pi-4-class default
    allowed_variants: tuple = ("fp32", "static_int8", "dynamic_int8")

    def admits(self, ref) -> Optional[str]:
        """Returns a rejection reason or None if the artifact is admissible."""
        if ref.variant not in self.allowed_variants:
            return f"variant {ref.variant} not allowed on {self.name}"
        if ref.size_bytes > self.memory_bytes:
            return (f"artifact {ref.size_bytes/1e6:.0f}MB exceeds "
                    f"{self.name} memory {self.memory_bytes/1e6:.0f}MB")
        return None


class InstallError(RuntimeError):
    pass


class EdgeAgent:
    def __init__(self, device_id: str, registry,
                 profile: DeviceProfile = DeviceProfile(), backend=None,
                 device: DeviceLike = None, clock=None):
        self.device_id = device_id
        self.registry = registry                 # repro_torch.api.registry
        self.profile = profile
        self.backend = backend          # kernel backend name for this device
        self.device = device            # torch device of this agent's session
        self.clock = clock              # None -> repro_torch.clock active clock
        self.installed: List[Any] = []           # ArtifactRefs, newest last
        self.active: Optional[Any] = None        # active ArtifactRef
        self.artifact = None            # active ModelArtifact
        self.session = None             # active InferenceSession
        self.events: List[Dict[str, Any]] = []
        self.error_count = 0

    # ---------------------------------------------------------------- #
    def _now(self) -> float:
        return self.clock.now() if self.clock is not None else _clock.now()

    def _log(self, kind: str, **kw) -> None:
        self.events.append({"t": self._now(), "kind": kind,
                            "device": self.device_id, **kw})

    # Overridable lifecycle hooks (the simulator's SimAgent routes these
    # through a shared EnginePool so 1000 devices share a handful of
    # engines).
    def _fetch_verify(self, ref) -> None:
        """Download + sha256-verify the artifact bytes."""
        self.registry.fetch(ref, self.device)

    def _fetch_artifact(self, ref):
        return self.registry.fetch_artifact(ref, self.device)

    def _build_session(self, artifact):
        return artifact.session(backend=self.backend, device=self.device)

    # ---------------------------------------------------------------- #
    def install(self, ref) -> None:
        """Download + verify + stage (does not activate)."""
        reason = self.profile.admits(ref)
        if reason:
            self._log("install_rejected", artifact=ref.key, reason=reason)
            raise InstallError(reason)
        self._fetch_verify(ref)                  # download + sha256 verify
        self.installed.append(ref)
        self._log("installed", artifact=ref.key)

    def activate(self, ref) -> None:
        if ref not in self.installed:
            self.install(ref)
        artifact = self._fetch_artifact(ref)
        self.session = self._build_session(artifact)
        self.artifact = artifact
        self.active = ref
        self._log("activated", artifact=ref.key)

    def rollback(self):
        """Re-activate the most recent previously-installed version."""
        candidates = [r for r in self.installed
                      if self.active is None or r.version != self.active.version]
        if not candidates:
            raise InstallError(f"{self.device_id}: nothing to roll back to")
        prev = candidates[-1]
        self._log("rollback", frm=self.active.key if self.active else None,
                  to=prev.key)
        self.activate(prev)
        return prev

    # ---------------------------------------------------------------- #
    def infer(self, batch) -> torch.Tensor:
        if self.session is None:
            raise InstallError(f"{self.device_id}: no active model")
        try:
            return self.session.logits(batch)
        except Exception:
            self.error_count += 1
            raise

    def health(self) -> Dict[str, Any]:
        s = self.session.stats if self.session else None
        return {
            "stats_scope": "device",
            "device": self.device_id,
            "profile": self.profile.name,
            "active": self.active.key if self.active else None,
            "installed": [r.key for r in self.installed],
            "calls": s.calls if s else 0,
            "mean_latency_ms": s.mean_ms if s else 0.0,
            "p90_latency_ms": s.percentile_ms(0.9) if s else 0.0,
            "errors": self.error_count,
        }
