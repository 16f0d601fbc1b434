"""The fleet layer of the port: edge agents, the staged-rollout
orchestrator and the telemetry hub (``repro.fleet`` without its
event-driven simulator and ``EnginePool``, ROADMAP Queue 1 item 12), and
``fleet.vqi``, the paper's VQI use case."""
# Import order matters: agent/orchestrator/telemetry import nothing of
# repro_torch.api, while the registry shim pulls in repro_torch.api (whose
# deployment module imports them back): keep the shim last.
from repro_torch.fleet.agent import DeviceProfile, EdgeAgent, InstallError
from repro_torch.fleet.orchestrator import (FleetOrchestrator, HealthGate,
                                            RolloutPolicy, RolloutReport)
from repro_torch.fleet.telemetry import (InferenceRecord, LatencyHistogram,
                                         TelemetryHub)
from repro_torch.fleet.registry import ArtifactRef, ArtifactRegistry

__all__ = ["DeviceProfile", "EdgeAgent", "InstallError", "FleetOrchestrator",
           "HealthGate", "RolloutPolicy", "RolloutReport", "InferenceRecord",
           "LatencyHistogram", "TelemetryHub", "ArtifactRef",
           "ArtifactRegistry"]
