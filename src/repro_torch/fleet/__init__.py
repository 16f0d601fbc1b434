"""The fleet layer of the port: edge agents, the staged-rollout
orchestrator, the telemetry hub, the event-driven fleet simulator with its
shared ``EnginePool`` (``repro.fleet``), and ``fleet.vqi``, the paper's VQI
use case."""
# Import order matters: agent/orchestrator/telemetry/simulator import
# nothing of repro_torch.api, while the registry shim pulls in
# repro_torch.api (whose deployment module imports them back): keep the
# shim last.
from repro_torch.fleet.agent import DeviceProfile, EdgeAgent, InstallError
from repro_torch.fleet.orchestrator import (FleetOrchestrator, HealthGate,
                                            RolloutPolicy, RolloutReport)
from repro_torch.fleet.telemetry import (InferenceRecord, LatencyHistogram,
                                         TelemetryHub)
from repro_torch.fleet.simulator import (DEVICE_CLASSES, DeviceSpec,
                                         EnginePool, FaultPlan,
                                         FleetSimulator, SimAgent,
                                         WorkloadModel,
                                         profile_variant_policy)
from repro_torch.fleet.registry import ArtifactRef, ArtifactRegistry

__all__ = ["DeviceProfile", "EdgeAgent", "InstallError", "FleetOrchestrator",
           "HealthGate", "RolloutPolicy", "RolloutReport", "InferenceRecord",
           "LatencyHistogram", "TelemetryHub", "DEVICE_CLASSES", "DeviceSpec",
           "EnginePool", "FaultPlan", "FleetSimulator", "SimAgent",
           "WorkloadModel", "profile_variant_policy", "ArtifactRef",
           "ArtifactRegistry"]
