"""repro_torch.api: the port's EdgeMLOps control-plane surface, the names
of ``repro.api``.

    ModelArtifact              one object through the whole lifecycle
    VariantSpec / QuantRecipe  declarative quantization variants
    Backend registry           kernel backends (``cuda``, ``ref`` and their
                               ``*-tp`` twins), scoped selection
    ArtifactRegistry           versioned, sha256-checked artifact store
    Deployment                 fleet rollout facade (``spec_config``: a
                               draft/target pair for speculative decoding;
                               ``simulator``: the event-driven fleet)
"""
from repro_torch.api.backends import (Backend, CudaBackend, RefBackend,
                                      TPBackend, available_backends,
                                      current_backend, default_backend,
                                      get_backend, register_backend,
                                      set_default_backend, use_backend)
from repro_torch.api.variants import DEFAULT_VARIANTS, QuantRecipe, VariantSpec
from repro_torch.api.artifact import ModelArtifact
from repro_torch.api.registry import ArtifactRef, ArtifactRegistry
from repro_torch.api.deployment import Deployment

# re-exported so one import serves the common lifecycle scripts
from repro_torch.clock import SystemClock, VirtualClock, use_clock
from repro_torch.fleet.agent import DeviceProfile, EdgeAgent, InstallError
from repro_torch.fleet.orchestrator import (HealthGate, RolloutPolicy,
                                            RolloutReport)
from repro_torch.fleet.simulator import (DeviceSpec, EnginePool, FaultPlan,
                                         FleetSimulator, WorkloadModel)
from repro_torch.fleet.telemetry import InferenceRecord, TelemetryHub
from repro_torch.serving.engine import InferenceSession
from repro_torch.serving.loadgen import ArrivalTrace, TracedRequest, replay
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import ContinuousBatchingEngine, GenRequest
from repro_torch.serving.spec_decode import SpecConfig

__all__ = [
    # artifacts + variants
    "ModelArtifact", "VariantSpec", "QuantRecipe", "DEFAULT_VARIANTS",
    # kernel backends
    "Backend", "RefBackend", "CudaBackend", "TPBackend", "register_backend",
    "get_backend", "available_backends", "use_backend", "current_backend",
    "default_backend", "set_default_backend",
    # clocks (shared virtual-time layer)
    "SystemClock", "VirtualClock", "use_clock",
    # serving (backend-pinned continuous batching + load generation)
    "ContinuousBatchingEngine", "GenRequest", "SamplingParams", "SpecConfig",
    "ArrivalTrace", "TracedRequest", "replay",
    # fleet control plane
    "Deployment", "ArtifactRegistry", "ArtifactRef", "EdgeAgent",
    "DeviceProfile", "InstallError", "HealthGate", "RolloutPolicy",
    "RolloutReport", "TelemetryHub", "InferenceRecord", "InferenceSession",
    "FleetSimulator", "DeviceSpec", "FaultPlan", "WorkloadModel",
    "EnginePool",
]
