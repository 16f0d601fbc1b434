from repro_torch.serving.engine import (
    InferenceSession,
    InferenceStats,
    Pipeline,
    RequestQueue,
    interpolated_percentile,
)

__all__ = [
    "InferenceSession",
    "InferenceStats",
    "Pipeline",
    "RequestQueue",
    "interpolated_percentile",
]
