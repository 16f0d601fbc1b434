from repro_torch.serving.engine import (
    InferenceSession,
    InferenceStats,
    Pipeline,
    RequestQueue,
    interpolated_percentile,
)
from repro_torch.serving.kvcache import (
    BlockAllocator,
    PagedKVCache,
    SharedKVPool,
    blocks_for_budget,
    hash_prompt_blocks,
    kv_bytes_per_block,
    kv_bytes_per_token,
    paged_supported,
    pow2_bucket,
)
from repro_torch.serving.loadgen import ArrivalTrace, TracedRequest, replay
from repro_torch.serving.sampling import SamplingParams, sample
from repro_torch.serving.spec_decode import (
    SpecConfig,
    greedy_accept,
    rejection_sample,
    spec_supported,
)
from repro_torch.serving.scheduler import (
    METRIC_KEYS,
    ContinuousBatchingEngine,
    EngineConfig,
    GenRequest,
)

__all__ = [
    "InferenceSession",
    "InferenceStats",
    "Pipeline",
    "RequestQueue",
    "interpolated_percentile",
    "BlockAllocator",
    "PagedKVCache",
    "SharedKVPool",
    "blocks_for_budget",
    "hash_prompt_blocks",
    "kv_bytes_per_block",
    "kv_bytes_per_token",
    "paged_supported",
    "pow2_bucket",
    "ArrivalTrace",
    "TracedRequest",
    "replay",
    "SamplingParams",
    "sample",
    "METRIC_KEYS",
    "ContinuousBatchingEngine",
    "EngineConfig",
    "GenRequest",
    "SpecConfig",
    "spec_supported",
    "greedy_accept",
    "rejection_sample",
]
