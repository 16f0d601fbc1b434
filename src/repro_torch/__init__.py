"""PyTorch/CUDA port of the ``repro`` EdgeMLOps stack for NVIDIA Hopper.

Serving: the dense-GQA stack (stablelm, mistral-nemo) and phi-3-vision
(the VQI model family: a vision-frontend stub whose projected patch
embeddings go in front of the text) over an fp, int8 or int4 KV cache,
config -> params -> fp / dynamic-int8 / static-int8 variants ->
``InferenceSession`` or the dense / paged ``ContinuousBatchingEngine``.

Control plane (``repro_torch.api``, ``repro_torch.fleet``): ``ModelArtifact``,
a sha256-checked ``ArtifactRegistry`` in the JAX package's on-disk format,
``EdgeAgent`` devices with admission by variant and memory, a staged
``FleetOrchestrator`` with health gates, rollback and an audit log, the
``TelemetryHub``, ``Deployment``, and ``fleet.vqi``, the paper's visual
quality inspection loop.

Every TPU kernel of the JAX package has a hand-written CUDA kernel here
(``repro_torch.kernels``): flash prefill and its int8-KV and int4-KV
variants, paged decode attention and its two quantized variants, dense
int8-KV decode, the static and dynamic w8a8 GEMMs and the per-channel
int8 weight quantizer. The package imports torch and numpy only; it never
imports JAX or ``repro``.
"""
