"""PyTorch/CUDA port of the ``repro`` serving stack for NVIDIA Hopper.

The dense-GQA serving path over an fp, int8 or int4 KV cache (config ->
params -> int8 variants -> ``InferenceSession`` or the dense / paged
``ContinuousBatchingEngine``) runs here with hand-written CUDA kernels for
flash prefill, paged decode attention, their int8-KV and int4-KV variants,
dense int8-KV decode and the static/dynamic w8a8 GEMMs
(``repro_torch.kernels``).
The package imports torch and numpy only; it never imports JAX or
``repro``.
"""
