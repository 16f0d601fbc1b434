#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` (into ``build/``) and
prints one JSON line per phase:

1. card: ``nvidia-smi`` name and power limit, kernel build time, ptxas
   registers and spills per source and per instantiation of the three
   tensor-core prefills at each tile (``flash_tc``, ``flash_qtc``,
   ``flash_q4tc``), the split-K
   decode loops (``*_split``) and the weight quantizer's two routes
   (``quantize_cluster``, ``quantize_cols``), and any kernel that spills;
2. kernels: each CUDA kernel against its plain PyTorch version on the card
   at the main paths' shapes, with its time (a CUDA-graph replay: device
   time; and the eager call, launch gaps included), the plain version's
   time, its bound and a library yardstick's time (timed here only, never
   used by the port): the GEMMs (on the packed weight the card keeps,
   with the body that ran, "gemv" at M <= 16 or "wgmma", the bf16 output
   ``linear`` asks for, a bf16 ``torch.matmul`` beside the int8 yardstick,
   the pack's time and, for the wgmma body, its activation pass alone),
   flash prefill (with the body that ran:
   the tensor-core body for bf16 and, over two-term splits, for f32
   inputs) and paged decode (with NaN in the trash block of its bf16 or
   f32 pools, and its instantiation's ptxas line), then the
   int8-KV kernels qdecode, paged_qdecode (with NaN scales and -128 codes
   in the trash block) and flash_qprefill (with the body that ran and its
   instantiation's ptxas line), then the int4-KV kernels paged_q4decode
   (with NaN f16 scales and 0x88 bytes in the trash block, and its
   instantiation's ptxas line) and flash_q4prefill (with the body that ran
   and its instantiation's ptxas line); the decode kernels and the
   quantized prefills also bit-identical across two calls; the int4 KV
   quantizer's edge groups, card against
   CPU, and quantize_weights at phi-3-vision's weight shapes and
   stablelm-1.6b's embedding (codes and scales bit for bit, each row with
   the route and plan that ran and its ptxas line; both routes, the
   cluster and the two-pass one, must run); the GEMMs and flash prefill
   also run at the VQI forward's shapes (M 4632 at phi-3-vision's five
   weight shapes; B8 S579 H32 hd96), and flash prefill at MLA's 192 / 128
   width class (MLA_FLASH: one 1024-token deepseek-v2 prefill on the bf16
   class's wgmma body, ``MLA_BODY``, with the class's ptxas lines);
2a. tiles: every (block_q, block_k) each flash body instantiates
   (``autotune.TILES``) at every TILE_SHAPES shape (FLASH_SHAPES and the
   main paths' other keys) and MLA_FLASH, for flash_prefill, flash_qprefill
   and flash_q4prefill: held against the plain version and timed twice
   (graph replay, L2 flushed), beside the analytic winner of the ``cuda``
   key, the 64 x 64 tile, the fastest, the bound and SDPA; then one prefill
   under REPRO_TILE_BQ / REPRO_TILE_BK pinned to PIN_TILE (that tile must
   launch), and pairs no body instantiates refused by the wrapper and by
   the C entries, which launch nothing;
3. e2e: stablelm-1.6b at full width and SERVE_LAYERS of its 24 layers in
   bf16 with random seeded weights, the
   three default variants (fp32 passthrough, dynamic int8, static int8
   calibrated on 2 batches of 2 x 128 tokens) and dynamic int8 over an
   int8 and over an int4 KV cache, 4 requests served through a
   RequestQueue -> InferenceSession.generate, with every kernel's launch
   counter zeroed before and read after;
4. engine: stablelm-1.6b at full width in bf16 behind the paged
   ContinuousBatchingEngine (8 slots, 16-token blocks, a 65-block pool
   small enough to preempt) and then the dense one, replaying a seeded
   trace of 16 greedy requests (4 share a 128-token prefix) through
   ``loadgen.replay``, for the fp32-passthrough and dynamic-int8 variants
   and dynamic int8 over an int8 KV cache (paged, dense, and paged with
   the bf16 pool's bytes) and over an int4 KV cache (paged, dense), every
   replay at SERVE_LAYERS of the 24 layers, with
   every kernel's launch counter zeroed before each replay and read after
   it, plus a timed and profiled window of batched decode steps; then one
   request of the trace teacher-forced through the paged and the dense
   path on the card (the fp32-passthrough replay's weights and depth), its
   per-step logit difference beside the card's own one-rounding nudge and
   the top-1 / top-2 margin where the replay's streams part;
4a. backends: the kernel Backend registry on stablelm-1.6b at full width
   and BACKENDS_LAYERS layers, one dynamic-int8 artifact: sessions
   unpinned, pinned ``cuda`` and pinned ``ref`` in one process (the
   kernels launch under ``cuda`` and unpinned, none under ``ref``; logits
   within 2.5x the ``ref`` session's nudge; greedy streams equal or
   parted at a tie; each pin's host ms a decode step, launches and device
   profile; the registry's host us a call against the kernel entry's),
   then an engine pinned ``cuda-tp`` at tp=2 launching each per-shard
   kernel twice as often as the ``cuda`` engine, and a spec engine pinned
   ``cuda`` whose ``ref`` draft launches nothing;
5. card vs CPU: the same fp32 weights at full width and 2 layers, the CPU's
   plain path against the card's kernel path on one prompt plus 8
   teacher-forced decode steps, dense and then paged (a block table with
   scattered ids and a -1 tail), over an fp, an int8 and an int4 KV cache;
6. VQI: phi-3-vision-4.2b at its published width and VQI_LAYERS of its 32
   layers (576 patch tokens), bf16, random seeded weights, its three variants
   (static calibrated on 2 VQI batches) published into a registry in a
   temporary directory, each activated by its own ``EdgeAgent`` and served
   through ``fleet.vqi.inspection_pipeline`` behind a RequestQueue, 16
   captures in batches of 8, launch counters zeroed before and read after;
   then the lifecycle through an ``ArtifactRegistry`` at published width
   and LIFECYCLE_LAYERS layers in f32 (publish v1's variants, a staged
   rollout with ``HealthGate()`` to one standard and one Pi-4-class device
   on the card, inspections pushing telemetry, a noised v2 whose rollout
   fails its gate and rolls back; then one device's lifecycle latencies);
   then card vs CPU logits on a teacher-forced VQI batch at 2 layers, fp32,
   dynamic int8 and static int8 (calibrated on the CPU);
7. train: the flash_prefill autograd Function's (dq, dk, dv) against
   torch.autograd through the plain version (f32, bf16, GQA at hd 96),
   every other kernel wrapper refusing a grad, then stablelm-1.6b at its
   published width and depth in f32 (remat on) trained by ``fit`` on
   ``lm_stream`` batches of 8 x 128: 6 steps with fp32 moments and 3 with
   int8 moments, each step's loss, grad norm, ms, tokens/s and flash
   launches (2 per layer), and the peak device memory; then production:
   the ``--production`` launcher (``repro_torch.launch.train``: the full
   config's sharded step on JAX's 16 x 16 pod mesh, traced on fake
   tensors) run on the host in a subprocess started with the script,
   its roofline and memory JSON and its trace time; stablelm-1.6b's mesh
   train step on the card: PROD_STEPS ``train_step``s on a world-of-1
   ``("data", "model") = (1, 1)`` DTensor mesh (params, moments and
   batches laid out by the GSPMD rules, ``constrain`` live, every
   attention layer's ``flash_tc`` through ``local_map``, forward and
   recompute) against as many unsharded steps from the same params and
   batches (losses and grad norms within PROD_TOL), flash launches per
   step (2 per layer), ms per step, the peak memory of the first mesh
   step, and the dry-run's prediction of that step (``launch.dryrun`` on
   a (1, 1) fake world, in a second host subprocess): flops, peak bytes,
   their ratio to the measured ones and the achieved share of the dense
   tensor peak;
8. vqi_loop: the paper's loop at ``vqi_config()``: train the VQI model
   (asset accuracy > 0.9), publish v1's three variants, a staged rollout
   gated on VQI task accuracy, inspections pushing telemetry, a noised v2
   that fails its gate and rolls back, a retrain from the telemetry
   published as v3, whose rollout passes;
9. chunked: stablelm-1.6b at full width and depth in bf16, a 255- and a
   600-token prompt prefilled through the flash kernels and through the
   chunked core (``opt_flash_prefill=False``, plain PyTorch), with and
   without ``opt_attn_accum``, over the fp, int8 and int4 tiers: logits
   held to 2.5x the card's one-rounding nudge, layer 0's cache codes equal
   on both paths;
10. dense_configs: phi3-mini-3.8b and deepseek-7b (bf16, and deepseek-7b
   as dynamic int8) at published width and depth: a prefill, 8 decode
   steps and ``generate`` behind a RequestQueue, ms and peak memory;
11. quant_modes: stablelm-1.6b's int4 (g 64), per-group int8 (g 128),
   percentile-clipped and asymmetric variants quantized on the card, codes
   and scales bit for bit against the CPU's (the unembedding's 205 M
   elements included), sizes, logit deltas against bf16 and 8-slot decode
   steps beside dynamic int8's;
12. spec: stablelm-1.6b bf16 (SPEC_LAYERS of its 24 layers) as the
   target, its dynamic-int8 and int4
   drafts published with ``draft_of`` and resolved through
   ``Deployment.spec_config``, the engine trace served paged and dense with
   and without each draft, every spec stream held to the non-spec one (a
   parting's margin to the card's nudge), then one sampled request alone
   and inside the trace;
13. moe_mla: deepseek-v2-236b (MLA + MoE) at its published width and 4 of
   60 layers in bf16 and as dynamic int8, kimi-k2-1t-a32b (GQA + MoE) at 2
   of 61 layers in bf16: the queue, the dense and paged engines over an
   8-request trace (an 8-slot decode step profiled), paged against dense
   streams (``moe_partings``), flash against chunked prefill and naive
   against absorbed decode within 2.5x the nudge, a spec replay with the
   int8 variant drafting for the bf16 target, the routing card against
   CPU at 2 layers; ``fraction_dropped``, peak memory and the flash
   launches per width class (every MLA prefill in the 192 / 128 class,
   every bf16 one on its wgmma body);
14. recurrent: mamba2-780m (12 of its 48 SSD layers, tied embeddings) in
   bf16 and as dynamic int8, and recurrentgemma-9b (11 of its 38 layers: 3
   (rec, rec, attn) groups and 2 recurrent tail layers, MQA 16 x 256 over a
   2048-slot ring) in bf16 and as dynamic int8 over fp, int8 and int4 KV
   caches, at published width (REC_LAYERS): the queue, the dense engine over an
   8-request trace (an 8-slot decode step profiled; every int8-KV decode
   through ``qdecode``'s wide class, its tensor-core body
   ``qdecode_wide_tc``), a 300-token mamba2 prompt on the
   sequential SSD path, a 2100-token recurrentgemma prompt that wraps the
   ring, paged and speculative engines refused, and card against CPU at
   4 layers (the hybrid's one group and one tail layer) within 2.5x the
   CPU's one-rounding nudge;
15. musicgen: musicgen-large at published width and MUSIC_LAYERS of its 48
   layers (4 codebooks, 64 conditioning frames a request) in bf16 and as dynamic
   int8 over the fp and the int8 KV cache: the queue (``generate`` of [1,
   S, 4] prompts), the dense engine over an 8-request trace (an 8-slot
   decode step profiled), paged and speculative engines refused, and card
   against CPU at 4 layers ([1, 1, 4, 2048] logits a step);
16. frontend: phi-3-vision at published width (FRONTEND_LAYERS of 32
   layers) serving requests of 576 patch embeds through the dense and the
   paged engine (an 8-slot decode step of each profiled), no prefix hit,
   paged streams held to the dense ones (a parting only at a tie);
17. router: stablelm-1.6b at SERVE_LAYERS behind a ``ServingRouter`` of 1
   prefill and 2 decode workers on one ``SharedKVPool`` against one
   engine over a 24-request trace: virtual-time metrics of both arms,
   wall time per tick, 0 prompt tokens recomputed, streams equal or parted
   at a tie, 4 busy router ticks profiled; then one handoff per KV tier
   (bf16, int8, int4) held to one engine;
18. tp: tensor-parallel serving, mistral-nemo-12b at published width
   (TP_LAYERS of its 40 layers) in bf16, a tp=1 and a tp=2 engine with
   both shards on the one card, dense and paged over the fp, int8 and
   int4 KV caches, an 8-request trace: tp=2 streams equal tp=1's or part
   at a tie (``_partings``), each per-shard kernel launched tp x the tp=1
   count (the per-shard shapes Hq 16, Hkv 4, hd 128), the psum combine's
   logits within 2.5x the one-rounding nudge of the exact combine's, an
   8-slot paged step profiled at each tp, per-shard KV bytes and the peak
   memory; then deepseek-v2's MLA attention (no experts) at 2 layers,
   ``flash_mla`` at 64 heads a shard, tp=2 streams against tp=1;
19. fleet: the fleet simulator (``Deployment.simulator``) and its
   ``EnginePool``: stablelm-1.6b at published width and LIFECYCLE_LAYERS
   layers in f32, v1 and v2 published with the fleet example's three
   variants (each variant's bytes against each device class's memory), a
   1000-device heterogeneous fleet on the card rolled out with the
   example's policy and faults, v2 regressed: v1 completes, v2 aborts and
   rolls back; ~280 real forwards through the pool's shared sessions (every
   call counted, no agent error), each variant's forward card against CPU;
   a paged engine per device class at ``fleet_bench``'s KV fraction over 12
   shared-prefix prompts (lite fewer blocks and at least as many
   preemptions as std; streams equal ``generate`` or part at a tie), the
   std class at tp=2 (half the per-shard bytes), the pi4 class's router (0
   prompt tokens recomputed), the serving launcher
   (``repro_torch.launch.serve``) on the fp32 artifact's checkpoint; the
   phase's launches: flash_prefill, both int8 GEMMs and paged_decode, no
   other kernel;
20. held_shapes: every flash-prefill, qdecode, paged-decode (fp, int8,
   int4) and int8-GEMM shape the main paths gave a kernel, held against
   the plain version (a flash prefill at the tile the ``cuda`` leg
   resolved for it);
21. a ``kernels`` line (flash_prefill with its launches per width
   class, each flash prefill's launches per tile and its tile sweep's
   winner / 64 x 64 / fastest ms per shape, qdecode with its wide class,
   each kernel's launches on the fleet path), the ``nvidia-smi`` line, and
   last the device line.

Every counted run also checks that each flash_prefill, flash_qprefill and
flash_q4prefill launch took the body of its dtype (``launches_by_body``;
a bf16 flash_prefill of the 192 / 128 class the wgmma body) and the tile
the ``cuda`` leg resolved for it (``launches_by_tile`` against
``RESOLVED_TILES``),
each engine
window's profile names its attention kernel once per layer, and the GEMMs'
bodies are checked where M is known: the one-launch decode body at every
decode step, the wgmma body in the VQI forwards and the 256-row prefill
(whose unembed reads the last row only: one decode-body launch). Any failed check
raises and the exit code is non-zero. Without a CUDA
device, or outside the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import types

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# H100 SXM published peaks (dense): HBM bytes/s and operations/s by type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "bfloat16": 989e12, "float32": 67e12}

# decode (4 and the engine's 8 slots), the longest batch-1 prompt (255),
# prefill chunks
GEMM_MS = (4, 8, 255, 1024, 1023)
GEMM_KN = ((2048, 2048), (2048, 11264), (5632, 2048), (2048, 100352))
# phi-3-vision's VQI forward (8 images x 579 positions): wq, wi, wo,
# frontend_proj and unembed, whose N leaves a 64-column tail in the last
# 128-wide tile
VQI_GEMM_M = 8 * 579
VQI_GEMM_KN = ((3072, 3072), (3072, 16384), (8192, 3072), (1024, 3072),
               (3072, 32064))
# deepseek-7b's dynamic-int8 linears on the dense_configs path: wq/wk/wv/wo,
# the fused wi (2 x 11008), wo of the MLP at a batch-1 decode step and at
# the 64- and 128-token prefills (prompts padded to their power-of-two
# bucket), and the unembed at the last position only
DENSE_GEMM_MS = (1, 64, 128)
DENSE_GEMM_CASES = ((4096, 4096, DENSE_GEMM_MS), (4096, 22016, DENSE_GEMM_MS),
                    (11008, 4096, DENSE_GEMM_MS), (4096, 102400, (1,)))
GEMM_CASES = tuple((kk, n, GEMM_MS) for kk, n in GEMM_KN) + tuple(
    (kk, n, (VQI_GEMM_M,)) for kk, n in VQI_GEMM_KN) + DENSE_GEMM_CASES
HEADLINE_GEMM = (4, 2048, 11264)          # a decode GEMM (wi of one layer)
# (B, S, Hq, Hkv, hd, dv, dtype)
FLASH_SHAPES = ((4, 256, 32, 32, 64, 64, torch.bfloat16),
                (2, 300, 32, 8, 128, 128, torch.bfloat16),
                (2, 200, 16, 16, 128, 64, torch.bfloat16),
                (1, 64, 32, 32, 64, 64, torch.float32))
HEADLINE_FLASH = FLASH_SHAPES[0]
# phi-3-vision's VQI forward: 576 patch tokens + 3 text tokens, hd 96 (S not
# a multiple of the kernel's 64-row tile)
FLASH_SHAPES += ((8, 579, 32, 32, 96, 96, torch.bfloat16),
                 (8, 579, 32, 32, 96, 96, torch.float32))
# the chunked phase's flash side: stablelm-1.6b's 255- and 600-token
# prompts, unpadded; the dense_configs phase: phi3-mini-3.8b (hd 96) and
# deepseek-7b (hd 128) at batch 1, their 64- and 128-token buckets
FLASH_SHAPES += tuple((1, s, 32, 32, 64, 64, torch.bfloat16)
                      for s in (255, 600)) + tuple(
    (1, s, 32, 32, hd, hd, torch.bfloat16) for hd in (96, 128)
    for s in (64, 128))
# the MLA width class: one 1024-token deepseek-v2 prefill of one layer at
# its published width (128 heads, hd = qk_nope 128 + qk_rope 64, dv 128)
# (flash_prefill only: the quantized prefills stay at 128)
MLA_FLASH = (1, 1024, 128, 128, 192, 128, torch.bfloat16)
# f32 reference on the same values; the tensor-core body's bf16 products
# are exact in f32, p is split into two bf16 terms (bf16 inputs: ~1e-5), and
# f32 inputs are split too (three products per mma: ~2e-5); summation order
# differs
FLASH_ATOL = 1e-4
# paged decode: (B, Hkv, G, hd, block size, table entries, pool blocks,
# pool dtype, positions: None = drawn in 36..511, idle rows have -1)
PAGED_SHAPES = {
    "a": (8, 32, 1, 64, 16, 32, 257, torch.bfloat16, None),   # stablelm
    "b": (8, 8, 4, 128, 16, 32, 257, torch.bfloat16, None),   # nemo width
    "c": (1, 32, 1, 64, 16, 32, 257, torch.bfloat16, (511,)),
    "d": (8, 32, 1, 64, 16, 32, 257, torch.float32, None),
    "e": (4, 32, 1, 64, 16, 32, 257, torch.bfloat16, (300, -1, 45, 511)),
    # one long sequence (4096 slots, 256 entries); phi-3-vision's hd 96;
    # blocks of one slot (a 512-entry table)
    "f": (1, 32, 1, 64, 16, 256, 300, torch.bfloat16, (4095,)),
    "g": (8, 32, 1, 96, 16, 40, 330, torch.bfloat16, None),
    "h": (2, 32, 1, 64, 1, 512, 1100, torch.bfloat16, (511, 300)),
}
HEADLINE_PAGED = "a"
PAGED_ATOL = 1e-4     # f32 on both sides; online vs one-pass softmax
# int8-KV dense decode: (B, S, Hkv, G, hd, q dtype, positions: None = drawn
# in 36..511; the bias is 0 up to each position and -2e38 after it)
QDECODE_SHAPES = {
    "a": (8, 512, 32, 1, 64, torch.bfloat16, None),     # stablelm engine
    "b": (8, 512, 8, 4, 128, torch.bfloat16, None),     # nemo width
    "c": (1, 512, 32, 1, 64, torch.bfloat16, (511,)),
    "d": (8, 512, 32, 1, 64, torch.float32, None),
    # one long sequence; phi-3-vision's hd 96 over its 579 positions
    "e": (1, 4096, 32, 1, 64, torch.bfloat16, (4095,)),
    "f": (8, 579, 32, 1, 96, torch.bfloat16, None),
    # the wide class: recurrentgemma-9b's 16 x 256 over one kv head, its
    # engine's 2048-slot ring at 8 slots
    "w": (8, 2048, 1, 16, 256, torch.bfloat16, None),
}
HEADLINE_QDECODE = "a"
WIDE_QDECODE = "w"
# int8 kernels against plain versions: f32 on both sides; the kernels scale
# after the dot, the plain versions dequantize first
INT8KV_ATOL = 1e-4
# the engine phase: a pool of 64 usable 16-token blocks (1024 tokens) for
# 8 slots whose requests average ~146 + 32 tokens, so preemption happens
ENGINE = {"n_slots": 8, "max_len": 512}
PAGED = {"paged": True, "block_size": 16, "n_blocks": 65}
# the queue (e2e) and the engine replays run the first 6 of
# stablelm-1.6b's 24 layers: every kernel and KV tier is still on them,
# the counting metrics depend on the trace only, and the run stays inside
# its time limit on the slowest recorded host (1206.6 s in first position
# at 12 layers and the other depths doubled)
SERVE_LAYERS = 6
# the backends phase: stablelm-1.6b at published width, cut to 4 of its
# 24 layers (the per-shard launch counts of the cuda-tp engine depend on
# the trace only), two prompts, a 4-request trace, 16 new tokens each
BACKENDS_LAYERS = 4
BACKENDS_PROMPTS = (64, 200)
BACKENDS_NEW = 16
BACKENDS_TRACE_N = 4
BACKENDS_STEPS = 16
BACKENDS_ROUNDS = 3
REGISTRY_CALLS = 2000
# a torch.profiler trace can lose a kernel record (one of 96 seen once on
# the H100): a trace that shows fewer launches of its watched kernel than
# the wrapper counted is taken again, at most this many times in all
PROFILE_ATTEMPTS = 3
TRACE_N, TRACE_PROMPT, TRACE_GAP = 16, (37, 255), 2.0
SHARED, SHARED_PREFIX = (4, 5, 6, 7), 128
PROMPT_LENS = (37, 120, 200, 255)
N_NEW = 32
# card vs CPU logits, as (max |diff|, worst step's mean |diff|).
# fp32: f32 matmuls and transcendentals in another order (~1e-5 seen).
# dynamic_int8: a change of one f32 rounding moves a row's absmax and so
# every code of that row; at 2 layers this alone moves the CPU's own logits
# by max 0.105 / mean 0.018 (relative nudge of 1e-7 to every normalized
# activation), against an int8-vs-fp32 quantization error of 0.33 / 0.051.
# The bound is twice the nudge, below the quantization error.
# fp32_int8kv (fp32 weights over the int8 KV cache): the same nudge flips
# K/V codes at .5 quotients and so moves the CPU's own logits by max
# 0.00405 / mean 0.00076 (dense and paged alike); the bound is 2.5 times
# that. fp32_int4kv (fp32 weights over the int4 KV cache): one code step
# is 1/7 of a group's absmax, so the same nudge moves the CPU's own logits
# by max 0.0618 / mean 0.0110 (dense and paged alike, measured on the CPU
# with this script's teacher_forced and nudged_norms); the bound is about
# 2.5 times that. card_vs_cpu prints the nudge of every run beside its
# error.
# vqi_* (phi-3-vision, published width, 2 layers, f32, a teacher-forced
# forward of 2 VQI images, 579 positions each): the same nudge moves the
# CPU's own logits by max 3.3e-6 / mean 3.7e-7 with fp32 weights and by max
# 0.078 / mean 0.0085 with dynamic-int8 weights and by max 0.089 / mean
# 0.0109 with static-int8 weights calibrated on 2 VQI batches of 2 (measured
# on the CPU with vqi_card_vs_cpu_phase). fp32 keeps the fp32 bound
# (summation order, not the nudge, sets it); each int8 bound is about 2.5
# times its own nudge.
CPU_TOL = {"fp32": (2e-3, 2e-4), "dynamic_int8": (0.2, 0.03),
           "fp32_int8kv": (1e-2, 2e-3), "fp32_int4kv": (0.15, 0.03),
           "vqi_fp32": (2e-3, 2e-4), "vqi_dynamic_int8": (0.2, 0.02),
           "vqi_static_int8": (0.22, 0.027)}


# quantize_weights at phi-3-vision's weight shapes (wq, wi, wo, frontend_proj,
# unembed), then the JAX package's ragged test shapes, then stablelm-1.6b's
# embedding leaf, taller than a cluster holds (the two-pass route); (K, N)
QW_SHAPES = ((3072, 3072), (3072, 16384), (8192, 3072), (1024, 3072),
             (3072, 32064), (48, 33), (300, 96), (100352, 2048))
HEADLINE_QW = (3072, 16384, torch.bfloat16)
# the VQI phases: phi-3-vision-4.2b at its published width; 16 captures
# served in batches of 8; static calibration on 2 VQI batches of 8
VLM = "phi-3-vision-4.2b"
# the VQI phase serves 4 of its 32 layers: the per-image work and the
# registry writes and reads of each variant (~3.4 s a GB, twice) shrink
# with the depth, which the run's time limit needs
VQI_LAYERS = 4
VQI_CAPTURES, VQI_BATCH = 16, 8
# the lifecycle through the registry runs 2 of the 32 layers in float32:
# one fp32 artifact of the full model is 15.3 GB on disk, written per
# version and read again (sha256 + load) by every device at install and
# activate
LIFECYCLE_LAYERS = 2
# training: stablelm-1.6b at published width and depth in f32 (remat on, its
# default), lm_stream batches of 8 x 128; fit with fp32 moments, then with
# int8 moments
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ = "stablelm-1.6b", 8, 128
TRAIN_STEPS, TRAIN_INT8_STEPS = 6, 3
# the mesh train step: PROD_STEPS steps of TRAIN_ARCH at the train phase's
# width, depth, dtype and batch on a world-of-1 DTensor mesh, against as
# many unsharded steps (the first of each warms up; rates read the rest);
# losses and grad norms within PROD_TOL (relative: the train phase's f32
# tolerance, FLASH_GRAD_TOL's)
PROD_STEPS = 2
PROD_TOL = 1e-4
# the flash Function's (dq, dk, dv) against torch.autograd through the
# plain version, (B, S, Hq, Hkv, hd, dtype): the training shape in f32 and
# bf16, and a GQA case at hd 96
FLASH_GRAD_SHAPES = ((8, 128, 32, 32, 64, torch.float32),
                     (8, 128, 32, 32, 64, torch.bfloat16),
                     (8, 128, 32, 8, 96, torch.float32))
# max |got - want| / max |want| per grad, want in f32. f32: the forward's
# output (the kernel's, ~2e-5 from the plain one) enters rowsum(dout *
# out); bf16: the grads come back in bf16, so one bf16 rounding, up to
# 2**-8 of each element: the bound is one bf16 ulp of the largest (2**-7)
FLASH_GRAD_TOL = {torch.float32: 1e-4, torch.bfloat16: 8e-3}
# the paper's loop at vqi_config() (the width at which both packages train
# the VQI family): 150 training steps of batch 32, a retrain of 60 steps
# from the fleet's telemetry; inspections of 32 captures per device
VQI_TRAIN_STEPS, VQI_TRAIN_BATCH, VQI_LOOP_CAPTURES = 150, 32, 32
VQI_RETRAIN_STEPS = 60
# the field captures' noise (training draws at 0.6): heavy enough that
# a share of the inspections is low-confidence or wrong and goes back to the
# hub's retrain buffer
VQI_FIELD_NOISE = 8.0
# the chunked prefill: one and two query chunks of 512 (the second padded)
CHUNK_PROMPTS = (255, 600)
# phi3-mini and deepseek-7b at published width and depth: a 128-token
# prefill and 8 decode steps
DENSE_ARCHS, DENSE_PROMPT, DENSE_STEPS = ("phi3-mini-3.8b", "deepseek-7b"), 128, 8
DENSE_QUEUE = (37, 100)     # the RequestQueue's two prompts
# speculative decoding: draft tokens proposed per verify step
SPEC_K = 3
# MoE and MLA at published width: deepseek-v2 (MLA + MoE) at 4 of its 60
# layers (1 dense + 3 MoE: 13.30 B parameters, 26.6 GB in bf16) and kimi-k2
# (GQA + MoE) at 2 of its 61 (1 dense + 1 MoE: 19.97 B, 39.9 GB in bf16;
# bf16 only: its int8 experts would dequantize through 45 GB of f32);
# a trace of 8 requests, prompts of 32-128 tokens, 16 new tokens each;
# the routing card vs CPU at deepseek-v2's width and 2 layers (10.7 GB)
MOE_DEPTH = {"deepseek-v2-236b": 4, "kimi-k2-1t-a32b": 2}
MOE_TRACE_N, MOE_PROMPT, MOE_NEW = 8, (32, 128), 16
MOE_ROUTE_DEPTH, MOE_ROUTE_PROMPT, MOE_ROUTE_STEPS = 2, 32, 4
# the recurrent models at published width and REC_LAYERS (about a quarter
# of their 48 / 38 layers: the run's time limit; recurrentgemma keeps 3
# (rec, rec, attn) groups and its 2 tail layers): a trace of 8
# requests (prompts of 32-128 tokens, 16 new each) on 8 dense-engine slots
# of REC_ENGINE_LEN tokens, or of the window where that is longer
# (recurrentgemma's engine must hold its 2048-slot ring); mamba2's 300-token prompt takes the sequential SSD path
# (256 does not divide it); recurrentgemma's 2100-token prompt wraps the
# ring in the prefill, its 8 decode steps wrap it again; card against CPU
# at REC_CPU_DEPTH layers in f32 (the hybrid: one group and one tail layer)
REC_ARCHS = ("mamba2-780m", "recurrentgemma-9b")
REC_LAYERS = {"mamba2-780m": 12, "recurrentgemma-9b": 11}
REC_TRACE_N, REC_PROMPT, REC_NEW = 8, (32, 128), 16
REC_ENGINE_LEN = 512
REC_SEQ_PROMPT, REC_RING_PROMPT, REC_RING_NEW = 300, 2100, 8
REC_CPU_DEPTH, REC_CPU_PROMPT = 4, 48
# the spec phase's target and drafts at 4 of stablelm-1.6b's 24 layers:
# the counting and parting checks do not depend on depth, and the run
# stays inside its time limit with the later phases
SPEC_LAYERS = 4
# musicgen-large at published width and MUSIC_LAYERS of its 48 layers (the
# run's time limit; 4 codebooks of 2048, 64 conditioning frames of 1024 a
# request): the queue, the dense
# engine (8 slots of MUSIC_ENGINE_LEN) over a trace of 8 requests of
# 32-128 tokens x 16 new; card against CPU at MUSIC_CPU_DEPTH layers in
# f32 (one prompt of MUSIC_CPU_PROMPT tokens x 4 codebooks)
MUSIC = "musicgen-large"
MUSIC_LAYERS = 12
MUSIC_TRACE_N, MUSIC_PROMPT, MUSIC_NEW = 8, (32, 128), 16
MUSIC_ENGINE_LEN = 512
MUSIC_CPU_DEPTH, MUSIC_CPU_PROMPT = 4, 32
# frontend requests: phi-3-vision at published width and FRONTEND_LAYERS
# of its 32 layers (the VQI phase's cut), a trace of 8 requests of 576
# patch embeds and 8-128 prompt tokens x 16 new, dense and paged engines
# of 8 slots of FRONTEND_LEN (576 + 128 + 16 fit)
FRONTEND_LAYERS = VQI_LAYERS
FRONTEND_TRACE_N, FRONTEND_PROMPT, FRONTEND_NEW = 8, (8, 128), 16
FRONTEND_LEN = 768
# the router: stablelm-1.6b at SERVE_LAYERS, a trace of 24 requests of
# 32-255 tokens x 16-32 new; 1 prefill and 2 decode workers of
# ROUTER_SLOTS slots on one pool of twice the single 8-slot engine's
# capacity (the single arm gets the same pool); one handoff per KV tier on
# a pool of ROUTER_HANDOFF_BLOCKS
ROUTER_TRACE_N, ROUTER_PROMPT, ROUTER_NEW = 24, (32, 255), (16, 32)
ROUTER_SLOTS = 4
ROUTER_HANDOFF_BLOCKS = 64
# tensor-parallel serving: mistral-nemo-12b at published width and
# TP_LAYERS of its 40 layers in bf16 (24.5 GB at full depth, the tp=2
# shards' column slices 14.3 GB more), engines of 8 slots of TP_LEN over
# a trace of 8 requests of 32-128 tokens x 16 new; deepseek-v2's MLA
# attention (n_experts=0, as the JAX package's TP tests take it) at
# TP_MLA_LAYERS. At 40 layers the phase takes ~300 s, more than this
# run has left of its time: scripts/tp_probe.py runs it at the published
# depth, TP_PUBLISHED_LAYERS
TP_MODEL, TP_MLA_MODEL = "mistral-nemo-12b", "deepseek-v2-236b"
TP_LAYERS, TP_MLA_LAYERS, TP_PUBLISHED_LAYERS = 4, 2, 40
TP_TRACE_N, TP_PROMPT, TP_NEW = 8, (32, 128), 16
TP_LEN = 256
# the fleet simulator: stablelm-1.6b at published width and
# LIFECYCLE_LAYERS (2) layers in f32, the JAX example's artifacts at real
# sizes (fp32 ~2.1 GB, int8 ~1.1 GB). FLEET_DEVICES devices inspect every
# FLEET_INTERVAL virtual s: transfers of these sizes make the rollouts last
# ~36k virtual s, over which the example's 20 s gives ~1M inspections (a
# ~35 s event loop on the host), 120 s ~280k; every FLEET_REAL_EVERY-th
# inspection runs a real [2, 64] forward (~280 in all). The horizon is
# FLEET_HORIZON_TRANSFERS times the slowest class transfer (a lite
# device's int8 artifact over 8 Mbit/s on a slowed link) plus a wave's
# longest gate: v1's four waves take ~4.3 of it, v2's canary ~1 more.
# Per-class engines of 2 slots of 32 over 8-token blocks serve 12 prompts
# of a shared 8-token prefix + 4 tokens, 8 new tokens each
# (``fleet_bench``'s KV-pressure traffic)
FLEET_DEVICES, FLEET_INTERVAL, FLEET_REAL_EVERY = 1000, 120.0, 1000
FLEET_REAL_BATCH = (2, 64)
FLEET_HORIZON_TRANSFERS = 8
FLEET_BLOCK, FLEET_PROMPTS, FLEET_NEW = 8, 12, 8


T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line per phase result; ``t_s`` is the script's elapsed
    time when it was printed."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": time.perf_counter() - T0}), flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    return out.splitlines()[0]


def bound(nbytes: float, ops: float, op_type: str):
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[op_type] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Per-call time in ms from CUDA events, averaged over ``iters`` calls,
    with a 256 MB buffer rewritten before each call so the call finds its
    inputs outside the 50 MB L2, as a decode step does with each layer's
    weights. ``graph_ms`` replays the call captured in a CUDA graph: device
    time without the host's launch gaps. ``eager_ms`` times the Python call
    itself, gaps included, as the eager main path pays it."""

    def __init__(self, device):
        self.flush = torch.empty(64 * 2**20, dtype=torch.int32, device=device)

    def _timed(self, call, iters):
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            call()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters

    def eager_ms(self, fn, iters: int = 10):
        fn()
        torch.cuda.synchronize()
        return self._timed(fn, iters)

    def graph_ms(self, fn, iters: int = 10):
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        t = self._timed(graph.replay, iters)
        del graph
        return t


def _wrappers(k):
    return {"flash_prefill": k.flash_prefill.flash_prefill,
            "qmatmul_dynamic": k.dynquant.qmatmul_dynamic,
            "qmatmul_static": k.qmatmul.qmatmul_static,
            "paged_decode": k.paged_attn.paged_decode,
            "qdecode": k.qdecode.qdecode,
            "paged_qdecode": k.paged_attn.paged_qdecode,
            "flash_qprefill": k.flash_prefill.flash_qprefill,
            "paged_q4decode": k.paged_attn.paged_q4decode,
            "flash_q4prefill": k.flash_prefill.flash_q4prefill,
            "quantize_weights": k.quantize.quantize_weights}


def _gemms(k):
    return {"qmatmul_dynamic": k.dynquant.qmatmul_dynamic,
            "qmatmul_static": k.qmatmul.qmatmul_static}


def _flash(k):
    """The flash prefills, whose launches are counted per body too."""
    fp = k.flash_prefill
    return {"flash_prefill": fp.flash_prefill,
            "flash_qprefill": fp.flash_qprefill,
            "flash_q4prefill": fp.flash_q4prefill}


def reset_counters(k):
    for fn in _wrappers(k).values():
        fn.launches = 0
    routes = k.quantize.quantize_weights.routes
    for route in routes:
        routes[route] = 0
    for fn in (*_flash(k).values(), *_gemms(k).values()):
        bodies = fn.launches_by_body
        for body in bodies:
            bodies[body] = 0
    for classes in (k.flash_prefill.flash_prefill.launches_by_class,
                    k.qdecode.qdecode.launches_by_class,
                    *(fn.launches_by_tile for fn in _flash(k).values()),
                    *RESOLVED_TILES.values()):
        for c in classes:
            classes[c] = 0


def read_counters(k):
    """Launches per wrapper, the GEMMs' per body (``qmatmul_dynamic.gemv``,
    ``qmatmul_dynamic.wgmma``, ...), quantize_weights' per route
    (``quantize_weights.cluster``, ``quantize_weights.two_pass``),
    flash_prefill's per width class (``flash_prefill.class.192x128``),
    qdecode's per class (``qdecode.class.wide``) and each flash prefill's
    per tile (``flash_prefill.tile.tc:64x64``). Each flash prefill's
    launches per tile must equal the tiles the ``cuda`` legs resolved for
    the calls since ``reset_counters`` (``RESOLVED_TILES``, kept by
    ``recording_shapes``), else it raises."""
    out = {name: fn.launches for name, fn in _wrappers(k).items()}
    out.update({f"quantize_weights.{route}": n for route, n in
                k.quantize.quantize_weights.routes.items()})
    for name, fn in _gemms(k).items():
        out.update({f"{name}.{body}": n
                    for body, n in fn.launches_by_body.items()})
    out.update({f"flash_prefill.class.{c}": n for c, n in
                k.flash_prefill.flash_prefill.launches_by_class.items()})
    out.update({f"qdecode.class.{c}": n for c, n in
                k.qdecode.qdecode.launches_by_class.items()})
    for name, fn in _flash(k).items():
        got = {t: n for t, n in fn.launches_by_tile.items() if n}
        want = {t: n for t, n in RESOLVED_TILES.get(name, {}).items() if n}
        if got != want:
            raise AssertionError(f"{name}: launches by tile {got}, the cuda "
                                 f"legs resolved {want}")
        out.update({f"{name}.tile.{t}": n
                    for t, n in fn.launches_by_tile.items()})
    return out


def _merge(totals, launches):
    """Adds one run's counters into ``totals``, key by key."""
    for name, n in launches.items():
        totals[name] = totals.get(name, 0) + n


def check_gemm_bodies(where, launches, gemv=None):
    """Each GEMM that launched in a run took the one-launch decode body
    ``gemv`` times (None: every time) and the ``wgmma`` body the rest."""
    for name in ("qmatmul_dynamic", "qmatmul_static"):
        total = launches[name]
        want = total if gemv is None or total == 0 else gemv
        split = {b: launches[f"{name}.{b}"] for b in ("gemv", "wgmma")}
        if split != {"gemv": want, "wgmma": total - want}:
            raise AssertionError(f"{where}: {name} launches by body {split}, "
                                 f"want {want} gemv of {total}")


def read_bodies(k, name="flash_prefill"):
    """A flash prefill's launches per body (``flash_prefill.BODY`` /
    ``QBODY`` / ``Q4BODY``)."""
    return dict(_flash(k)[name].launches_by_body)


def check_bodies(k, where, launches, dtype):
    """Every flash_prefill, flash_qprefill and flash_q4prefill launch of a
    run took the body of its dtype, and every bf16 flash_prefill of the MLA
    class (192x128) the wgmma body (``MLA_BODY``)."""
    fp, out = k.flash_prefill, {}
    for name, table in (("flash_prefill", fp.BODY),
                        ("flash_qprefill", fp.QBODY),
                        ("flash_q4prefill", fp.Q4BODY)):
        bodies = read_bodies(k, name)
        want = {b: launches[name] if b == table[dtype] else 0
                for b in bodies}
        if name == "flash_prefill" and dtype == torch.bfloat16:
            mla = launches["flash_prefill.class.192x128"]
            want[fp.MLA_BODY] = mla
            want[table[dtype]] -= mla
        if bodies != want:
            raise AssertionError(f"{where}: {name} bodies {bodies}, "
                                 f"want {want}")
        out.update({f"{name}.{b}": n for b, n in bodies.items()})
    return out


def ptxas_kernels(log: str, filt: str) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} from the
    ``nvcc -Xptxas -v`` output of one source; names demangled by the
    toolkit's cu++filt, without arguments or the anonymous namespace."""
    found, name, spill = {}, None, ("?", "?")
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            found[name] = (int(m.group(1)), *spill)
            name, spill = None, ("?", "?")
    names = list(found)
    try:
        plain = subprocess.run([filt, *names], capture_output=True,
                               text=True, timeout=60,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        plain = names
    if len(plain) != len(names):
        plain = names
    tidy = [re.sub(r"\(.*$", "", re.sub(
        r"^void |\(int\)|<unnamed>::|\(anonymous namespace\)::", "", p))
        for p in plain]
    return {t: found[n] for t, n in zip(tidy, names)}


def q4_split_instance(hd: int, g: int) -> str:
    """The ``paged_q4decode_split<LPR, GB>`` that serves (hd, G): the
    header's group_bound, Int4::lane_codes and lanes_per_row."""
    gb = 1 if g == 1 else (4 if g <= 4 else 8)
    v = hd // (32 if gb == 1 else (16 if gb <= 4 else 8))
    lpr = 2 if v <= 2 else (4 if v <= 4 else (8 if v <= 8 else 16))
    return f"paged_q4decode_split<{lpr}, {gb}>"


def fp_split_instance(hd: int, g: int, pool_dtype) -> str:
    """The ``paged_decode_split<T, LPR, GB>`` that serves (hd, G, pool
    dtype): Fp::lane_codes is 8 at every G bound."""
    gb = 1 if g == 1 else (4 if g <= 4 else 8)
    v = -(-hd // 8)
    lpr = 2 if v <= 2 else (4 if v <= 4 else (8 if v <= 8 else 16))
    t = "float" if pool_dtype == torch.float32 else "__nv_bfloat16"
    return f"paged_decode_split<{t}, {lpr}, {gb}>"


def qtc_instance(hd: int, dv: int, dtype, body="flash_qtc",
                 tile=(64, 64)) -> str:
    """The ``tc::flash_qtc<TQ, W, W, BR, BK>`` (or ``flash_q4tc``) that
    serves (hd, dv, q dtype) at ``tile`` (the wrappers' default)."""
    w = max(hd, dv)
    w = 64 if w <= 64 else (96 if w <= 96 else 128)
    tq = "float" if dtype == torch.float32 else "__nv_bfloat16"
    return f"tc::{body}<{tq}, {w}, {w}, {tile[0]}, {tile[1]}>"


# ------------------------------------------------------------------ #
# Phase 2: kernels against their plain versions
# ------------------------------------------------------------------ #
def gemm_phase(k, dev, timer):
    """Both GEMMs at every (M, K, N) of GEMM_CASES on the packed weight (the
    card's layout, ``qmatmul.pack_weight``, whose time is printed once per
    weight): codes and row scales bit for bit, outputs within rtol 1e-6 of
    the plain version, the [K, N] entry point and the bf16 output (the one
    ``linear`` asks for) bit for bit against the f32 result, and the body
    that ran against ``qmatmul.plan``. Beside each: the int8 yardstick
    (``torch._int_mm`` + epilogue) and the bf16 variant's linear (one bf16
    ``torch.matmul``: a different function, the time the int8 one has to
    beat)."""
    ref, qm = k.ref, k.qmatmul
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = {"qmatmul_dynamic": 0.0, "qmatmul_static": 0.0}
    headline = {}
    for kk, n, ms in GEMM_CASES:
        w = torch.randint(-127, 128, (kk, n), generator=gen, device=dev,
                          dtype=torch.int8)
        ws = torch.rand((1, n), generator=gen, device=dev) * 1e-3 + 1e-5
        wp = qm.pack_weight(w)
        pack_ms = timer.eager_ms(lambda: qm.pack_weight(w), iters=3)
        w_bf16 = w.to(torch.bfloat16)          # the bf16 variant's weight
        for m in ms:
            x = (torch.randn((m, kk), generator=gen, device=dev) * 2).to(
                torch.bfloat16)
            act = (x.float().abs().amax() / 127.0).reshape(())
            want_body = qm.plan(m, n, kk).body
            for name in ("qmatmul_dynamic", "qmatmul_static"):
                static = name == "qmatmul_static"
                a = act if static else None
                codes, a_scale = qm.quantize_activations(x, a)
                if static:
                    wrapper = qm.qmatmul_static
                    want_codes = ref.quantize_static_ref(x, act)
                    run = lambda dt=torch.float32: qm.qmatmul_static_packed(  # noqa: E731
                        x, wp, ws, act, out_dtype=dt)
                    run_kn = lambda: qm.qmatmul_static(x, w, ws, act)  # noqa: E731
                    plain = lambda: ref.qmatmul_static_ref(x, w, ws, act)  # noqa: E731
                else:
                    wrapper = k.dynquant.qmatmul_dynamic
                    want_codes, want_scale = ref.quantize_rows_ref(x)
                    if not torch.equal(a_scale, want_scale):
                        raise AssertionError(f"{name} row scales differ at "
                                             f"M={m} K={kk} N={n}")
                    run = lambda dt=torch.float32: k.dynquant.qmatmul_dynamic_packed(  # noqa: E731
                        x, wp, ws, out_dtype=dt)
                    run_kn = lambda: k.dynquant.qmatmul_dynamic(x, w, ws)  # noqa: E731
                    plain = lambda: ref.qmatmul_dynamic_ref(x, w, ws)  # noqa: E731
                if not torch.equal(codes, want_codes):
                    bad = int((codes != want_codes).sum())
                    raise AssertionError(f"{name}: {bad} activation codes "
                                         f"differ at M={m} K={kk} N={n}")
                before = dict(wrapper.launches_by_body)
                got, want = run(), plain()
                torch.cuda.synchronize()
                ran = [b for b, c in wrapper.launches_by_body.items()
                       if c != before[b]]
                if ran != [want_body]:
                    raise AssertionError(f"{name} M={m} K={kk} N={n}: body "
                                         f"{ran} ran, plan says {want_body}")
                err = float((got - want).abs().max())
                # same int32 sums, same epilogue order: rtol 1e-6 is one f32
                # rounding of the scale products
                torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
                if not torch.equal(run_kn(), got) or not torch.equal(
                        run(torch.bfloat16), got.to(torch.bfloat16)):
                    raise AssertionError(f"{name} M={m} K={kk} N={n}: the "
                                         "[K, N] entry or the bf16 output "
                                         "differs from the f32 result")
                worst[name] = max(worst[name], err)
                t_k = timer.graph_ms(run)
                t_eager = timer.eager_ms(run)
                t_bf16_out = timer.graph_ms(lambda: run(torch.bfloat16))
                # the wgmma body's separate activation pass, alone
                t_quant = (timer.graph_ms(
                    lambda: qm.quantize_activations(x, a))
                    if want_body == "wgmma" else None)
                t_p = timer.graph_ms(plain, iters=3)
                # yardstick: cuBLASLt int8 GEMM on the same codes, plus the
                # epilogue. torch._int_mm needs M > 16 and M % 8 == 0, so
                # other M are zero-padded (to 32 for M=4) before the call
                # and the epilogue runs on the M real rows
                pad_m = m if m > 16 and m % 8 == 0 else max(32, -(-m // 8) * 8)
                lib_codes = torch.nn.functional.pad(codes, (0, 0, 0, pad_m - m))
                if static:
                    lib_fn = lambda: torch._int_mm(lib_codes, w)[:m].float() * (act * ws)  # noqa: E731
                else:
                    lib_fn = lambda: torch._int_mm(lib_codes, w)[:m].float() * a_scale * ws  # noqa: E731
                lib = timer.graph_ms(lib_fn)
                lib_bf16 = timer.graph_ms(lambda: torch.matmul(x, w_bf16))
                nbytes = m * kk * x.element_size() + kk * n + 4 * n + 4 * m * n
                b_ms, b_by = bound(nbytes, 2.0 * m * n * kk, "int8")
                p = qm.plan(m, n, kk)
                row = dict(kernel=name, M=m, K=kk, N=n, body=want_body,
                           tile=[p.bm, p.bn], blocks=p.blocks,
                           max_abs_err=err, codes_identical=True, ms=t_k,
                           eager_ms=t_eager, ms_bf16_out=t_bf16_out,
                           quantize_ms=t_quant,
                           plain_ms=t_p, library_ms=lib,
                           library_padded_m=pad_m if pad_m != m else None,
                           bf16_library_ms=lib_bf16, pack_ms=pack_ms,
                           bound_ms=b_ms, bound_by=b_by,
                           ms_over_bound=t_k / b_ms)
                emit("kernel", **row)
                if (m, kk, n) == HEADLINE_GEMM:
                    headline[name] = row
        del w, wp, w_bf16
    for name in headline:
        headline[name]["max_abs_err"] = worst[name]
    return headline


def flash_phase(k, dev, timer):
    """flash_prefill at every FLASH_SHAPES shape and MLA_FLASH against the
    plain version, timed beside its bound and one PyTorch call computing
    the same function (``scaled_dot_product_attention``, causal; where it
    refuses the shape, None and its error). Returns (the headline row, the
    MLA row with its instantiation's ptxas line)."""
    ref, fp = k.ref, k.flash_prefill
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    worst, headline, mla = 0.0, None, None
    for shape in FLASH_SHAPES + (MLA_FLASH,):
        b, s, hq, hkv, hd, dv, dt = shape
        q = torch.randn((b, s, hq, hd), generator=gen, device=dev).to(dt)
        kk = torch.randn((b, s, hkv, hd), generator=gen, device=dev).to(dt)
        v = torch.randn((b, s, hkv, dv), generator=gen, device=dev).to(dt)
        before = read_bodies(k)
        classes = dict(fp.flash_prefill.launches_by_class)
        got, want = fp.flash_prefill(q, kk, v), ref.flash_prefill_ref(q, kk, v)
        torch.cuda.synchronize()
        ran = [b for b, n in read_bodies(k).items() if n != before[b]]
        body = fp.MLA_BODY if shape == MLA_FLASH else fp.BODY[dt]
        if ran != [body]:
            raise AssertionError(f"flash_prefill {shape}: bodies {ran} ran, "
                                 f"not {body}")
        cls = [c for c, n in fp.flash_prefill.launches_by_class.items()
               if n != classes[c]]
        if cls != [fp.width_class(hd, dv)]:
            raise AssertionError(f"flash_prefill {shape}: classes {cls}")
        err = float((got - want).abs().max())
        if not torch.isfinite(got).all() or err > FLASH_ATOL:
            raise AssertionError(f"flash_prefill {shape}: max |err| {err} > "
                                 f"{FLASH_ATOL}")
        worst = max(worst, err)
        del got, want
        t_k = timer.graph_ms(lambda: fp.flash_prefill(q, kk, v))
        t_eager = timer.eager_ms(lambda: fp.flash_prefill(q, kk, v))
        t_p = timer.graph_ms(lambda: ref.flash_prefill_ref(q, kk, v), iters=3)
        g = hq // hkv
        qt = q.transpose(1, 2).contiguous()
        kt = kk.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
        lib_error = None
        try:
            lib = timer.graph_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True))
        except RuntimeError as e:      # a library refusal is a finding
            lib, lib_error = None, str(e).splitlines()[0][:200]
        visible = s * (s + 1) // 2                 # causal (query, key) pairs
        flops = 2.0 * (hd + dv) * visible * b * hq
        nbytes = (q.numel() + kk.numel() + v.numel()) * q.element_size() \
            + 4 * b * s * hq * dv
        b_ms, b_by = bound(nbytes, flops, str(dt).split(".")[-1])
        row = dict(kernel="flash_prefill", B=b, S=s, Hq=hq, Hkv=hkv, hd=hd,
                   dv=dv, dtype=str(dt).split(".")[-1], body=ran[0],
                   width_class=cls[0], max_abs_err=err,
                   atol=FLASH_ATOL, gflop=flops / 1e9, ms=t_k,
                   eager_ms=t_eager, plain_ms=t_p,
                   library_ms=lib, bound_ms=b_ms, bound_by=b_by)
        if lib_error:
            row["library_error"] = lib_error
        if shape == MLA_FLASH:
            t = "float" if dt == torch.float32 else "__nv_bfloat16"
            row["ptxas"] = {n: k.ptxas.get(n) for n in (
                "mla::flash_mla", f"tc::flash_tc<{t}, 192, 128, 64, 64>",
                "tc::flash_tc<float, 192, 128, 64, 64>")}
            mla = row
        emit("kernel", **row)
        if shape == HEADLINE_FLASH:
            headline = row
        del q, kk, v, qt, kt, vt
        torch.cuda.empty_cache()
    headline["max_abs_err"] = worst
    return headline, mla


def paged_case(dev, gen, shape):
    """Random q and pools on the card; each live sequence's table holds
    shuffled block ids up to its position and -1 past it; an idle row
    (position -1) has an all -1 table at position 0, as an idle engine
    slot has."""
    b, hkv, g, hd, bs, m, n, dt, pos = shape
    if pos is None:
        pos = torch.randint(36, 512, (b,), generator=gen).tolist()
    q = torch.randn((b, hkv, g, hd), generator=gen).to(dev, dt)
    k_pool = torch.randn((n, bs, hkv, hd), generator=gen).to(dev, dt)
    v_pool = torch.randn((n, bs, hkv, hd), generator=gen).to(dev, dt)
    ids = (torch.randperm(n - 1, generator=gen) + 1).tolist()
    tables = torch.full((b, m), -1, dtype=torch.int32)
    for i, p in enumerate(pos):
        for j in range(p // bs + 1 if p >= 0 else 0):
            tables[i, j] = ids.pop()
    pos_t = torch.tensor([max(p, 0) for p in pos], dtype=torch.int32)
    live = torch.tensor([p >= 0 for p in pos])
    return q, k_pool, v_pool, tables.to(dev), pos_t.to(dev), live.to(dev)


def paged_phase(k, dev, timer):
    ref, pa = k.ref, k.paged_attn
    gen = torch.Generator().manual_seed(SEED + 7)
    worst, headline = 0.0, None
    for label, shape in PAGED_SHAPES.items():
        b, hkv, g, hd, bs, m, n, dt, _ = shape
        q, kp, vp, tables, pos, live = paged_case(dev, gen, shape)
        run = lambda: pa.paged_decode(q, kp, vp, tables, pos)  # noqa: E731
        plain = lambda: ref.paged_decode_ref(q, kp, vp, tables, pos)  # noqa: E731
        got, want, twice = run(), plain(), run()
        torch.cuda.synchronize()
        idle_nan = bool(got[~live].isnan().all()) and bool(
            want[~live].isnan().all())
        err = float((got[live] - want[live]).abs().max())
        if not torch.isfinite(got[live]).all() or err > PAGED_ATOL \
                or not idle_nan:
            raise AssertionError(f"paged_decode ({label}): max |err| {err} "
                                 f"> {PAGED_ATOL} or idle rows not 0/0")
        if not (torch.equal(twice[live], got[live])
                and torch.equal(twice.isnan(), got.isnan())):
            raise AssertionError(f"paged_decode ({label}): two calls differ")
        worst = max(worst, err)
        t_k = timer.graph_ms(run)
        t_eager = timer.eager_ms(run)
        t_p = timer.graph_ms(plain, iters=3)
        # yardstick, two calls: gather the blocks into a contiguous masked
        # [B, Hkv, S, hd] view, then one SDPA call over it
        valid = ref.paged_valid(tables, pos, bs)

        def gather():
            return (ref.paged_gather(kp, tables).transpose(1, 2).contiguous(),
                    ref.paged_gather(vp, tables).transpose(1, 2).contiguous())
        kg, vg = gather()
        mask = valid[:, None, None, :]
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q, kg, vg, attn_mask=mask)
        lib_err = float((sdpa()[live].float() - want[live]).abs().max())
        t_gather = timer.graph_ms(gather)
        t_lib = timer.graph_ms(sdpa)
        # block 0 is in no table: NaN there (what an idle slot may leave in
        # the trash block) reaches no live row
        kp[0], vp[0] = float("nan"), float("nan")
        again = run()
        torch.cuda.synchronize()
        if not (torch.equal(again[live], got[live])
                and torch.equal(again.isnan(), got.isnan())):
            raise AssertionError(f"paged_decode ({label}): NaN in the trash "
                                 "block reached a live row")
        n_valid = int(valid.sum())            # this run's valid slots
        item = kp.element_size()
        nbytes = (2 * n_valid * hkv * hd * item + q.numel() * q.element_size()
                  + tables.numel() * 4 + pos.numel() * 4 + got.numel() * 4)
        flops = 4.0 * g * hd * n_valid * hkv
        b_ms, b_by = bound(nbytes, flops, str(dt).split(".")[-1])
        inst = fp_split_instance(hd, g, dt)
        row = dict(kernel="paged_decode", case=label, B=b, Hkv=hkv, G=g,
                   hd=hd, bs=bs, M=m, N=n, dtype=str(dt).split(".")[-1],
                   body="split", instance=inst, ptxas=k.ptxas.get(inst),
                   positions=pos.tolist(), valid_slots=n_valid,
                   idle_rows=int((~live).sum()), trash_nan_isolated=True,
                   max_abs_err=err, atol=PAGED_ATOL, repeat_identical=True,
                   ms=t_k, eager_ms=t_eager, plain_ms=t_p,
                   library_ms=t_lib, library_gather_ms=t_gather,
                   library_max_abs_err=lib_err, mbytes=nbytes / 1e6,
                   bound_ms=b_ms, bound_by=b_by)
        emit("kernel", **row)
        if label == HEADLINE_PAGED:
            headline = row
        del q, kp, vp, kg, vg
    headline["max_abs_err"] = worst
    return headline


def int8_codes(gen, shape, dev):
    """Random int8 codes in +-127 and positive f32 scales [*shape[:-1]] of
    order 1/127 (dequantized values of order 1, as quantized K/V are)."""
    codes = torch.randint(-127, 128, shape, generator=gen, dtype=torch.int8)
    scales = (torch.rand(shape[:-1], generator=gen) + 0.5) / 127
    return codes.to(dev), scales.to(dev)


def dequant(codes, scales, dtype):
    return (codes.float() * scales[..., None]).to(dtype)


def qdecode_phase(k, dev, timer):
    ref, qd = k.ref, k.qdecode
    gen = torch.Generator().manual_seed(SEED + 9)
    worst, headline, wide = 0.0, None, None
    for label, shape in QDECODE_SHAPES.items():
        b, s, hkv, g, hd, dt, pos = shape
        if pos is None:
            pos = torch.randint(36, s, (b,), generator=gen).tolist()
        q = torch.randn((b, hkv, g, hd), generator=gen).to(dev, dt)
        kq, ks = int8_codes(gen, (b, s, hkv, hd), dev)
        vq, vs = int8_codes(gen, (b, s, hkv, hd), dev)
        valid = torch.arange(s, device=dev)[None] <= torch.tensor(
            pos, device=dev)[:, None]
        bias = torch.where(valid, torch.zeros((), device=dev),
                           torch.full((), -2.0e38, device=dev))
        run = lambda: qd.qdecode(q, kq, ks, vq, vs, bias)  # noqa: E731
        plain = lambda: ref.qdecode_ref(q, kq, ks, vq, vs, bias)  # noqa: E731
        got, want, again = run(), plain(), run()
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.isfinite(got).all() or err > INT8KV_ATOL:
            raise AssertionError(f"qdecode ({label}): max |err| {err} > "
                                 f"{INT8KV_ATOL}")
        if not torch.equal(again, got):     # one launch, no atomics
            raise AssertionError(f"qdecode ({label}): two calls differ")
        worst = max(worst, err)
        t_k = timer.graph_ms(run)
        t_eager = timer.eager_ms(run)
        t_p = timer.graph_ms(plain, iters=3)
        # yardstick, two calls: dequantize the cache into [B, Hkv, S, hd]
        # in q's dtype, then one SDPA call with the bias as its mask (the G
        # query heads of a kv head are its G query rows)
        def deq():
            return (dequant(kq, ks, dt).transpose(1, 2).contiguous(),
                    dequant(vq, vs, dt).transpose(1, 2).contiguous())
        kf, vf = deq()
        mask = bias[:, None, None, :].to(dt)
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q, kf, vf, attn_mask=mask)
        lib_err = float((sdpa().float() - want).abs().max())
        t_deq = timer.graph_ms(deq)
        t_lib = timer.graph_ms(sdpa)
        nbytes = (2 * b * s * hkv * hd + 2 * 4 * b * s * hkv + 4 * b * s
                  + q.numel() * q.element_size() + got.numel() * 4)
        flops = 4.0 * g * hd * s * hkv * b
        b_ms, b_by = bound(nbytes, flops, str(dt).split(".")[-1])
        row = dict(kernel="qdecode", case=label, B=b, S=s, Hkv=hkv, G=g,
                   hd=hd, dtype=str(dt).split(".")[-1], positions=pos,
                   max_abs_err=err, atol=INT8KV_ATOL, repeat_identical=True,
                   ms=t_k,
                   eager_ms=t_eager, plain_ms=t_p, library_ms=t_lib,
                   library_dequant_ms=t_deq, library_max_abs_err=lib_err,
                   mbytes=nbytes / 1e6, bound_ms=b_ms, bound_by=b_by)
        if qd.wide_class(g, hd):
            row.update(body="wide_tc", ptxas=k.ptxas.get("qdecode_wide_tc"))
        emit("kernel", **row)
        if label == HEADLINE_QDECODE:
            headline = row
        if label == WIDE_QDECODE:
            if qd.qdecode.launches_by_class["wide"] <= 0:
                raise AssertionError("qdecode (wide): the wide class never "
                                     "launched")
            wide = row
        del q, kq, vq, kf, vf
    headline["max_abs_err"] = worst
    return headline, wide


def paged_qdecode_phase(k, dev, timer):
    """PAGED_SHAPES over int8 pools with f32 scale pools. Case (e) then
    writes what an idle slot leaves in the trash block (NaN scales, -128
    codes) and the live rows must not change."""
    ref, pa = k.ref, k.paged_attn
    gen = torch.Generator().manual_seed(SEED + 7)
    cgen = torch.Generator().manual_seed(SEED + 10)
    worst, headline = 0.0, None
    for label, shape in PAGED_SHAPES.items():
        b, hkv, g, hd, bs, m, n, dt, _ = shape
        q, kp, vp, tables, pos, live = paged_case(dev, gen, shape)
        q = q.to(dt)
        k_pool, k_scale = int8_codes(cgen, tuple(kp.shape), dev)
        v_pool, v_scale = int8_codes(cgen, tuple(vp.shape), dev)
        del kp, vp
        pools = (k_pool, k_scale, v_pool, v_scale)
        run = lambda: pa.paged_qdecode(q, *pools, tables, pos)  # noqa: E731
        plain = lambda: ref.paged_qdecode_ref(q, *pools, tables, pos)  # noqa: E731
        got, want, twice = run(), plain(), run()
        torch.cuda.synchronize()
        idle_nan = bool(got[~live].isnan().all()) and bool(
            want[~live].isnan().all())
        err = float((got[live] - want[live]).abs().max())
        if not torch.isfinite(got[live]).all() or err > INT8KV_ATOL \
                or not idle_nan:
            raise AssertionError(f"paged_qdecode ({label}): max |err| {err} "
                                 f"> {INT8KV_ATOL} or idle rows not 0/0")
        if not (torch.equal(twice[live], got[live])
                and torch.equal(twice.isnan(), got.isnan())):
            raise AssertionError(f"paged_qdecode ({label}): two calls "
                                 "differ")
        worst = max(worst, err)
        t_k = timer.graph_ms(run)
        t_eager = timer.eager_ms(run)
        t_p = timer.graph_ms(plain, iters=3)
        # yardstick, three calls: gather codes and scales into contiguous
        # [B, S, ...] views, dequantize to [B, Hkv, S, hd] in q's dtype,
        # then one SDPA call over the masked view
        valid = ref.paged_valid(tables, pos, bs)

        def gather():
            return tuple(ref.paged_gather(t, tables) for t in pools)
        gathered = gather()

        def deq():
            kg, ksg, vg, vsg = gathered
            return (dequant(kg, ksg, dt).transpose(1, 2).contiguous(),
                    dequant(vg, vsg, dt).transpose(1, 2).contiguous())
        kf, vf = deq()
        mask = valid[:, None, None, :]
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q, kf, vf, attn_mask=mask)
        lib_out = sdpa().float()
        lib_err = float((lib_out[live] - want[live]).abs().max())
        t_gather = timer.graph_ms(gather)
        t_deq = timer.graph_ms(deq)
        t_lib = timer.graph_ms(sdpa)
        # what an idle slot leaves in the trash block reaches no live row
        trash = None
        if not bool(live.all()):
            k_pool[0], v_pool[0] = -128, -128
            k_scale[0], v_scale[0] = float("nan"), float("nan")
            again, again_plain = run(), plain()
            torch.cuda.synchronize()
            trash = bool(torch.isfinite(again[live]).all()) and bool(
                torch.equal(again[live], got[live])) and bool(
                torch.equal(again_plain[live], want[live]))
            if not trash:
                raise AssertionError(f"paged_qdecode ({label}): NaN in the "
                                     "trash block reached a live row")
        n_valid = int(valid.sum())            # this run's valid slots
        nbytes = (2 * n_valid * hkv * (hd + 4) + q.numel() * q.element_size()
                  + tables.numel() * 4 + pos.numel() * 4 + got.numel() * 4)
        flops = 4.0 * g * hd * n_valid * hkv
        b_ms, b_by = bound(nbytes, flops, str(dt).split(".")[-1])
        row = dict(kernel="paged_qdecode", case=label, B=b, Hkv=hkv, G=g,
                   hd=hd, bs=bs, M=m, N=n, dtype=str(dt).split(".")[-1],
                   pools="int8", positions=pos.tolist(),
                   valid_slots=n_valid, idle_rows=int((~live).sum()),
                   trash_nan_isolated=trash, max_abs_err=err,
                   atol=INT8KV_ATOL, repeat_identical=True, ms=t_k,
                   eager_ms=t_eager, plain_ms=t_p,
                   library_ms=t_lib, library_gather_ms=t_gather,
                   library_dequant_ms=t_deq, library_max_abs_err=lib_err,
                   mbytes=nbytes / 1e6, bound_ms=b_ms, bound_by=b_by)
        emit("kernel", **row)
        if label == HEADLINE_PAGED:
            headline = row
        del q, pools, k_pool, v_pool, gathered, kf, vf
    headline["max_abs_err"] = worst
    return headline


def flash_qprefill_phase(k, dev, timer):
    ref, fp = k.ref, k.flash_prefill
    gen = torch.Generator().manual_seed(SEED + 11)
    worst, headline = 0.0, None
    for shape in FLASH_SHAPES:
        b, s, hq, hkv, hd, dv, dt = shape
        q = torch.randn((b, s, hq, hd), generator=gen).to(dev, dt)
        kq, ks = int8_codes(gen, (b, s, hkv, hd), dev)
        vq, vs = int8_codes(gen, (b, s, hkv, dv), dev)
        run = lambda: fp.flash_qprefill(q, kq, ks, vq, vs)  # noqa: E731
        plain = lambda: ref.flash_qprefill_ref(q, kq, ks, vq, vs)  # noqa: E731
        before = read_bodies(k, "flash_qprefill")
        got, want, twice = run(), plain(), run()
        torch.cuda.synchronize()
        ran = [b for b, n in read_bodies(k, "flash_qprefill").items()
               if n != before[b]]
        if ran != [fp.QBODY[dt]]:
            raise AssertionError(f"flash_qprefill {shape}: bodies {ran} ran, "
                                 f"not {fp.QBODY[dt]}")
        err = float((got - want).abs().max())
        if not torch.isfinite(got).all() or err > INT8KV_ATOL:
            raise AssertionError(f"flash_qprefill {shape}: max |err| {err} > "
                                 f"{INT8KV_ATOL}")
        if not torch.equal(twice, got):     # one launch, no atomics
            raise AssertionError(f"flash_qprefill {shape}: two calls differ")
        worst = max(worst, err)
        t_k = timer.graph_ms(run)
        t_eager = timer.eager_ms(run)
        t_p = timer.graph_ms(plain, iters=3)
        # yardstick, two calls: dequantize K/V to q's dtype in the
        # [B, Hq, S, D] layout SDPA takes, then one causal SDPA call
        g = hq // hkv
        qt = q.transpose(1, 2).contiguous()

        def deq():
            return tuple(dequant(c, sc, dt).repeat_interleave(g, dim=2)
                         .transpose(1, 2).contiguous()
                         for c, sc in ((kq, ks), (vq, vs)))
        kt, vt = deq()
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True)
        t_deq = timer.graph_ms(deq)
        t_lib = timer.graph_ms(sdpa)
        visible = s * (s + 1) // 2                 # causal (query, key) pairs
        flops = 2.0 * (hd + dv) * visible * b * hq
        nbytes = (q.numel() * q.element_size() + kq.numel() + vq.numel()
                  + 4 * (ks.numel() + vs.numel()) + 4 * b * s * hq * dv)
        b_ms, b_by = bound(nbytes, flops, str(dt).split(".")[-1])
        inst = qtc_instance(hd, dv, dt)
        row = dict(kernel="flash_qprefill", B=b, S=s, Hq=hq, Hkv=hkv, hd=hd,
                   dv=dv, dtype=str(dt).split(".")[-1], kv="int8",
                   body=ran[0], instance=inst, ptxas=k.ptxas.get(inst),
                   repeat_identical=True,
                   max_abs_err=err, atol=INT8KV_ATOL, gflop=flops / 1e9,
                   ms=t_k, eager_ms=t_eager, plain_ms=t_p, library_ms=t_lib,
                   library_dequant_ms=t_deq, mbytes=nbytes / 1e6,
                   bound_ms=b_ms, bound_by=b_by,
                   bound_ms_by_operations=flops / PEAK_OPS_S[
                       str(dt).split(".")[-1]] * 1e3)
        emit("kernel", **row)
        if shape == HEADLINE_FLASH:
            headline = row
        del q, kq, vq, kt, vt, qt
    headline["max_abs_err"] = worst
    return headline


def int4_codes(gen, shape, dev):
    """Random packed int4 bytes [*shape[:-1], hd // 2] (every nibble -8..7)
    and positive f16 group scales [*shape[:-1], hd // 32] of order 1/7
    (dequantized values of order 1, as quantized K/V are)."""
    *lead, hd = shape
    codes = torch.randint(-128, 128, (*lead, hd // 2), generator=gen,
                          dtype=torch.int8)
    scales = ((torch.rand((*lead, hd // 32), generator=gen) + 0.5) / 7).to(
        torch.float16)
    return codes.to(dev), scales.to(dev)


def int4_bytes(n_rows, hd):
    """Bytes of ``n_rows`` int4 K or V rows of width hd with their f16
    group scales."""
    return n_rows * (hd // 2 + 2 * (hd // 32))


def paged_q4decode_phase(k, dev, timer):
    """PAGED_SHAPES over int4 pools with f16 group-scale pools. Case (e)
    then writes what an idle slot leaves in the trash block (NaN f16
    scales) and 0x88 bytes (codes -8) there, and the live rows must not
    change."""
    ref, pa, quant = k.ref, k.paged_attn, k.quantize
    gen = torch.Generator().manual_seed(SEED + 7)
    cgen = torch.Generator().manual_seed(SEED + 12)
    worst, headline = 0.0, None
    for label, shape in PAGED_SHAPES.items():
        b, hkv, g, hd, bs, m, n, dt, _ = shape
        q, kp, vp, tables, pos, live = paged_case(dev, gen, shape)
        k_pool, k_scale = int4_codes(cgen, tuple(kp.shape), dev)
        v_pool, v_scale = int4_codes(cgen, tuple(vp.shape), dev)
        del kp, vp
        pools = (k_pool, k_scale, v_pool, v_scale)
        run = lambda: pa.paged_q4decode(q, *pools, tables, pos)  # noqa: E731
        plain = lambda: ref.paged_q4decode_ref(q, *pools, tables, pos)  # noqa: E731
        got, want, twice = run(), plain(), run()
        torch.cuda.synchronize()
        idle_nan = bool(got[~live].isnan().all()) and bool(
            want[~live].isnan().all())
        err = float((got[live] - want[live]).abs().max())
        if not torch.isfinite(got[live]).all() or err > INT8KV_ATOL \
                or not idle_nan:
            raise AssertionError(f"paged_q4decode ({label}): max |err| {err} "
                                 f"> {INT8KV_ATOL} or idle rows not 0/0")
        if not (torch.equal(twice[live], got[live])
                and torch.equal(twice.isnan(), got.isnan())):
            raise AssertionError(f"paged_q4decode ({label}): two calls "
                                 "differ")
        worst = max(worst, err)
        t_k = timer.graph_ms(run)
        t_eager = timer.eager_ms(run)
        t_p = timer.graph_ms(plain, iters=3)
        # yardstick, three calls: gather codes and scales into contiguous
        # [B, S, ...] views, dequantize to [B, Hkv, S, hd] in q's dtype,
        # then one SDPA call over the masked view
        valid = ref.paged_valid(tables, pos, bs)

        def gather():
            return tuple(ref.paged_gather(t, tables) for t in pools)
        gathered = gather()

        def deq():
            kg, ksg, vg, vsg = gathered
            return (quant.dequantize_kv_int4(kg, ksg).to(dt).transpose(1, 2)
                    .contiguous(),
                    quant.dequantize_kv_int4(vg, vsg).to(dt).transpose(1, 2)
                    .contiguous())
        kf, vf = deq()
        mask = valid[:, None, None, :]
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q, kf, vf, attn_mask=mask)
        lib_out = sdpa().float()
        lib_err = float((lib_out[live] - want[live]).abs().max())
        t_gather = timer.graph_ms(gather)
        t_deq = timer.graph_ms(deq)
        t_lib = timer.graph_ms(sdpa)
        # what an idle slot leaves in the trash block reaches no live row
        trash = None
        if not bool(live.all()):
            k_pool[0], v_pool[0] = -120, -120          # 0x88: codes -8
            k_scale[0], v_scale[0] = float("nan"), float("nan")
            again, again_plain = run(), plain()
            torch.cuda.synchronize()
            trash = bool(torch.isfinite(again[live]).all()) and bool(
                torch.equal(again[live], got[live])) and bool(
                torch.equal(again_plain[live], want[live]))
            if not trash:
                raise AssertionError(f"paged_q4decode ({label}): the "
                                     "poisoned trash block reached a live "
                                     "row")
        n_valid = int(valid.sum())            # this run's valid slots
        nbytes = (2 * hkv * int4_bytes(n_valid, hd)
                  + q.numel() * q.element_size() + tables.numel() * 4
                  + pos.numel() * 4 + got.numel() * 4)
        flops = 4.0 * g * hd * n_valid * hkv
        b_ms, b_by = bound(nbytes, flops, str(dt).split(".")[-1])
        inst = q4_split_instance(hd, g)
        row = dict(kernel="paged_q4decode", case=label, B=b, Hkv=hkv, G=g,
                   hd=hd, bs=bs, M=m, N=n, dtype=str(dt).split(".")[-1],
                   pools="int4", body="split", instance=inst,
                   ptxas=k.ptxas.get(inst), positions=pos.tolist(),
                   valid_slots=n_valid, idle_rows=int((~live).sum()),
                   trash_nan_isolated=trash, max_abs_err=err,
                   atol=INT8KV_ATOL, repeat_identical=True, ms=t_k,
                   eager_ms=t_eager, plain_ms=t_p,
                   library_ms=t_lib, library_gather_ms=t_gather,
                   library_dequant_ms=t_deq, library_max_abs_err=lib_err,
                   mbytes=nbytes / 1e6, bound_ms=b_ms, bound_by=b_by)
        emit("kernel", **row)
        if label == HEADLINE_PAGED:
            headline = row
        del q, pools, k_pool, v_pool, gathered, kf, vf
    headline["max_abs_err"] = worst
    return headline


def flash_q4prefill_phase(k, dev, timer):
    ref, fp, quant = k.ref, k.flash_prefill, k.quantize
    gen = torch.Generator().manual_seed(SEED + 13)
    worst, headline = 0.0, None
    for shape in FLASH_SHAPES:
        b, s, hq, hkv, hd, dv, dt = shape
        q = torch.randn((b, s, hq, hd), generator=gen).to(dev, dt)
        kq, ks = int4_codes(gen, (b, s, hkv, hd), dev)
        vq, vs = int4_codes(gen, (b, s, hkv, dv), dev)
        run = lambda: fp.flash_q4prefill(q, kq, ks, vq, vs)  # noqa: E731
        plain = lambda: ref.flash_q4prefill_ref(q, kq, ks, vq, vs)  # noqa: E731
        before = read_bodies(k, "flash_q4prefill")
        got, want, twice = run(), plain(), run()
        torch.cuda.synchronize()
        ran = [b for b, n in read_bodies(k, "flash_q4prefill").items()
               if n != before[b]]
        if ran != [fp.Q4BODY[dt]]:
            raise AssertionError(f"flash_q4prefill {shape}: bodies {ran} "
                                 f"ran, not {fp.Q4BODY[dt]}")
        err = float((got - want).abs().max())
        if not torch.isfinite(got).all() or err > INT8KV_ATOL:
            raise AssertionError(f"flash_q4prefill {shape}: max |err| {err} "
                                 f"> {INT8KV_ATOL}")
        if not torch.equal(twice, got):     # one launch, no atomics
            raise AssertionError(f"flash_q4prefill {shape}: two calls "
                                 "differ")
        worst = max(worst, err)
        t_k = timer.graph_ms(run)
        t_eager = timer.eager_ms(run)
        t_p = timer.graph_ms(plain, iters=3)
        # yardstick, two calls: dequantize K/V to q's dtype in the
        # [B, Hq, S, D] layout SDPA takes, then one causal SDPA call
        g = hq // hkv
        qt = q.transpose(1, 2).contiguous()

        def deq():
            return tuple(quant.dequantize_kv_int4(c, sc).to(dt)
                         .repeat_interleave(g, dim=2).transpose(1, 2)
                         .contiguous() for c, sc in ((kq, ks), (vq, vs)))
        kt, vt = deq()
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True)
        t_deq = timer.graph_ms(deq)
        t_lib = timer.graph_ms(sdpa)
        visible = s * (s + 1) // 2                 # causal (query, key) pairs
        flops = 2.0 * (hd + dv) * visible * b * hq
        nbytes = (q.numel() * q.element_size()
                  + b * s * hkv * (int4_bytes(1, hd) + int4_bytes(1, dv))
                  + 4 * b * s * hq * dv)
        b_ms, b_by = bound(nbytes, flops, str(dt).split(".")[-1])
        inst = qtc_instance(hd, dv, dt, "flash_q4tc")
        row = dict(kernel="flash_q4prefill", B=b, S=s, Hq=hq, Hkv=hkv, hd=hd,
                   dv=dv, dtype=str(dt).split(".")[-1], kv="int4",
                   body=ran[0], instance=inst, ptxas=k.ptxas.get(inst),
                   repeat_identical=True,
                   max_abs_err=err, atol=INT8KV_ATOL, gflop=flops / 1e9,
                   ms=t_k, eager_ms=t_eager, plain_ms=t_p, library_ms=t_lib,
                   library_dequant_ms=t_deq, mbytes=nbytes / 1e6,
                   bound_ms=b_ms, bound_by=b_by,
                   bound_ms_by_operations=flops / PEAK_OPS_S[
                       str(dt).split(".")[-1]] * 1e3)
        emit("kernel", **row)
        if shape == HEADLINE_FLASH:
            headline = row
        del q, kq, vq, kt, vt, qt
    headline["max_abs_err"] = worst
    return headline


# ------------------------------------------------------------------ #
# Phase 2a: every instantiated tile of the flash bodies
# ------------------------------------------------------------------ #
#: graph replays a timing of the tile sweep (each tile timed twice: the
#: candidates in order, then in reverse)
TILE_ITERS = 20
#: the tile sweep's shapes: FLASH_SHAPES and the main paths' keys they
#: leave out: a 16-token prompt (the engines' warm-up) and a 37-token one
#: (stablelm-1.6b), training's f32 8 x 128 step and the fleet's f32 [2, 64]
#: forward, mistral-nemo-12b's G 4 at tp=1 and per shard at tp=2
TILE_SHAPES = FLASH_SHAPES + (
    (1, 16, 32, 32, 64, 64, torch.bfloat16),
    (1, 37, 32, 32, 64, 64, torch.bfloat16),
    (8, 128, 32, 32, 64, 64, torch.float32),
    (2, 64, 32, 32, 64, 64, torch.float32),
    (1, 200, 32, 8, 128, 128, torch.bfloat16),
    (1, 200, 16, 4, 128, 128, torch.bfloat16))
#: the environment pin's tile, a candidate other than the default
PIN_TILE = (128, 32)


def _tile_case(k, kernel, shape, gen, cpu_gen, dev):
    """Random inputs of ``kernel`` at ``shape`` (FLASH_SHAPES' form; q from
    ``gen`` on the card, codes from ``cpu_gen``): (run at a tile, the plain
    version, the body, the precision label, bytes the call must move, the
    SDPA call on the same values, dequantized)."""
    ref, fp, quant = k.ref, k.flash_prefill, k.quantize
    b, s, hq, hkv, hd, dv, dt = shape
    g = hq // hkv
    q = torch.randn((b, s, hq, hd), generator=gen, device=dev).to(dt)
    out_bytes = 4 * b * s * hq * dv
    if kernel == "flash_prefill":
        kk = torch.randn((b, s, hkv, hd), generator=gen, device=dev).to(dt)
        v = torch.randn((b, s, hkv, dv), generator=gen, device=dev).to(dt)
        args, plain = (q, kk, v), ref.flash_prefill_ref
        body = fp.body_for(q, kk, v)
        nbytes = (q.numel() + kk.numel() + v.numel()) * q.element_size() \
            + out_bytes
        kd, vd = kk, v
    else:
        codes = int8_codes if kernel == "flash_qprefill" else int4_codes
        kc, ks = codes(cpu_gen, (b, s, hkv, hd), dev)
        vc, vs = codes(cpu_gen, (b, s, hkv, dv), dev)
        args = (q, kc, ks, vc, vs)
        plain = getattr(ref, f"{kernel}_ref")
        body = (fp.QBODY if kernel == "flash_qprefill" else fp.Q4BODY)[dt]
        if kernel == "flash_qprefill":
            kd, vd = dequant(kc, ks, dt), dequant(vc, vs, dt)
            kv_bytes = kc.numel() + vc.numel() + 4 * (ks.numel() + vs.numel())
        else:
            kd, vd = (quant.dequantize_kv_int4(c, sc).to(dt)
                      for c, sc in ((kc, ks), (vc, vs)))
            kv_bytes = b * s * hkv * (int4_bytes(1, hd) + int4_bytes(1, dv))
        nbytes = q.numel() * q.element_size() + kv_bytes + out_bytes
    entry = getattr(fp, kernel)

    def run(tile):
        return entry(*args, block_q=tile[0], block_k=tile[1])

    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
              for t in (kd, vd))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True)
    precision = k.autotune.precision_label(kernel, dt == torch.bfloat16)
    return run, (lambda: plain(*args)), body, precision, nbytes, sdpa


def tiles_phase(k, dev, timer):
    """Every tile each flash body instantiates (``autotune.tiles``) held
    against the plain version and timed (a CUDA-graph replay, L2 flushed,
    TILE_ITERS calls; each tile twice, the candidates in order and then in
    reverse) at every TILE_SHAPES shape of flash_prefill (and MLA_FLASH),
    flash_qprefill and flash_q4prefill (their phases' shapes and more): a ``tiles``
    line per shape with each tile's two times and max |err|, the analytic
    winner (the ``cuda`` key's sweep), the default (64, 64) and the fastest
    candidate, the bound and SDPA's time. Returns {kernel: [rows]}."""
    at = k.autotune
    gen = torch.Generator(device=dev).manual_seed(SEED + 60)
    cpu_gen = torch.Generator().manual_seed(SEED + 62)
    out = {}
    for kernel in ("flash_prefill", "flash_qprefill", "flash_q4prefill"):
        shapes = TILE_SHAPES + ((MLA_FLASH,) if kernel == "flash_prefill"
                                else ())
        atol = FLASH_ATOL if kernel == "flash_prefill" else INT8KV_ATOL
        for shape in shapes:
            b, s, hq, hkv, hd, dv, dt = shape
            run, plain, body, precision, nbytes, sdpa = _tile_case(
                k, kernel, shape, gen, cpu_gen, dev)
            want = plain()
            cands = at.tiles(body, at.width(hd, dv))
            winner = at.sweep("cuda", kernel, hd, precision, s)
            default = k.flash_prefill.tile_for(body, hd, dv)
            if winner not in cands or default not in cands:
                raise AssertionError(f"{kernel} {shape}: winner {winner} or "
                                     f"default {default} not among {cands}")
            errs, times = {}, {c: [] for c in cands}
            for tile in cands:
                got = run(tile)
                torch.cuda.synchronize()
                errs[tile] = float((got - want).abs().max())
                if not torch.isfinite(got).all() or errs[tile] > atol:
                    raise AssertionError(f"{kernel} {shape} tile {tile}: max "
                                         f"|err| {errs[tile]} > {atol}")
                del got
            for tile in (*cands, *reversed(cands)):
                times[tile].append(timer.graph_ms(lambda: run(tile),
                                                  iters=TILE_ITERS))
            mean = {t: sum(v) / len(v) for t, v in times.items()}
            fastest = min(cands, key=lambda t: mean[t])
            visible = s * (s + 1) // 2             # causal (query, key) pairs
            flops = 2.0 * (hd + dv) * visible * b * hq
            b_ms, b_by = bound(nbytes, flops, str(dt).split(".")[-1])
            row = dict(kernel=kernel, B=b, S=s, Hq=hq, Hkv=hkv, hd=hd, dv=dv,
                       dtype=str(dt).split(".")[-1], body=body,
                       width_class=at.width(hd, dv),
                       key=at.cache_key("cuda", kernel, hd, precision, s),
                       ms={f"{t[0]}x{t[1]}": times[t] for t in cands},
                       max_abs_err={f"{t[0]}x{t[1]}": errs[t]
                                    for t in cands}, atol=atol,
                       winner=list(winner), winner_ms=mean[winner],
                       default=list(default), default_ms=mean[default],
                       fastest=list(fastest), fastest_ms=mean[fastest],
                       bound_ms=b_ms, bound_by=b_by,
                       library_ms=timer.graph_ms(sdpa))
            emit("tiles", **row)
            out.setdefault(kernel, []).append(row)
            del want, run, plain, sdpa
            torch.cuda.empty_cache()
    return out


def tile_pins_check(k, dev):
    """One flash prefill (HEADLINE_FLASH) through the ``cuda`` leg with
    REPRO_TILE_BQ / REPRO_TILE_BK set to PIN_TILE launches that tile and
    agrees with the plain version; a pair no body instantiates raises in
    the wrapper before any launch, and ``flash_prefill_fwd`` /
    ``flash_mla_fwd`` refuse a pair their body lacks with
    cudaErrorInvalidValue and launch nothing."""
    from repro_torch.api import use_backend
    from repro_torch.kernels import _build, ops

    fp = k.flash_prefill
    b, s, hq, hkv, hd, dv, dt = HEADLINE_FLASH
    gen = torch.Generator(device=dev).manual_seed(SEED + 61)
    q, kk, v = (torch.randn((b, s, h, d), generator=gen, device=dev).to(dt)
                for h, d in ((hq, hd), (hkv, hd), (hkv, dv)))
    body = fp.body_for(q, kk, v)
    before = dict(fp.flash_prefill.launches_by_tile)
    os.environ["REPRO_TILE_BQ"], os.environ["REPRO_TILE_BK"] = map(
        str, PIN_TILE)
    try:
        with use_backend("cuda"):
            got = ops.flash_prefill(q, kk, v)
    finally:
        del os.environ["REPRO_TILE_BQ"], os.environ["REPRO_TILE_BK"]
    torch.cuda.synchronize()
    ran = {t: n - before[t] for t, n in fp.flash_prefill.launches_by_tile
           .items() if n != before[t]}
    pinned = f"{body}:{PIN_TILE[0]}x{PIN_TILE[1]}"
    if PIN_TILE == k.autotune.DEFAULT_TILE or ran != {pinned: 1}:
        raise AssertionError(f"pinned {PIN_TILE}: launched {ran}")
    err = float((got - k.ref.flash_prefill_ref(q, kk, v)).abs().max())
    if err > FLASH_ATOL:
        raise AssertionError(f"pinned {PIN_TILE}: max |err| {err}")
    refused = {}
    launches = fp.flash_prefill.launches
    for bad in ((48, 48), (256, 64), (64, 256)):
        try:
            fp.flash_prefill(q, kk, v, block_q=bad[0], block_k=bad[1])
        except ValueError as e:
            refused[f"{bad[0]}x{bad[1]}"] = str(e)[:120]
        else:
            raise AssertionError(f"tile {bad} did not raise")
    # the C entries refuse a pair their body lacks (the wrapper's check
    # bypassed): hd 128 f32 has no 128-key tile, the MLA body one tile
    fn = _build.function("flash_prefill", "flash_prefill_fwd", [
        _build.P, _build.P, _build.P, _build.I, _build.P, _build.I, _build.I,
        _build.I, _build.I, _build.I, _build.I, _build.I, _build.I,
        _build.P])
    qf, kf, vf = (torch.zeros((1, 64, 2, 128), device=dev) for _ in "qkv")
    outf = torch.full((1, 64, 2, 128), 7.0, device=dev)
    rc = {"flash_prefill_fwd 48x48": fn(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), 0, outf.data_ptr(), 1,
        64, 2, 2, 128, 128, 48, 48, _build.stream_of(qf)),
        "flash_prefill_fwd f32 128x128": fn(
        qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), 0, outf.data_ptr(), 1,
        64, 2, 2, 128, 128, 128, 128, _build.stream_of(qf))}
    mla = _build.function("flash_prefill", "flash_mla_fwd", [
        _build.P, _build.P, _build.P, _build.P, _build.I, _build.I, _build.I,
        _build.I, _build.I, _build.I, _build.I, _build.I, _build.P])
    qm, km = (torch.zeros((1, 64, 2, 192), device=dev, dtype=torch.bfloat16)
              for _ in "qk")
    vm = torch.zeros((1, 64, 2, 128), device=dev, dtype=torch.bfloat16)
    rc["flash_mla_fwd 64x64"] = mla(
        qm.data_ptr(), km.data_ptr(), vm.data_ptr(), outf.data_ptr(), 1, 64,
        2, 2, 192, 128, 64, 64, _build.stream_of(qm))
    torch.cuda.synchronize()
    untouched = bool((outf == 7.0).all())
    if any(c != 1 for c in rc.values()) or not untouched \
            or fp.flash_prefill.launches != launches:
        raise AssertionError(f"uninstantiated pairs: rc {rc}, output "
                             f"untouched {untouched}")
    emit("tile_pins", pinned=list(PIN_TILE), launched=ran, max_abs_err=err,
         refused_by_wrapper=refused, refused_by_entry=rc,
         entry_output_untouched=untouched)


def quantize_int4_phase(k, dev):
    """The int4 KV quantizer (plain PyTorch on every device) on the card
    against the CPU on its edge groups: exact .5 quotients, an all-zero
    group (0/0 -> code 0) and a group whose f16 scale underflows to 0
    (x/0 -> +-7, scale 0), in f32 and bf16."""
    quant = k.quantize
    gen = torch.Generator().manual_seed(SEED + 14)
    t = torch.randn((4, 16, 8, 64), generator=gen) * 3
    halves = torch.tensor([7, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -3.5,
                           4.5, -6.5, 6.5, 0, 1, -7, 5.5]).repeat(2)
    t[0, 0, 0, :32] = halves * 0.25
    t[0, 1, 1, :32] = 0
    t[1, 2, 0, :32] = torch.randn(32, generator=gen) * 1e-9
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        x = t.to(dt)
        want_q, want_s = quant.quantize_kv_int4(x)
        got_q, got_s = quant.quantize_kv_int4(x.to(dev))
        codes = quant.unpack_int4(got_q).cpu()
        ok = (torch.equal(got_q.cpu(), want_q)
              and torch.equal(got_s.cpu(), want_s)
              and bool((codes[0, 1, 1, :32] == 0).all())
              and bool((codes[1, 2, 0, :32].abs() == 7).all())
              and float(got_s[1, 2, 0, 0]) == 0.0
              and codes[0, 0, 0, :8].tolist() == [7, 0, 2, 2, 0, -2, -2, 4])
        rows[str(dt).split(".")[-1]] = ok
        if not ok:
            raise AssertionError(f"quantize_kv_int4 ({dt}): card codes or "
                                 "scales differ from the CPU's")
    emit("quantize_int4", shape=list(t.shape), card_equals_cpu=rows)


def qw_instance(quant, p, dt) -> str:
    """The kernel instantiation that the quantize_weights plan ``p``
    launches."""
    t = "float" if dt == torch.float32 else "__nv_bfloat16"
    if p.route == "cluster":
        return f"quantize_cluster<{t}>"
    return f"quantize_cols<{t}, {p.width // quant.TWO_PASS_TC}>"


def quantize_weights_phase(k, dev, timer):
    """quantize_weights against its plain version at phi-3-vision's weight
    shapes, the JAX package's ragged test shapes and stablelm-1.6b's
    embedding leaf, in bf16 and f32, each input with an all-zero column:
    codes and scales bit for bit. Each row carries the route and plan that
    ran (``quantize.plan_for``) and that instantiation's ptxas line; each
    call moves the route counter of its plan by one, and both routes run."""
    ref, quant = k.ref, k.quantize
    fn = quant.quantize_weights
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    headline = None
    start = dict(fn.routes)
    for kk, n in QW_SHAPES:
        base = torch.randn((kk, n), generator=gen, device=dev) * 0.05
        base[:, 1] = 0.0
        for dt in (torch.bfloat16, torch.float32):
            w = base.to(dt)
            p = quant.plan_for(w)
            before = dict(fn.routes)
            codes, scale = fn(w)
            moved = {r: fn.routes[r] - before[r] for r in before}
            if moved != {r: int(r == p.route) for r in before}:
                raise AssertionError(f"quantize_weights [{kk},{n}] {dt}: "
                                     f"routes moved {moved}, plan {p}")
            want_codes, want_scale = ref.quantize_ref(w)
            torch.cuda.synchronize()
            code_err = int((codes.to(torch.int32)
                            - want_codes.to(torch.int32)).abs().max())
            same_scale = torch.equal(scale.view(torch.int32),
                                     want_scale.view(torch.int32))
            if code_err or not same_scale or int(codes[:, 1].abs().max()):
                raise AssertionError(f"quantize_weights [{kk},{n}] {dt}: "
                                     f"codes max |diff| {code_err}, scales "
                                     f"identical {same_scale}")
            del want_codes, want_scale
            t_k = timer.graph_ms(lambda: fn(w))
            t_eager = timer.eager_ms(lambda: fn(w))
            t_p = timer.graph_ms(lambda: ref.quantize_ref(w), iters=3)
            nbytes = kk * n * (w.element_size() + 1) + 4 * n
            b_ms, b_by = bound(nbytes, 0.0, str(dt).split(".")[-1])
            inst = qw_instance(quant, p, dt)
            row = dict(kernel="quantize_weights", K=kk, N=n,
                       dtype=str(dt).split(".")[-1], route=p.route,
                       plan=p._asdict(), instance=inst,
                       ptxas=k.ptxas.get(inst), max_abs_err=code_err,
                       scales_identical=same_scale, ms=t_k, eager_ms=t_eager,
                       plain_ms=t_p, library_ms=None, bound_ms=b_ms,
                       bound_by=b_by, x_bound=t_k / b_ms)
            emit("kernel", **row)
            if (kk, n, dt) == HEADLINE_QW:
                headline = row
            del w, codes, scale
        del base
    ran = {r: fn.routes[r] - start[r] for r in start}
    if not all(ran.values()):
        raise AssertionError(f"quantize_weights: a route never ran {ran}")
    headline["compare_launches_by_route"] = ran
    return headline


def profile_steps(step_fn, n_steps: int, step_ms: float, watch=None,
                  expect=None):
    """Device time inside ``n_steps`` calls of ``step_fn`` (decode steps, or
    a prefill; one more call runs first, untraced by the window) from a
    torch.profiler trace: busy ms per step, the idle share
    against the unprofiled step time, the kernels with the most device time
    and, if ``watch`` names a kernel template, its ms and calls per step.

    ``expect``: the calls of ``watch`` each step launches (its wrapper's
    count). A trace that shows more fails at once; one that shows fewer has
    lost kernel records, and is taken again, at most PROFILE_ATTEMPTS times
    in all; the lost counts are reported under ``records_lost``."""
    lost = []
    for _ in range(PROFILE_ATTEMPTS):
        out = _profile_once(step_fn, n_steps, step_ms, watch)
        seen = out.get("watched")
        if expect is None or seen is None:
            return out
        got = round(seen["calls_per_step"] * n_steps)
        if got > expect * n_steps:
            raise AssertionError(f"the trace shows {got} {watch} kernels in "
                                 f"{n_steps} steps of {expect}")
        if got == expect * n_steps:
            out["records_lost"] = lost
            return out
        lost.append(expect * n_steps - got)
    raise AssertionError(f"{PROFILE_ATTEMPTS} traces of {n_steps} steps of "
                         f"{expect} {watch} kernels each lost records: {lost}")


def _profile_once(step_fn, n_steps, step_ms, watch):
    """One trace of ``n_steps`` calls after one warm-up call that the trace
    drops (the tracer is running before the first recorded kernel), the
    device drained before the window closes. Device activity only: the
    CPU-side op records (tens of thousands a window) made each window
    several times slower and added no kernel row."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n_steps,
                                   repeat=1)) as prof:
        for i in range(n_steps + 1):
            step_fn()
            if i == n_steps:
                torch.cuda.synchronize()
            prof.step()
    rows = []
    for e in prof.key_averages():
        # kernels only: CPU-side aten ops carry their kernels' time too, and
        # the window's step annotations span their steps on the device
        if not str(getattr(e, "device_type", "")).endswith("CUDA") \
                or e.key.startswith("ProfilerStep"):
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    busy_ms = sum(r[0] for r in rows) / 1e3 / n_steps
    if busy_ms <= 0:
        return {"device_busy_ms_per_step": "not measured"}
    rows.sort(reverse=True)
    out = {"device_busy_ms_per_step": busy_ms,
           "device_idle_share": max(0.0, 1.0 - busy_ms / step_ms),
           "kernels_per_step": sum(r[2] for r in rows) / n_steps,
           "top_kernels": [{"name": name[:80],
                            "ms_per_step": us / 1e3 / n_steps,
                            "calls_per_step": cnt / n_steps}
                           for us, name, cnt in rows[:8]]}
    if watch:
        hits = [(us, cnt) for us, name, cnt in rows
                if f"::{watch}<" in name or f"::{watch}(" in name]
        out["watched"] = {"kernel": watch,
                          "ms_per_step": sum(h[0] for h in hits) / 1e3
                          / n_steps,
                          "calls_per_step": sum(h[1] for h in hits) / n_steps}
    return out


# ------------------------------------------------------------------ #
# Phase 3: the main path at full width
# ------------------------------------------------------------------ #
def e2e_phase(k, dev):
    from repro_torch import configs
    from repro_torch.api.variants import DEFAULT_VARIANTS, VariantSpec
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving import InferenceSession, Pipeline, RequestQueue

    cfg = configs.get_config("stablelm-1.6b").with_overrides(
        n_layers=SERVE_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED)             # on the card by default
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    calib = [{"tokens": torch.randint(0, cfg.vocab_size, (2, 128),
                                      generator=gen, device=dev)}
             for _ in range(2)]
    prompts = [torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                             device=dev) for n in PROMPT_LENS]
    torch.cuda.synchronize()
    emit("e2e_setup", model=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers,
         d_model=cfg.d_model, heads=cfg.n_heads, head_dim=cfg.head_dim,
         d_ff=cfg.d_ff, vocab=cfg.vocab_size,
         init_s=time.perf_counter() - t0)
    totals = {"flash_prefill": 0, "qmatmul_dynamic": 0, "qmatmul_static": 0,
              "qdecode": 0, "flash_qprefill": 0, "flash_q4prefill": 0,
              **{f"flash_prefill.{body}": 0
                 for body in k.flash_prefill.BODY.values()},
              **{f"flash_qprefill.{body}": 0
                 for body in k.flash_prefill.QBODY.values()},
              **{f"flash_q4prefill.{body}": 0
                 for body in k.flash_prefill.Q4BODY.values()},
              **{f"{name}.{body}": 0 for name in _gemms(k)
                 for body in k.qmatmul.BODIES},
              **{f"qdecode.class.{c}": 0
                 for c in k.qdecode.qdecode.launches_by_class},
              **{f"{name}.tile.{t}": 0 for name, fn in _flash(k).items()
                 for t in fn.launches_by_tile}}
    runs = [(spec.variant, spec, cfg) for spec in DEFAULT_VARIANTS]
    runs.append(("dynamic_int8_kv8", VariantSpec.dynamic_int8(),
                 cfg.with_overrides(kv_cache_int8=True)))
    runs.append(("dynamic_int8_kv4", VariantSpec.dynamic_int8(),
                 cfg.with_overrides(kv_cache_precision="int4")))
    for label, spec, cfg in runs:
        t0 = time.perf_counter()
        qparams, info = spec.build(params, cfg, calib_data=calib)
        session = InferenceSession(qparams, cfg)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        pipe = Pipeline(preprocess=lambda raw: raw,
                        infer=lambda batch: session.generate(batch, N_NEW),
                        postprocess=lambda out, raw: out)
        session.generate({"tokens": prompts[0]}, 2)          # warm-up
        torch.cuda.synchronize()

        reset_counters(k)                    # ---- the main path: counted
        queue = RequestQueue(pipe, max_batch=1)
        reqs = [queue.submit({"tokens": p}) for p in prompts]
        t0 = time.perf_counter()
        queue.drain()
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = read_counters(k)          # ---- read right after
        launches.update(check_bodies(k, label, launches,
                                     getattr(torch, cfg.dtype)))

        for r in reqs:
            out = r.result
            if not r.done or out.shape != (1, N_NEW) \
                    or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
                raise AssertionError(f"{label}: bad result {out}")
        tier = cfg.kv_precision
        # the dense int4 decode is the plain q4decode_ref (no kernel), as
        # in the JAX package
        need = {"fp": ["flash_prefill"],
                "int8": ["flash_qprefill", "qdecode"],
                "int4": ["flash_q4prefill"]}[tier] \
            + {"dynamic_int8": ["qmatmul_dynamic"],
               "static_int8": ["qmatmul_static"]}.get(spec.variant, [])
        for name in need:
            if launches[name] <= 0:
                raise AssertionError(f"{label}: {name} never launched "
                                     f"on the main path ({launches})")
        attention = ("flash_prefill", "flash_qprefill", "flash_q4prefill",
                     "qdecode", "paged_decode", "paged_qdecode",
                     "paged_q4decode")
        stray = [name for name in attention
                 if launches[name] and name not in need]
        if stray:
            raise AssertionError(f"{label}: {stray} launched over an {tier} "
                                 f"KV cache ({launches})")
        for name in totals:
            totals[name] += launches[name]

        # per-phase times and launches: one 255-token prefill (bucket 256,
        # cache 512), then 32 decode steps, host clock around synchronize
        batch = {"tokens": torch.nn.functional.pad(prompts[-1], (0, 1))}
        with torch.no_grad():
            reset_counters(k)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            last, cache = prefill(session.params, batch, cfg, pad_to=512,
                                  n_valid=PROMPT_LENS[-1])
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            per_prefill = read_counters(k)
            # one more prefill, profiled: its device time and the share
            # of it its attention kernel takes, one launch a layer
            watch = {"fp": "flash_tc", "int8": "flash_qtc",
                     "int4": "flash_q4tc"}[tier]
            ptrace = profile_steps(
                lambda: prefill(session.params, batch, cfg, pad_to=512,
                                n_valid=PROMPT_LENS[-1]), 1, prefill_ms,
                watch, expect=cfg.n_layers)
            if not torch.isfinite(last).all():
                raise AssertionError(f"{label}: non-finite logits")
            prefill_k = need[0]
            if per_prefill[prefill_k] != cfg.n_layers:
                raise AssertionError(f"{label}: {prefill_k} launched "
                                     f"{per_prefill[prefill_k]} times in one "
                                     f"prefill, not {cfg.n_layers}")
            # the 256-row GEMMs take wgmma; the unembed reads the last row
            check_gemm_bodies(f"{label} prefill", per_prefill, gemv=1)
            nxt = torch.argmax(last[:, -1], dim=-1).reshape(1, 1)
            reset_counters(k)
            logits, cache = decode_step(session.params, cache, nxt,
                                        PROMPT_LENS[-1], cfg)
            per_step = read_counters(k)
            check_gemm_bodies(f"{label} decode step", per_step)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(N_NEW):
                nxt = torch.argmax(logits[:, -1], dim=-1).reshape(1, 1)
                logits, cache = decode_step(session.params, cache, nxt,
                                            PROMPT_LENS[-1] + 1 + i, cfg)
            torch.cuda.synchronize()
            decode_ms = (time.perf_counter() - t0) * 1e3 / N_NEW
            state = {"logits": logits, "cache": cache,
                     "pos": PROMPT_LENS[-1] + 1 + N_NEW}

            def one_step():
                nxt = torch.argmax(state["logits"][:, -1],
                                   dim=-1).reshape(1, 1)
                state["logits"], state["cache"] = decode_step(
                    session.params, state["cache"], nxt, state["pos"], cfg)
                state["pos"] += 1
            trace = profile_steps(one_step, 4, decode_ms)
        emit("e2e", variant=label, kv_cache=cfg.kv_precision,
             quantized_leaves=len(info["quantized_paths"]),
             calibration_batches=info.get("calibration_batches", 0),
             build_s=build_s, requests=len(reqs), prompt_lens=PROMPT_LENS,
             new_tokens_each=N_NEW, serve_s=elapsed,
             tokens_per_s=len(reqs) * N_NEW / elapsed,
             prefill_ms_s255=prefill_ms, prefill_trace=ptrace,
             decode_step_ms=decode_ms,
             launches=launches, launches_per_prefill=per_prefill,
             launches_per_decode_step=per_step, decode_trace=trace,
             peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        del session, qparams, pipe, queue, reqs, cache, state
        torch.cuda.empty_cache()
    return totals


# ------------------------------------------------------------------ #
# Phase 4: the continuous-batching engine at full width
# ------------------------------------------------------------------ #
def engine_trace(cfg):
    """16 greedy requests, prompts uniform in 37..255 tokens, 32 new tokens
    each, Poisson arrivals 2 ticks apart on average. Requests 4-7 share one
    128-token prefix followed by 9..32 tokens of their own, so later ones
    hit the prefix cache (a remainder of at most 2 blocks is not demoted)."""
    import dataclasses

    from repro_torch.serving import ArrivalTrace

    trace = ArrivalTrace.generate(cfg, TRACE_N, seed=SEED + 5,
                                  mean_interarrival=TRACE_GAP,
                                  prompt_len=TRACE_PROMPT,
                                  max_new=(N_NEW, N_NEW))
    prefix = torch.randint(0, cfg.vocab_size, (1, SHARED_PREFIX),
                           generator=torch.Generator().manual_seed(SEED + 6))
    reqs = list(trace.requests)
    for i in SHARED:
        own = reqs[i].tokens[:, :9 + reqs[i].tokens.shape[1] % 24]
        reqs[i] = dataclasses.replace(reqs[i], tokens=torch.cat([prefix, own],
                                                                dim=1))
    return ArrivalTrace(tuple(reqs), trace.seed, trace.mean_interarrival)


def decode_window(k, engine, cfg, gen, watch=None, expect=None):
    """Fill every slot with a 60-token request (40 new tokens: 7 blocks
    each, so the window never preempts; ``[1, 60, K]`` tokens with K
    codebooks; with a frontend, its conditioning embeds too), step until
    all slots decode, then count one step's launches, time 8 steps and
    profile 4 (``watch``: the attention kernel whose device time the
    profile reports, ``expect`` of them a step)."""
    cb = (cfg.n_codebooks,) if cfg.n_codebooks > 1 else ()
    for _ in range(engine.n_slots):
        fe = (torch.randn((1, cfg.n_frontend_tokens, cfg.frontend_dim),
                          generator=gen) if cfg.n_frontend_tokens else None)
        engine.submit(torch.randint(0, cfg.vocab_size, (1, 60, *cb),
                                    generator=gen),
                      max_new_tokens=40, frontend_embeds=fe)
    for _ in range(16):
        engine.step()
    if not all(r is not None and r.status == "decode" for r in engine.active):
        raise AssertionError("decode window: a slot is not decoding")
    reset_counters(k)
    engine.step()
    per_step = read_counters(k)
    check_gemm_bodies("decode window step", per_step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        engine.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 8
    trace = profile_steps(engine.step, 4, step_ms, watch, expect)
    engine.run()
    return per_step, step_ms, trace


def engine_phase(k, dev):
    """Replays of the trace: fp32 and dynamic int8 (paged, then dense), then
    dynamic int8 over an int8 KV cache (paged with the same 65 blocks, dense,
    and paged with the bf16 pool's bytes: about twice the blocks), then
    dynamic int8 over an int4 KV cache (paged with the same 65 blocks, whose
    counting metrics must equal the bf16-KV replay's, and dense). Returns
    the launch totals of the paged replays and of every replay."""
    from repro_torch import configs
    from repro_torch.api.variants import VariantSpec
    from repro_torch.models import init_params
    from repro_torch.serving import (ContinuousBatchingEngine,
                                     InferenceSession, replay)
    from repro_torch.serving.kvcache import kv_bytes_per_block

    cfg = configs.get_config("stablelm-1.6b").with_overrides(
        n_layers=SERVE_LAYERS)
    cfg8 = cfg.with_overrides(kv_cache_int8=True)
    cfg4 = cfg.with_overrides(kv_cache_precision="int4")
    params = init_params(cfg, seed=SEED)
    trace = engine_trace(cfg)
    prompt_tokens = sum(r.tokens.shape[1] for r in trace.requests)
    emit("engine_setup", model=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers,
         requests=len(trace), prompt_lens=[r.tokens.shape[1]
                                           for r in trace.requests],
         arrival_ticks=[r.arrival_step for r in trace.requests],
         prompt_tokens=prompt_tokens, new_tokens_each=N_NEW,
         shared_prefix_requests=list(SHARED), **ENGINE, **PAGED)
    # the int8-KV pool at the bf16 pool's bytes (65 blocks incl. the trash)
    budget = PAGED["n_blocks"] * kv_bytes_per_block(cfg, PAGED["block_size"])
    budget_kw = {"paged": True, "block_size": PAGED["block_size"],
                 "kv_budget_bytes": budget}
    runs = (("fp32", VariantSpec.fp32(), cfg, ("paged", "dense")),
            ("dynamic_int8", VariantSpec.dynamic_int8(), cfg,
             ("paged", "dense")),
            ("dynamic_int8_kv8", VariantSpec.dynamic_int8(), cfg8,
             ("paged", "dense", "paged_budget")),
            ("dynamic_int8_kv4", VariantSpec.dynamic_int8(), cfg4,
             ("paged", "dense")))
    # per KV tier: (paged decode, dense decode, prefill) kernels; the dense
    # int4 decode is the plain q4decode_ref, as in the JAX package
    tier_kernels = {"fp": ("paged_decode", None, "flash_prefill"),
                    "int8": ("paged_qdecode", "qdecode", "flash_qprefill"),
                    "int4": ("paged_q4decode", None, "flash_q4prefill")}
    attention = {n for names in tier_kernels.values() for n in names if n}
    paged_totals, all_totals, streams, reports = {}, {}, {}, {}
    for label, spec, vcfg, modes in runs:
        depth = {**params, "layers": params["layers"][:vcfg.n_layers]}
        qparams, _ = spec.build(depth, vcfg)
        session = InferenceSession(qparams, vcfg)
        tier = vcfg.kv_precision
        for mode in modes:
            kw = dict(ENGINE, **{"paged": PAGED, "dense": {},
                                 "paged_budget": budget_kw}[mode])
            engine = ContinuousBatchingEngine(session, **kw)
            engine.warmup(prompt_len=64, max_new_tokens=4)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counters(k)                # ---- this path: counted
            t0 = time.perf_counter()
            report = replay(engine, trace)
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t0
            launches = read_counters(k)      # ---- read right after
            launches.update(check_bodies(k, f"{label}/{mode}", launches,
                                         getattr(torch, vcfg.dtype)))
            reqs = engine.all_requests
            for r in reqs:
                if not r.done or len(r.out_tokens) != N_NEW or not all(
                        0 <= t < cfg.vocab_size for t in r.out_tokens):
                    raise AssertionError(f"{label}/{mode}: request "
                                         f"{r.rid} ended {r.status} with "
                                         f"{r.out_tokens}")
            streams[label, mode] = [r.out_tokens for r in reqs]
            reports[label, mode] = report
            paged = mode != "dense"
            paged_k, dense_k, prefill_k = tier_kernels[tier]
            attend = paged_k if paged else dense_k
            need = [prefill_k] + ([attend] if attend else []) + (
                ["qmatmul_dynamic"] if spec.variant == "dynamic_int8" else [])
            for name in need:
                if launches[name] <= 0:
                    raise AssertionError(f"{label}/{mode}: {name} "
                                         f"never launched ({launches})")
            stray = sorted(n for n in attention
                           if launches[n] and n not in need)
            if stray:
                raise AssertionError(f"{label}/{mode}: {stray} launched "
                                     f"over an {tier} KV cache ({launches})")
            if launches[prefill_k] % vcfg.n_layers:
                raise AssertionError(f"{label}/{mode}: {launches[prefill_k]}"
                                     f" {prefill_k} launches are not "
                                     f"{vcfg.n_layers} per prefill")
            if mode == "paged" and (report["preempted"] < 1
                                    or report["prefix_hit_tokens"] <= 0):
                raise AssertionError(
                    f"{label}: the paged replay must preempt and hit "
                    f"the prefix cache ({report['preempted']}, "
                    f"{report['prefix_hit_tokens']})")
            counting = ("preempted", "prefix_hit_tokens", "kv_blocks_peak",
                        "decode_steps")
            base = reports.get(("dynamic_int8", mode))
            if tier == "int4" and mode == "paged" and any(
                    report[c] != base[c] for c in counting):
                raise AssertionError(
                    f"{label}: counting metrics "
                    f"{[report[c] for c in counting]} differ from the "
                    f"bf16-KV replay's {[base[c] for c in counting]}")
            peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
            gen = torch.Generator().manual_seed(SEED + 8)
            # the attention kernel each window's trace must name
            watch = {("fp", True): "paged_decode_split",
                     ("int8", True): "paged_qdecode_split",
                     ("int4", True): "paged_q4decode_split",
                     ("int8", False): "qdecode_split"}.get((tier, paged))
            per_step, step_ms, dtrace = decode_window(k, engine, cfg, gen,
                                                      watch, vcfg.n_layers)
            if mode == "paged" and per_step[attend] != vcfg.n_layers:
                raise AssertionError(f"{attend} launched {per_step[attend]} "
                                     f"times in one decode step, not "
                                     f"{vcfg.n_layers}")
            tokens = report["generated_tokens"]
            extra = {}
            if paged:
                extra = {"pool_blocks": engine.kv.alloc.n_blocks,
                         "pool_bytes": engine.kv.kv_bytes_in_use(
                             engine.kv.alloc.n_blocks)}
            if tier != "fp":
                same = sum(a == b for a, b in zip(
                    streams[label, mode],
                    streams["dynamic_int8", mode.replace("_budget", "")]))
                extra["streams_equal_to_bf16_kv"] = same
            emit("engine", variant=label, mode=mode,
                 kv_cache=vcfg.kv_precision, layers=vcfg.n_layers,
                 requests=report["completed"], generated_tokens=tokens,
                 serve_s=serve_s, tokens_per_s=tokens / serve_s,
                 p50_ttft_s=report["p50_ttft_s"],
                 p99_ttft_s=report["p99_ttft_s"],
                 decode_steps=report["decode_steps"],
                 clock_ticks=report["clock_ticks"],
                 serve_ms_per_step=serve_s * 1e3 / report["decode_steps"],
                 decode_step_ms_8_slots=step_ms,
                 **{key: report[key] for key in (
                     "preempted", "prefix_hit_tokens", "kv_blocks_peak",
                     "kv_hbm_bytes_per_req", "prefill_tokens",
                     "prompt_tokens_computed")}, **extra,
                 launches=launches, launches_per_decode_step=per_step,
                 decode_trace=dtrace, peak_mem_gb=peak_gb)
            for name, n in launches.items():
                all_totals[name] = all_totals.get(name, 0) + n
                if paged:
                    paged_totals[name] = paged_totals.get(name, 0) + n
            del engine
            torch.cuda.empty_cache()
        same = sum(a == b for a, b in zip(streams[label, "paged"],
                                          streams[label, "dense"]))
        emit("engine_agreement", variant=label,
             paged_equals_dense_streams=same, of=len(trace))
        del session, qparams
        torch.cuda.empty_cache()
    return paged_totals, all_totals, streams


# ------------------------------------------------------------------ #
# Phase 4a: the kernel Backend registry on the main path's model
# ------------------------------------------------------------------ #
def _registry_us(k, dev):
    """Host us a call of one tiny decode GEMM (M 1, K = N = 256: its device
    time far below the host's) launched through the registry's dispatch
    (``current_backend().qmatmul_dynamic_packed`` under ``cuda``) and
    through the kernel entry directly, REGISTRY_CALLS calls each, in
    BACKENDS_ROUNDS turns; the least and the median of each."""
    from repro_torch.api import current_backend, use_backend

    gen = torch.Generator(device=dev).manual_seed(SEED + 113)
    x = torch.randn((1, 256), generator=gen, device=dev).to(torch.bfloat16)
    w = torch.randint(-127, 128, (256, 256), generator=gen, device=dev,
                      dtype=torch.int8)
    wp = k.qmatmul.pack_weight(w)
    ws = torch.rand((1, 256), generator=gen, device=dev) * 1e-3
    entry = k.dynquant.qmatmul_dynamic_packed
    calls = {"direct": lambda: entry(x, wp, ws, out_dtype=torch.bfloat16),
             "registry": lambda: current_backend().qmatmul_dynamic_packed(
                 x, wp, ws, out_dtype=torch.bfloat16)}
    rounds = {name: [] for name in calls}
    with use_backend("cuda"):
        for fn in calls.values():
            fn()
        for _ in range(BACKENDS_ROUNDS):
            for name, fn in calls.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(REGISTRY_CALLS):
                    fn()
                torch.cuda.synchronize()
                rounds[name].append((time.perf_counter() - t0) * 1e6
                                    / REGISTRY_CALLS)
    return {name: {"min": min(r), "median": statistics.median(r)}
            for name, r in rounds.items()}


def _decode_windows(k, sessions, cfg, prompt):
    """Per pin of ``sessions`` (None: unpinned): batch-1 decode steps of
    its weights after a prefill of ``prompt``, under its pin; the launches
    of one step, host ms a step over BACKENDS_STEPS steps in
    BACKENDS_ROUNDS rounds that take the pins in turn (the least, the
    median and every round's), then 4 profiled steps."""
    from repro_torch.api import use_backend
    from repro_torch.models import decode_step, prefill

    n, states, out = prompt.shape[1], {}, {}

    def step(pin):
        st = states[pin]
        nxt = torch.argmax(st["logits"][:, -1], dim=-1).reshape(1, 1)
        st["logits"], st["cache"] = decode_step(
            sessions[pin].params, st["cache"], nxt, st["pos"], cfg)
        st["pos"] += 1

    with torch.no_grad():
        for pin, session in sessions.items():
            with use_backend(pin):
                last, cache = prefill(session.params, {"tokens": prompt}, cfg,
                                      pad_to=512, n_valid=n)
                states[pin] = {"logits": last, "cache": cache, "pos": n}
                step(pin)
                torch.cuda.synchronize()
                reset_counters(k)
                step(pin)
                torch.cuda.synchronize()
                got = read_counters(k)
            out[pin] = {"launches_per_step": sum(got[name]
                                                 for name in _wrappers(k)),
                        "rounds_ms": []}
        for _ in range(BACKENDS_ROUNDS):
            for pin in sessions:
                with use_backend(pin):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(BACKENDS_STEPS):
                        step(pin)
                    torch.cuda.synchronize()
                out[pin]["rounds_ms"].append(
                    (time.perf_counter() - t0) * 1e3 / BACKENDS_STEPS)
        for pin in sessions:
            r = out[pin]["rounds_ms"]
            out[pin].update(host_ms_per_step=min(r),
                            median_ms_per_step=statistics.median(r))
            with use_backend(pin):
                out[pin]["decode_trace"] = profile_steps(
                    lambda pin=pin: step(pin), 4, out[pin]["host_ms_per_step"])
    return {str(pin): v for pin, v in out.items()}


def backends_phase(k, dev):
    """The kernel Backend registry (``repro_torch.api.backends``) on the
    main path's model: stablelm-1.6b at published width and
    BACKENDS_LAYERS layers in bf16, one dynamic-int8 artifact. Three
    sessions over it in one process, unpinned, pinned ``cuda`` and pinned
    ``ref``: a 200-token prompt's logits counted (the GEMMs and flash
    prefill launch under ``cuda`` and unpinned, nothing under ``ref``;
    unpinned equals ``cuda`` bit for bit; ``cuda`` within 2.5x the ``ref``
    session's own one-rounding nudge of ``ref``), greedy streams (equal, or
    parting where ``_partings`` accepts the tie), each pin's host ms a
    decode step with its launches and device profile, and the registry's
    own host us a call (``_registry_us``). Then the bf16 weights behind an
    engine pinned ``cuda-tp`` with no ``tp=``: tp=2, each per-shard kernel
    launched exactly twice as often as by the ``cuda`` engine
    (``tp_counts``); and a spec engine whose target is pinned ``cuda`` and
    whose draft, the int8 artifact's ``ref`` session, adds no launch.
    Returns the launch totals of the counted ``cuda`` runs."""
    from repro_torch import configs
    from repro_torch.api import ModelArtifact, VariantSpec, available_backends
    from repro_torch.models import init_params
    from repro_torch.serving import (ArrivalTrace, ContinuousBatchingEngine,
                                     SpecConfig)

    cfg = configs.get_config("stablelm-1.6b").with_overrides(
        n_layers=BACKENDS_LAYERS)
    nl, dt = cfg.n_layers, getattr(torch, cfg.dtype)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED + 110)
    qparams, _ = VariantSpec.dynamic_int8().build(params, cfg)
    artifact = ModelArtifact.create("stablelm", "v1", params, cfg) \
        .with_variant("dynamic_int8", qparams)
    pins = (None, "cuda", "ref")
    sessions = {pin: artifact.session(backend=pin) for pin in pins}
    gen = torch.Generator(device=dev).manual_seed(SEED + 111)
    prompts = [torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                             device=dev) for n in BACKENDS_PROMPTS]
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    totals = {}

    # one prompt's logits under each pin, counted
    batch = {"tokens": prompts[-1]}
    logits, launches = {}, {}
    for pin, session in sessions.items():
        session.logits(batch)                           # warm-up
        out, _, launches[pin] = _counted(
            k, dt, f"backends/{pin}", lambda: session.logits(batch))
        logits[pin] = out.float()
    with nudged_norms():
        nudged = sessions["ref"].logits(batch).float()
    nudge = float((nudged - logits["ref"]).abs().max())
    err = float((logits["cuda"] - logits["ref"]).abs().max())
    need = ("flash_prefill", "qmatmul_dynamic")
    if any(launches["cuda"][name] <= 0 for name in need) \
            or launches["cuda"]["flash_prefill"] != nl:
        raise AssertionError(f"backends: the cuda session launched "
                             f"{launches['cuda']}")
    if launches[None] != launches["cuda"]:
        raise AssertionError(f"backends: unpinned {launches[None]} against "
                             f"cuda {launches['cuda']}")
    if any(launches["ref"].values()):
        raise AssertionError(f"backends: the ref session launched "
                             f"{launches['ref']}")
    if not torch.equal(logits[None], logits["cuda"]):
        raise AssertionError("backends: unpinned logits differ from cuda's")
    if not (torch.isfinite(logits["cuda"]).all() and err <= 2.5 * nudge):
        raise AssertionError(f"backends: cuda vs ref logits max |err| {err}"
                             f" > 2.5 x the nudge {nudge}")
    _merge(totals, launches["cuda"])

    # greedy streams of both pins, partings held to the nudge
    streams = {pin: [sessions[pin].generate({"tokens": p}, BACKENDS_NEW)
                     [0].tolist() for p in prompts] for pin in ("cuda", "ref")}
    trace = types.SimpleNamespace(requests=[types.SimpleNamespace(tokens=p)
                                            for p in prompts])
    parted = _partings(sessions["cuda"].params, cfg, trace, streams["ref"],
                       streams["cuda"], dev, {})
    if not all(p["ok"] for p in parted):
        raise AssertionError(f"backends: ref / cuda streams part beyond a "
                             f"tie: {parted}")

    # each pin's decode step, host and device; the registry's own cost
    steps = _decode_windows(k, sessions, cfg, prompts[0])
    per_pin = {pin: v["launches_per_step"] for pin, v in steps.items()}
    if per_pin["cuda"] <= 0 or per_pin["None"] != per_pin["cuda"] \
            or per_pin["ref"] != 0:
        raise AssertionError(f"backends: launches a decode step {per_pin}")
    reg = _registry_us(k, dev)
    per_step = steps["cuda"]["launches_per_step"]
    emit("backends", model=cfg.name, dtype=cfg.dtype, layers=nl,
         d_model=cfg.d_model, vocab=cfg.vocab_size, variant="dynamic_int8",
         setup_s=setup_s, prompt=BACKENDS_PROMPTS[-1],
         launches={str(p): v for p, v in launches.items()},
         max_abs_err=err, ref_nudge=nudge, bound=2.5 * nudge,
         logit_scale=float(logits["ref"].abs().max()),
         streams_equal=sum(a == b for a, b in zip(streams["cuda"],
                                                  streams["ref"])),
         of=len(prompts), partings=parted, decode=steps,
         registry_us_per_call=reg["registry"],
         direct_us_per_call=reg["direct"],
         registry_ms_per_step=(reg["registry"]["min"] - reg["direct"]["min"])
         * per_step / 1e3, available=available_backends())
    del sessions, logits, nudged
    torch.cuda.empty_cache()

    # a pinned cuda-tp twin opts into tp=2 at its default width
    trace = ArrivalTrace.generate(cfg, BACKENDS_TRACE_N, seed=SEED + 112,
                                  mean_interarrival=TRACE_GAP,
                                  prompt_len=TP_PROMPT,
                                  max_new=(BACKENDS_NEW, BACKENDS_NEW))
    runs = {}
    for pin in ("cuda", "cuda-tp"):
        engine = ContinuousBatchingEngine(params, cfg, backend=pin,
                                          n_slots=4, max_len=TP_LEN,
                                          paged=True, block_size=16)
        tp = engine.tp
        if tp != (2 if pin == "cuda-tp" else 1):
            raise AssertionError(f"backends: {pin} engine at tp={tp}")
        engine.warmup(prompt_len=16, max_new_tokens=2)
        torch.cuda.synchronize()
        (report, reqs), serve_ms, got = _counted(
            k, dt, f"backends/{pin}", lambda: frontend_replay(
                engine, trace, [None] * len(trace.requests)))
        _check_streams(f"backends/{pin}", reqs, BACKENDS_NEW, cfg)
        runs[tp] = {"launches": got, "steps": report["decode_steps"],
                    "prefills": len(reqs) + report["preempted"],
                    "streams": [r.out_tokens for r in reqs],
                    "serve_ms": serve_ms}
        _merge(totals, got)
        del engine
        torch.cuda.empty_cache()
    tp_counts("backends/cuda-tp", nl, "fp", True, runs)
    tp_parted = _partings(params, cfg, trace, runs[1]["streams"],
                          runs[2]["streams"], dev, {})
    if not all(p["ok"] for p in tp_parted):
        raise AssertionError(f"backends: cuda-tp streams part beyond a tie: "
                             f"{tp_parted}")

    # a spec engine: target pinned cuda, its int8 draft the ref session's
    draft = artifact.session(backend="ref")
    engine = ContinuousBatchingEngine(params, cfg, backend="cuda", n_slots=4,
                                      max_len=TP_LEN,
                                      spec=SpecConfig(draft=draft, k=SPEC_K))
    if engine.draft_backend is None or engine.draft_backend.name != "ref":
        raise AssertionError(f"backends: draft under {engine.draft_backend}")
    engine.warmup(prompt_len=16, max_new_tokens=2)
    torch.cuda.synchronize()
    (report, reqs), spec_ms, spec_launches = _counted(
        k, dt, "backends/spec", lambda: frontend_replay(
            engine, trace, [None] * len(trace.requests)))
    _check_streams("backends/spec", reqs, BACKENDS_NEW, cfg)
    want = {name: 0 for name in _wrappers(k)}
    want["flash_prefill"] = nl * len(reqs)
    if {name: spec_launches[name] for name in want} != want \
            or report["spec_draft_tokens"] <= 0:
        raise AssertionError(f"backends: spec engine launched "
                             f"{spec_launches}, want {want} (draft tokens "
                             f"{report['spec_draft_tokens']})")
    _merge(totals, spec_launches)
    emit("backends_engines", model=cfg.name, layers=nl,
         tp_engines={f"tp{tp}": {"backend": pin, "serve_ms": r["serve_ms"],
                                 "decode_steps": r["steps"],
                                 "prefills": r["prefills"],
                                 "launches": {n: r["launches"][n]
                                              for n in TP_KERNELS}}
                     for (tp, r), pin in zip(sorted(runs.items()),
                                             ("cuda", "cuda-tp"))},
         tp2_equals_tp1_streams=sum(
             a == b for a, b in zip(runs[1]["streams"], runs[2]["streams"])),
         tp_partings=tp_parted, spec_target="cuda", spec_draft="ref",
         spec_serve_ms=spec_ms, spec_launches=spec_launches,
         spec_draft_tokens=report["spec_draft_tokens"],
         acceptance_rate=report["acceptance_rate"])
    del engine, draft, artifact, qparams, params
    torch.cuda.empty_cache()
    return totals


# ------------------------------------------------------------------ #
# Phase 5: card against CPU
# ------------------------------------------------------------------ #
def cpu_runs(cfg, VariantSpec):
    """(CPU_TOL key, variant, config) of the card-vs-CPU runs: fp32 and
    dynamic-int8 weights over the fp KV cache, fp32 weights over int8 and
    over int4."""
    return (("fp32", VariantSpec.fp32(), cfg),
            ("dynamic_int8", VariantSpec.dynamic_int8(), cfg),
            ("fp32_int8kv", VariantSpec.fp32(),
             cfg.with_overrides(kv_cache_int8=True)),
            ("fp32_int4kv", VariantSpec.fp32(),
             cfg.with_overrides(kv_cache_precision="int4")))


PAGED_TABLE = ((7, 2, 9, 4, -1, -1, -1, -1),)   # scattered ids, -1 tail


@contextlib.contextmanager
def nudged_norms():
    """Every normalized activation times the float after 1.0 in its own
    dtype (a relative nudge of 2^-23 in f32, 2^-7 in bf16: one rounding):
    what such a rounding does to a run's own logits sizes each ``CPU_TOL``
    entry and the paged-vs-dense bound."""
    from repro_torch.models import transformer

    plain = transformer.rms_norm
    transformer.rms_norm = lambda w, x, eps: plain(w, x, eps) * torch.full(
        (), 1.0 + torch.finfo(x.dtype).eps, dtype=x.dtype, device=x.device)
    try:
        yield
    finally:
        transformer.rms_norm = plain


def teacher_forced(params, cfg, tokens, device, paged, forced=None,
                   n_steps=8, table=PAGED_TABLE, frontend=None):
    """Host logits of the prefill of ``tokens`` [1, n] ([1, n, K] with K
    codebooks; ``frontend``: [1, n_frontend_tokens, dim] embeds put in
    front) and ``n_steps`` decode steps fed ``forced`` tokens (default: the
    run's own argmax). Paged: ``prefill_paged`` with the token axis padded
    to a multiple of 64 (pads go to the trash block) through ``table``,
    then ``decode_step_paged``. Dense: a cache of the prefill's rows +
    n_steps slots rounded up to a multiple of 64."""
    from repro_torch.api.backends import bind_for, use_backend
    from repro_torch.models import (decode_step, decode_step_paged, prefill,
                                    prefill_paged)
    from repro_torch.serving.kvcache import init_paged_pools

    batch = {"tokens": tokens.to(device)}
    n = tokens.shape[1]
    if frontend is not None:
        batch["frontend_embeds"] = frontend.to(device)
        n += frontend.shape[1]
    tables = torch.tensor(table, dtype=torch.int32).to(device)
    out, fed = [], []
    # the CPU runs the plain path (``ref``), the card the backend in scope
    with torch.no_grad(), use_backend(bind_for(None, device)):
        if paged:
            n_blocks = max(12, int(tables.max()) + 1)
            cache = init_paged_pools(cfg, n_blocks, 16, device=device)
            batch["tokens"] = torch.nn.functional.pad(
                batch["tokens"], (0, -n % 64))
            last, _ = prefill_paged(params, cache, batch, n, tables, cfg)
        else:
            last, cache = prefill(params, batch, cfg,
                                  pad_to=-(-(n + n_steps) // 64) * 64)
        out.append(last.cpu())
        for i in range(n_steps):
            nxt = forced[i] if forced is not None else torch.argmax(
                out[-1][:, -1:], dim=-1)
            fed.append(nxt)
            if paged:
                pos = torch.tensor([n + i]).to(device)
                last, _ = decode_step_paged(params, cache, nxt.to(device),
                                            pos, tables, cfg)
            else:
                last, cache = decode_step(params, cache, nxt.to(device),
                                          n + i, cfg)
            out.append(last.cpu())
    return out, fed


def logit_diff(a_steps, b_steps):
    """(max |diff|, worst step's mean |diff|) over teacher-forced steps."""
    return (max(float((a - b).abs().max()) for a, b in zip(a_steps, b_steps)),
            max(float((a - b).abs().mean()) for a, b in zip(a_steps, b_steps)))


def paged_vs_dense_phase(dev, streams):
    """Whether the engine replay's paged and dense streams part at a tie or
    at a fault: one request of the trace, stablelm-1.6b at full width in
    bf16 over the fp KV cache (the fp32-passthrough replay's weights and
    depth), teacher-forced with the dense replay's tokens through the
    dense and the paged path on the card. Per step, max and mean |dlogit|
    paged against dense beside what the card's own one-rounding nudge
    (``nudged_norms``) does to the dense logits; the top-1 / top-2 margin
    at the step where the replay's streams part. The bound is 2.5 times
    the nudge, as ``CPU_TOL`` is sized."""
    from repro_torch import configs
    from repro_torch.api.variants import VariantSpec
    from repro_torch.models import init_params

    cfg = configs.get_config("stablelm-1.6b")
    vcfg = cfg.with_overrides(n_layers=SERVE_LAYERS)
    params = init_params(cfg, seed=SEED)
    depth = {**params, "layers": params["layers"][:vcfg.n_layers]}
    qparams, _ = VariantSpec.fp32().build(depth, vcfg)
    del params, depth
    trace = engine_trace(cfg)
    paged_s, dense_s = streams["fp32", "paged"], streams["fp32", "dense"]
    parted = [(i, next(j for j, (a, b) in enumerate(zip(p, d)) if a != b))
              for i, (p, d) in enumerate(zip(paged_s, dense_s)) if p != d]
    rid, step = parted[0] if parted else (0, None)
    tokens = trace.requests[rid].tokens
    forced = [torch.tensor([[t]]) for t in dense_s[rid]]
    n_steps = N_NEW - 1
    table = (tuple(range(-(-(tokens.shape[1] + n_steps) // 16), 0, -1))
             + (-1, -1),)                     # scattered ids, -1 tail
    runs = {}
    for name, paged, nudge in (("dense", False, False),
                               ("paged", True, False),
                               ("dense_nudged", False, True)):
        with nudged_norms() if nudge else contextlib.nullcontext():
            runs[name], _ = teacher_forced(qparams, vcfg, tokens, dev, paged,
                                           forced, n_steps, table)
    per_step = [(float((p - d).abs().max()), float((p - d).abs().mean()),
                 float((u - d).abs().max()), float((u - d).abs().mean()))
                for p, d, u in zip(runs["paged"], runs["dense"],
                                   runs["dense_nudged"])]
    worst_max, worst_mean = logit_diff(runs["paged"], runs["dense"])
    nudge_max, nudge_mean = logit_diff(runs["dense_nudged"], runs["dense"])
    tol_max, tol_mean = 2.5 * nudge_max, 2.5 * nudge_mean
    margins = None
    if step is not None:
        margins = {}
        for name in ("dense", "paged"):
            top = torch.topk(runs[name][step][0, -1].float(), 2)
            margins[name] = {"top1": int(top.indices[0]),
                             "top2": int(top.indices[1]),
                             "margin": float(top.values[0] - top.values[1])}
    ok = worst_max <= tol_max and worst_mean <= tol_mean
    emit("paged_vs_dense", model=cfg.name, dtype=vcfg.dtype,
         layers=vcfg.n_layers, request=rid, prompt=tokens.shape[1],
         decode_steps=n_steps, streams_parted=len(parted),
         parting_step=step,
         replay_tokens_at_parting=None if step is None else
         {"paged": paged_s[rid][step], "dense": dense_s[rid][step]},
         margins_at_parting=margins, max_abs_dlogit=worst_max,
         mean_abs_dlogit=worst_mean, nudge_max=nudge_max,
         nudge_mean=nudge_mean, tol_max=tol_max, tol_mean=tol_mean,
         per_step_paged_max_mean_nudge_max_mean=per_step,
         logit_scale=float(runs["dense"][0].abs().max()), ok=ok)
    if not ok:
        raise AssertionError(f"paged vs dense logits differ by max "
                             f"{worst_max} / mean {worst_mean}, above 2.5x "
                             f"the nudge ({nudge_max} / {nudge_mean})")


def card_vs_cpu_phase(dev, paged: bool):
    """The same fp32 weights at full width and 2 layers, the CPU's plain path
    against the card's kernel path (both fed the CPU's tokens), beside what
    a one-rounding nudge does on the CPU alone."""
    from repro_torch import configs
    from repro_torch.api.variants import VariantSpec
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceSession

    cfg = configs.get_config("stablelm-1.6b").with_overrides(
        n_layers=2, dtype="float32")
    params = init_params(cfg, seed=SEED + 3, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 48),
                           generator=torch.Generator().manual_seed(SEED + 4))
    for label, spec, vcfg in cpu_runs(cfg, VariantSpec):
        qparams, _ = spec.build(params, vcfg)
        card = InferenceSession(qparams, vcfg)         # moves to the card
        cpu_steps, fed = teacher_forced(qparams, vcfg, tokens, "cpu", paged)
        card_steps, _ = teacher_forced(card.params, vcfg, tokens, dev, paged,
                                       fed)
        with nudged_norms():
            nudge_steps, _ = teacher_forced(qparams, vcfg, tokens, "cpu",
                                            paged, fed)
        worst_max, worst_mean = logit_diff(cpu_steps, card_steps)
        nudge_max, nudge_mean = logit_diff(cpu_steps, nudge_steps)
        tol_max, tol_mean = CPU_TOL[label]
        ok = worst_max <= tol_max and worst_mean <= tol_mean
        emit("card_vs_cpu_paged" if paged else "card_vs_cpu", variant=label,
             kv_cache=vcfg.kv_precision, layers=vcfg.n_layers,
             d_model=vcfg.d_model, vocab=vcfg.vocab_size, prompt=48,
             decode_steps=8, table=[list(r) for r in PAGED_TABLE]
             if paged else None, max_abs_err=worst_max,
             mean_abs_err=worst_mean, tol_max=tol_max, tol_mean=tol_mean,
             cpu_nudge_max=nudge_max, cpu_nudge_mean=nudge_mean,
             logit_scale=float(cpu_steps[0].abs().max()), ok=ok)
        if not ok:
            raise AssertionError(f"{'paged ' if paged else ''}card vs CPU "
                                 f"logits differ by max {worst_max} / mean "
                                 f"{worst_mean} ({label})")
        del card


# ------------------------------------------------------------------ #
# Phase 6: the VQI lifecycle on phi-3-vision
# ------------------------------------------------------------------ #
def _captures(cfg, n, seed, dev):
    """``n`` single-image VQI captures (patch embeddings, the text prompt,
    labels) with asset ids, drawn from a seeded host generator."""
    from repro_torch.data import vqi_batch
    from repro_torch.fleet.vqi import TASK

    gen = torch.Generator().manual_seed(seed)
    out = []
    for i in range(n):
        raw = vqi_batch(gen, cfg, TASK, 1, dev)
        raw["asset_ids"] = [f"tower-{seed}-{i}"]
        out.append(raw)
    return out


def _stack_captures(raws):
    out = {key: torch.cat([r[key] for r in raws]) for key in raws[0]
           if key != "asset_ids"}
    out["asset_ids"] = [a for r in raws for a in r["asset_ids"]]
    return out


def _classes(logits, cfg):
    """(asset, condition) argmax per image from VQI logits, one host copy."""
    from repro_torch.fleet.vqi import TASK

    lay = TASK.vocab_layout(cfg)
    off = cfg.n_frontend_tokens
    a = logits[:, off, lay["asset0"]:lay["asset0"] + TASK.n_assets].argmax(-1)
    c = logits[:, off + 1,
               lay["cond0"]:lay["cond0"] + TASK.n_conditions].argmax(-1)
    return [tuple(r) for r in torch.stack([a, c], 1).tolist()]


def _gemm_counts(params):
    """(static, dynamic) int8 GEMMs per forward of a param tree: every int8
    leaf but the embedding table (packed on the card: ``w_packed``), static
    where it carries an act_scale."""
    from repro_torch.tree import map_with_path

    paths = set()
    map_with_path(lambda path, _: paths.add(path), params)
    linears = [p[:p.rindex("/") + 1] for p in paths
               if p.endswith(("/w_int8", "/w_packed"))
               and not p.startswith("embed/")]
    static = sum(f"{p}act_scale" in paths for p in linears)
    return static, len(linears) - static


def vqi_phase(k, dev):
    """phi-3-vision-4.2b at its published width and VQI_LAYERS of its 32
    layers, bf16, random
    seeded weights: the three VQI variants (static calibrated on 2 VQI
    batches) published into a registry in a temporary directory, each
    activated by its own EdgeAgent (admission, fetch, sha256 check, session
    on the card) and served through ``inspection_pipeline`` behind a
    RequestQueue, 16 captures in batches of 8, with every kernel's launch
    counter zeroed before and read after. Returns the launch totals."""
    import tempfile

    from repro_torch import configs
    from repro_torch.api import (ArtifactRegistry, DeviceProfile, EdgeAgent,
                                 ModelArtifact, TelemetryHub)
    from repro_torch.core.quant import tree_size_bytes
    from repro_torch.fleet import vqi
    from repro_torch.models import init_params
    from repro_torch.serving import RequestQueue

    cfg = configs.get_config(VLM).with_overrides(n_layers=VQI_LAYERS)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED + 20)
    model = ModelArtifact.create("vqi", "full", params, cfg)
    calib = vqi.vqi_calib_batches(cfg, 2, batch=VQI_BATCH, device=dev)
    captures = _captures(cfg, VQI_CAPTURES, SEED + 22, dev)
    torch.cuda.synchronize()
    emit("vqi_setup", model=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers,
         d_model=cfg.d_model, heads=cfg.n_heads,
         head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff,
         vocab=cfg.vocab_size, frontend_dim=cfg.frontend_dim,
         patch_tokens=cfg.n_frontend_tokens, captures=VQI_CAPTURES,
         batch=VQI_BATCH, fp_bytes=tree_size_bytes(params),
         init_s=time.perf_counter() - t0)
    totals, preds = {}, {}
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as root:
        registry = ArtifactRegistry(root)
        for spec in vqi.vqi_variant_specs(2):
            t0 = time.perf_counter()
            ref = registry.publish_variants(model, [spec],
                                            calib_data=calib)[spec.variant].ref
            publish_s = time.perf_counter() - t0
            agent = EdgeAgent(f"vqi-{spec.variant}", registry,
                              DeviceProfile("h100", 80 * 10**9))
            t0 = time.perf_counter()
            agent.activate(ref)              # install (fetch + sha256), load
            torch.cuda.synchronize()
            activate_s = time.perf_counter() - t0
            hub = TelemetryHub()
            queue = RequestQueue(vqi.inspection_pipeline(agent, cfg, hub),
                                 max_batch=VQI_BATCH, stack=_stack_captures,
                                 unstack=lambda res, n: [[p] for p in res])
            warm = _stack_captures(captures[:VQI_BATCH])
            agent.infer({key: warm[key]
                         for key in ("tokens", "frontend_embeds")})
            agent.session.stats.reset()
            torch.cuda.synchronize()

            reset_counters(k)                # ---- the main path: counted
            reqs = [queue.submit(c) for c in captures]
            t0 = time.perf_counter()
            queue.drain()
            torch.cuda.synchronize()
            serve_s = time.perf_counter() - t0
            launches = read_counters(k)      # ---- read right after
            launches.update(check_bodies(k, f"vqi {spec.variant}", launches,
                                         getattr(torch, cfg.dtype)))

            forwards = agent.session.stats.calls
            check_gemm_bodies(f"vqi {spec.variant}", launches, gemv=0)
            n_static, n_dynamic = _gemm_counts(agent.session.params)
            want = {"flash_prefill": cfg.n_layers,
                    "qmatmul_static": n_static, "qmatmul_dynamic": n_dynamic}
            per_forward = {name: n / forwards for name, n in launches.items()}
            for name, n in want.items():
                if per_forward[name] != n:
                    raise AssertionError(f"vqi {spec.variant}: {name} "
                                         f"launched {per_forward[name]} "
                                         f"times per forward, not {n}")
            if agent.session.device.type != dev.type:
                raise AssertionError(f"vqi {spec.variant}: the session is "
                                     f"on {agent.session.device}")
            if not all(r.done and len(r.result) == 1 for r in reqs) \
                    or hub.total_records != VQI_CAPTURES \
                    or len(hub.asset_conditions) != VQI_CAPTURES:
                raise AssertionError(f"vqi {spec.variant}: {hub.summary()}")
            preds[spec.variant] = [(r.result[0]["asset_type"],
                                    r.result[0]["condition"]) for r in reqs]
            for name, n in launches.items():
                totals[name] = totals.get(name, 0) + n
            emit("vqi", variant=spec.variant, artifact=ref.key,
                 quantized_gemms={"static": n_static, "dynamic": n_dynamic},
                 calibration_batches=2 if spec.variant == "static_int8"
                 else 0, publish_s=publish_s, activate_s=activate_s,
                 size_bytes=ref.size_bytes,
                 tree_size_bytes=tree_size_bytes(agent.session.params),
                 captures=VQI_CAPTURES, forwards=forwards, serve_s=serve_s,
                 ms_per_image=serve_s * 1e3 / VQI_CAPTURES,
                 forward_ms_mean=agent.session.stats.mean_ms,
                 launches=launches, launches_per_forward=per_forward,
                 telemetry=hub.model_metrics(agent.active.key),
                 predictions_equal_to_fp32=sum(
                     a == b for a, b in zip(preds[spec.variant],
                                            preds["fp32"])),
                 peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
            del agent, queue, reqs
            torch.cuda.empty_cache()
    del params, model, calib, captures
    torch.cuda.empty_cache()
    return totals


def vqi_card_vs_cpu_phase(dev):
    """phi-3-vision at published width and 2 layers in f32 on a
    teacher-forced VQI batch: the CPU's plain path against the card's
    kernel path, fp32, dynamic int8 and static int8, beside what a
    one-rounding nudge does on the CPU alone (``card_vs_cpu_phase``'s
    method)."""
    from repro_torch import configs
    from repro_torch.api import VariantSpec, use_backend
    from repro_torch.data import vqi_batch
    from repro_torch.fleet.vqi import TASK, vqi_calib_batches
    from repro_torch.models import forward, init_params
    from repro_torch.serving import InferenceSession

    cfg = configs.get_config(VLM).with_overrides(n_layers=2, dtype="float32")
    params = init_params(cfg, seed=SEED + 24, device="cpu")
    raw = vqi_batch(torch.Generator().manual_seed(SEED + 25), cfg, TASK, 2,
                    "cpu")
    batch = {key: raw[key] for key in ("tokens", "frontend_embeds")}
    # static int8 is calibrated once, on the CPU; the card gets those params
    calib = vqi_calib_batches(cfg, 2, batch=2, device="cpu")
    for label, spec in (("vqi_fp32", VariantSpec.fp32()),
                        ("vqi_dynamic_int8", VariantSpec.dynamic_int8()),
                        ("vqi_static_int8", VariantSpec.static_int8(2))):
        # the CPU's plain path: the ref backend, by name
        with torch.no_grad(), use_backend("ref"):
            qparams, _ = spec.build(params, cfg, calib_data=calib)
            cpu = forward(qparams, batch, cfg)[0]
            with nudged_norms():
                nudge = forward(qparams, batch, cfg)[0]
        card = InferenceSession(qparams, cfg, device=dev).logits(batch).cpu()
        worst_max, worst_mean = logit_diff([cpu], [card])
        nudge_max, nudge_mean = logit_diff([cpu], [nudge])
        tol_max, tol_mean = CPU_TOL[label]
        ok = worst_max <= tol_max and worst_mean <= tol_mean
        emit("vqi_card_vs_cpu", variant=label, layers=cfg.n_layers,
             d_model=cfg.d_model, vocab=cfg.vocab_size,
             tokens=cfg.n_frontend_tokens + batch["tokens"].shape[1],
             images=2, max_abs_err=worst_max, mean_abs_err=worst_mean,
             tol_max=tol_max, tol_mean=tol_mean, cpu_nudge_max=nudge_max,
             cpu_nudge_mean=nudge_mean, logit_scale=float(cpu.abs().max()),
             same_classes=sum(a == b for a, b in zip(
                 _classes(cpu, cfg), _classes(card, cfg))), ok=ok)
        if not ok:
            raise AssertionError(f"vqi card vs CPU logits differ by max "
                                 f"{worst_max} / mean {worst_mean} ({label})")
        del qparams, cpu, card, nudge


def lifecycle_phase(k, dev):
    """The paper's lifecycle through the registry at published widths and
    LIFECYCLE_LAYERS layers, f32: publish v1's three variants, roll v1 out
    (staged, HealthGate()) to one standard and one Pi-4-class device on the
    card, run inspections that push telemetry, publish a noised v2 and roll
    it out: the gate must fail and every device go back to v1. Then the
    lifecycle latencies of one device. Returns the launch totals."""
    import tempfile

    from repro_torch import configs
    from repro_torch.api import (ArtifactRegistry, DeviceProfile, EdgeAgent,
                                 HealthGate, ModelArtifact, RolloutPolicy)
    from repro_torch.fleet import vqi
    from repro_torch.models import init_params
    from repro_torch.serving import RequestQueue
    from repro_torch.tree import map_with_path

    cfg = configs.get_config(VLM).with_overrides(n_layers=LIFECYCLE_LAYERS,
                                                 dtype="float32")
    params = init_params(cfg, seed=SEED + 26)
    calib = vqi.vqi_calib_batches(cfg, 2, batch=VQI_BATCH, device=dev)
    probe = _stack_captures(_captures(cfg, VQI_BATCH, SEED + 27, dev))
    probe = {key: probe[key] for key in ("tokens", "frontend_embeds")}
    captures = _captures(cfg, VQI_BATCH, SEED + 28, dev)
    noise = torch.Generator(device=dev).manual_seed(SEED + 29)
    v2 = map_with_path(lambda _, t: _noised(t, noise), params)
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    times, sizes = {}, {}
    with tempfile.TemporaryDirectory(dir=build) as root:
        registry = ArtifactRegistry(root)
        reset_counters(k)                    # ---- the lifecycle: counted
        for version, weights in (("v1", params), ("v2", v2)):
            model = ModelArtifact.create("vqi", version, weights, cfg)
            for spec in vqi.vqi_variant_specs(2):
                t0 = time.perf_counter()
                art = registry.publish_variants(
                    model, [spec], calib_data=calib,
                    evaluate=lambda p, c: vqi.evaluate(p, c, 1, VQI_BATCH,
                                                       device=dev))
                times[f"publish_{version}_{spec.variant}_s"] = \
                    time.perf_counter() - t0
                sizes[f"{version}_{spec.variant}"] = \
                    art[spec.variant].size_bytes
        if not sizes["v1_fp32"] > 2 * sizes["v1_static_int8"]:
            raise AssertionError(f"fp32 not > 2x static_int8 bytes: {sizes}")
        fleet = vqi.make_fleet(registry, 1, 1)
        reference = registry.get("vqi", "v1", "fp32").session()
        want = _classes(reference.logits(probe), cfg)
        del reference

        def validate(agent):
            if agent.session is None:
                return {}
            t0 = time.perf_counter()
            got = _classes(agent.infer(probe), cfg)
            return {"accuracy": sum(a == b for a, b in zip(got, want))
                    / len(want),
                    "mean_latency_ms": (time.perf_counter() - t0) * 1e3}

        policy = RolloutPolicy(gate=HealthGate())
        t0 = time.perf_counter()
        r1 = fleet.staged_rollout("vqi", "v1", validate, policy)
        times["rollout_v1_s"] = time.perf_counter() - t0
        active_v1 = {d: a.active.key for d, a in fleet.devices.items()}
        if not r1.succeeded or "int8" not in active_v1["edge-pi4-0"]:
            raise AssertionError(f"v1 rollout: {r1.reason} {active_v1}")
        inspected = {}
        for did, agent in fleet.devices.items():
            queue = RequestQueue(
                vqi.inspection_pipeline(agent, cfg, fleet.telemetry),
                max_batch=4, stack=_stack_captures,
                unstack=lambda res, n: [[p] for p in res])
            reqs = [queue.submit(c) for c in captures]
            queue.drain()
            inspected[did] = [r.result[0]["condition"] for r in reqs]
        t0 = time.perf_counter()
        r2 = fleet.staged_rollout("vqi", "v2", validate, policy)
        times["rollout_v2_with_rollback_s"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = read_counters(k)          # ---- read right after
        launches.update(check_bodies(k, "lifecycle", launches,
                                     getattr(torch, cfg.dtype)))
        active = {d: a.active.key for d, a in fleet.devices.items()}
        if r2.succeeded or any(":v1:" not in key for key in active.values()):
            raise AssertionError(f"v2 rollout must fail and roll back: "
                                 f"{r2.reason} {active}")
        for name in ("flash_prefill", "qmatmul_dynamic", "qmatmul_static"):
            if launches[name] <= 0:
                raise AssertionError(f"lifecycle: {name} never launched "
                                     f"({launches})")
        if any(a.session.device.type != dev.type
               for a in fleet.devices.values()):
            raise AssertionError("lifecycle: a session is not on the card")
        hub = fleet.telemetry
        if hub.total_records != len(captures) * len(fleet.devices):
            raise AssertionError(f"lifecycle telemetry: {hub.summary()}")

        # the lifecycle latencies of one device (the quantities of
        # benchmarks/lifecycle_bench.py)
        bench = EdgeAgent("bench", registry, DeviceProfile("bench", 10**11))
        for variant in ("fp32", "static_int8"):
            t0 = time.perf_counter()
            registry.fetch(registry.ref("vqi", "v1", variant))
            torch.cuda.synchronize()
            times[f"fetch_verify_{variant}_s"] = time.perf_counter() - t0
        ref1, ref2 = (registry.ref("vqi", v, "fp32") for v in ("v1", "v2"))
        t0 = time.perf_counter()
        bench.install(ref1)
        times["install_fp32_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        bench.activate(ref1)
        torch.cuda.synchronize()
        times["activate_fp32_s"] = time.perf_counter() - t0
        bench.activate(ref2)
        t0 = time.perf_counter()
        bench.rollback()
        torch.cuda.synchronize()
        times["rollback_fp32_s"] = time.perf_counter() - t0
        emit("lifecycle", model=cfg.name, layers=cfg.n_layers,
             d_model=cfg.d_model, dtype=cfg.dtype, sizes_bytes=sizes,
             v1_succeeded=r1.succeeded, v1_active=active_v1,
             v2_succeeded=r2.succeeded, v2_reason=r2.reason[:200],
             rolled_back=r2.rolled_back, active_after=active,
             audit=[e["kind"] for e in fleet.audit],
             canary_metrics={str(d): m for d, m in
                             (r1.canary_metrics or {}).items()},
             inspected=inspected, telemetry=hub.summary(),
             launches=launches, latencies_s=times)
        del fleet, bench
    del params, v2
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------------ #
# Training, and the paper's train -> publish -> roll out -> retrain loop
# ------------------------------------------------------------------ #
def flash_grad_check(k, dev):
    """The flash_prefill Function (the kernel's forward, the plain
    backward) against torch.autograd through flash_prefill_ref on the same
    inputs, at FLASH_GRAD_SHAPES; each launch takes its dtype's body."""
    fp = k.flash_prefill
    out = []
    for b, s, hq, hkv, hd, dtype in FLASH_GRAD_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(b * s + hq + hd)
        q, kk, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                    .requires_grad_(True)
                    for shape in ((b, s, hq, hd), (b, s, hkv, hd),
                                  (b, s, hkv, hd)))
        dout = torch.randn((b, s, hq, hd), generator=gen, device=dev)
        before = dict(fp.flash_prefill.launches_by_body)
        got_out = fp.flash_prefill(q, kk, v)
        if got_out.grad_fn is None or fp.flash_prefill.launches_by_body != {
                **before, fp.BODY[dtype]: before[fp.BODY[dtype]] + 1}:
            raise AssertionError(f"flash grad {dtype}: the kernel did not "
                                 "launch under its autograd Function")
        got = torch.autograd.grad(got_out, (q, kk, v), dout)
        f32 = [t.detach().float().requires_grad_(True) for t in (q, kk, v)]
        want = torch.autograd.grad(k.ref.flash_prefill_ref(*f32), f32, dout)
        errs = {}
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            if g.dtype != dtype:
                raise AssertionError(f"flash grad {name}: {g.dtype}")
            errs[name] = ((g.float() - w).abs().max()
                          / w.abs().max()).item()
        out.append({"B": b, "S": s, "Hq": hq, "Hkv": hkv, "hd": hd,
                    "dtype": str(dtype), "body": fp.BODY[dtype],
                    "rel_err": errs, "tol": FLASH_GRAD_TOL[dtype]})
        if max(errs.values()) > FLASH_GRAD_TOL[dtype]:
            raise AssertionError(f"flash grads differ: {out[-1]}")
    return out


def refuse_grad_check(k, dev):
    """Every kernel wrapper without a backward raises, naming itself, when
    an input requires grad; flash_prefill alone carries a graph."""
    f = lambda *shape: torch.randn(shape, device=dev)  # noqa: E731
    x = f(4, 64).requires_grad_(True)
    w = torch.randint(-127, 128, (64, 48), device=dev, dtype=torch.int8)
    ws = f(1, 48).abs() * 1e-2
    q = f(2, 4, 1, 64).requires_grad_(True)
    pool = torch.zeros((5, 16, 4, 64), device=dev)
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device=dev)
    pos = torch.tensor([20, 9], dtype=torch.int32, device=dev)
    i8 = torch.zeros((5, 16, 4, 64), dtype=torch.int8, device=dev)
    i4 = torch.zeros((5, 16, 4, 32), dtype=torch.int8, device=dev)
    s8 = torch.ones((5, 16, 4), device=dev)
    s4 = torch.ones((5, 16, 4, 2), dtype=torch.float16, device=dev)
    qp = f(2, 16, 4, 64).requires_grad_(True)
    dense = (i8[:2], s8[:2], i8[:2], s8[:2])
    calls = {
        "qmatmul_dynamic": lambda: k.dynquant.qmatmul_dynamic(x, w, ws),
        "qmatmul_static": lambda: k.qmatmul.qmatmul_static(x, w, ws, 0.05),
        "quantize_activations": lambda: k.qmatmul.quantize_activations(x),
        "qdecode": lambda: k.qdecode.qdecode(q, *dense,
                                             torch.zeros((2, 16),
                                                         device=dev)),
        "paged_decode": lambda: k.paged_attn.paged_decode(
            q, pool, pool, tables, pos),
        "paged_qdecode": lambda: k.paged_attn.paged_qdecode(
            q, i8, s8, i8, s8, tables, pos),
        "paged_q4decode": lambda: k.paged_attn.paged_q4decode(
            q, i4, s4, i4, s4, tables, pos),
        "flash_qprefill": lambda: k.flash_prefill.flash_qprefill(qp, *dense),
        "flash_q4prefill": lambda: k.flash_prefill.flash_q4prefill(
            qp, i4[:2], s4[:2], i4[:2], s4[:2]),
        "quantize_weights": lambda: k.quantize.quantize_weights(
            f(64, 48).requires_grad_(True)),
    }
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            if not str(e).startswith(f"{name}: "):
                raise
        else:
            raise AssertionError(f"{name} dropped a gradient silently")
    return sorted(calls)


def train_phase(k, dev):
    """stablelm-1.6b at published width and depth in f32 (remat on):
    the flash Function's grads against the plain version, every other
    wrapper refusing a grad, then ``fit`` on ``lm_stream`` batches:
    TRAIN_STEPS steps with fp32 moments, then TRAIN_INT8_STEPS with int8
    moments. Each step: loss, grad norm, ms (host clock around a device
    sync, the next batch's draw included), tokens/s and flash launches (2
    per layer: the forward and the recompute). Returns the launch
    totals of the two fits."""
    from repro_torch import configs
    from repro_torch.data import lm_stream
    from repro_torch.models import init_params
    from repro_torch.training import (OptimizerConfig, adamw_init, fit,
                                      train_step)
    from repro_torch.tree import get_path, leaves_with_path

    grads = flash_grad_check(k, dev)
    refused = refuse_grad_check(k, dev)
    emit("train_checks", flash_grads=grads, refuse_grad=refused)

    cfg = configs.get_config(TRAIN_ARCH).with_overrides(dtype="float32")
    if not cfg.remat:
        raise AssertionError("train: remat must be on, as configured")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED + 40)
    stream = lm_stream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED + 41,
                       device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    fp = k.flash_prefill.flash_prefill
    marks = []

    def timed(src):
        while True:
            torch.cuda.synchronize()
            marks.append((time.perf_counter(), fp.launches))
            yield next(src)

    torch.cuda.reset_peak_memory_stats(dev)
    reset_counters(k)                        # ---- the main path: counted
    history = []
    for steps, int8_state in ((TRAIN_STEPS, False),
                              (TRAIN_INT8_STEPS, True)):
        oc = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=steps,
                             int8_state=int8_state)
        params, hist = fit(cfg, oc, timed(stream), steps, params=params,
                           log_every=1, log_fn=lambda line: None,
                           device=dev)
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), fp.launches))
        history += [dict(h, int8_state=int8_state) for h in hist]
        marks.append(None)                   # a fit's end: no step here
    launches = read_counters(k)              # ---- read right after
    launches.update(check_bodies(k, "train", launches, torch.float32))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    spans = [(a, b) for a, b in zip(marks, marks[1:]) if a and b]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for h, ((t_a, n_a), (t_b, n_b)) in zip(history, spans):
        h["ms"] = (t_b - t_a) * 1e3
        h["tokens_per_s"] = tokens / (t_b - t_a)
        h["flash_launches"] = n_b - n_a
        emit("train_step", **{key: h[key] for key in (
            "step", "int8_state", "loss", "grad_norm", "lr", "token_acc",
            "ms", "tokens_per_s", "flash_launches")})
    losses = [h["loss"] for h in history]
    norms = [h["grad_norm"] for h in history]
    if len(history) != TRAIN_STEPS + TRAIN_INT8_STEPS \
            or not all(map(math.isfinite, losses + norms)):
        raise AssertionError(f"train: losses {losses}, norms {norms}")
    # the fp32-moment fit must lower the loss. The int8-moment fit is held
    # to finite values only: its per-row absmax codes of v (the JAX
    # package's, bit for bit on the CPU) put every element whose grad is
    # below 1/16 of its row's largest at code 0 (v spans the square of the
    # grads' range), printed as int8_v_zero_share; AdamW's step
    # m / (sqrt(v) + eps) then grows on those elements
    if not losses[TRAIN_STEPS - 1] < losses[0]:
        raise AssertionError(f"train: the fp32-moment fit did not lower "
                             f"the loss: {losses[:TRAIN_STEPS]}")
    want = 2 * cfg.n_layers                  # the forward and the recompute
    if any(h["flash_launches"] != want for h in history):
        raise AssertionError(f"train: flash launches per step "
                             f"{[h['flash_launches'] for h in history]}, "
                             f"want {want}")
    others = {n: c for n, c in launches.items()
              if c and not n.startswith("flash_prefill")}
    if others:
        raise AssertionError(f"train: other kernels launched: {others}")
    # the int8 moments after one step from the trained params: the share
    # of v codes that are 0 (the element's second moment is lost)
    oc8 = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=1,
                          int8_state=True)
    _, state, _ = train_step(params, adamw_init(params, oc8), next(stream),
                             cfg, oc8)
    codes = [get_path(state["mu"], path)["v"]["q"]
             for path, _ in leaves_with_path(params)]
    zero_share = (sum((c == 0).sum().item() for c in codes)
                  / sum(c.numel() for c in codes))
    del state, codes
    emit("train", model=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers,
         d_model=cfg.d_model, heads=cfg.n_heads, head_dim=cfg.head_dim,
         d_ff=cfg.d_ff, vocab=cfg.vocab_size, remat=cfg.remat,
         batch=TRAIN_BATCH, seq=TRAIN_SEQ, init_s=init_s,
         losses=losses, grad_norms=norms,
         ms_per_step=[h["ms"] for h in history],
         tokens_per_s=[h["tokens_per_s"] for h in history],
         peak_mem_gb=peak_gb, launches=launches,
         int8_v_zero_share=zero_share)
    del params, stream
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------------ #
# production: the dry-run launcher on the host, the mesh train step on
# the card
# ------------------------------------------------------------------ #
# the dry-run of the card's mesh step: a (1, 1) fake world, the step's
# own config, batch and sequence
PREDICT = r"""
import json, sys
from repro_torch import configs as C
from repro_torch.launch.dryrun import trace_on_mesh
from repro_torch.launch.mesh import init_fake_world, make_test_mesh
arch, batch, seq, dtype = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
    sys.argv[4]
init_fake_world(1)
mesh = make_test_mesh(data=1, model=1)
cfg = C.get_config(arch).with_overrides(dtype=dtype)
res, build_s, trace_s = trace_on_mesh(cfg, "train_4k", mesh, batch=batch,
                                      seq=seq)
print("PREDICT_JSON:" + json.dumps(dict(res, build_s=build_s,
                                        trace_s=trace_s)))
"""


def production_start():
    """Start the host's two dry-run subprocesses (at low priority, so the
    card phases they overlap keep their host): the ``--production``
    launcher and the prediction of the card's mesh step."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))

    def start(args):
        return subprocess.Popen(
            [sys.executable, *args], cwd=ROOT, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            preexec_fn=lambda: os.nice(10))

    t0 = time.perf_counter()
    return {"t0": t0,
            "launcher": start(["-m", "repro_torch.launch.train", "--arch",
                               TRAIN_ARCH, "--production"]),
            "predict": start(["-c", PREDICT, TRAIN_ARCH, str(TRAIN_BATCH),
                              str(TRAIN_SEQ), "float32"])}


def production_stop(procs) -> None:
    for name in ("launcher", "predict"):
        p = procs.get(name)
        if p is not None and p.poll() is None:
            p.kill()
            p.wait()


def _finish(proc, what, timeout=900):
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode:
        raise AssertionError(f"production: {what} exited "
                             f"{proc.returncode}: {err[-2000:]}")
    return out


def _launcher_blocks(out):
    """The launcher's roofline and memory JSON blocks and its trace s."""
    dec = json.JSONDecoder()
    blocks, i = [], out.find("{")
    while i >= 0:
        obj, end = dec.raw_decode(out, i)
        blocks.append(obj)
        i = out.find("{", end)
    trace = [ln for ln in out.splitlines() if ln.startswith("trace_s:")]
    if len(blocks) != 2 or not trace:
        raise AssertionError(f"production: launcher printed {out[-2000:]}")
    return blocks[0], blocks[1], float(trace[0].split(":")[1])


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def production_phase(k, dev, procs):
    """The launcher's records, then stablelm-1.6b's mesh train step on the
    card against the unsharded step (see the module's docstring). Returns
    the mesh steps' launch totals."""
    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.data import lm_stream
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import (PEAK_FLOPS_BF16, PEAK_FLOPS_F32,
                                         make_test_mesh)
    from repro_torch.models import init_params
    from repro_torch.models import sharding as sh
    from repro_torch.training import OptimizerConfig, adamw_init, train_step

    roofline, memory, trace_s = _launcher_blocks(
        _finish(procs["launcher"], "the --production launcher"))
    launcher_wall_s = time.perf_counter() - procs["t0"]
    emit("production_launcher", arch=TRAIN_ARCH, shape="train_4k",
         mesh="single (16, 16)", roofline=roofline, memory=memory,
         trace_s=trace_s, wall_s_since_start=launcher_wall_s)
    pred_out = _finish(procs["predict"], "the dry-run prediction")
    pred = json.loads([ln for ln in pred_out.splitlines()
                       if ln.startswith("PREDICT_JSON:")][0].split(":", 1)[1])

    cfg = configs.get_config(TRAIN_ARCH).with_overrides(dtype="float32")
    if not cfg.remat:
        raise AssertionError("production: remat must be on, as configured")
    torch.cuda.empty_cache()
    params = init_params(cfg, seed=SEED + 50)
    stream = lm_stream(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=SEED + 51,
                       device=dev)
    batches = [next(stream) for _ in range(PROD_STEPS)]
    oc = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=PROD_STEPS)
    fp = k.flash_prefill.flash_prefill

    def steps(p, st, place):
        hist = []
        for b in batches:
            torch.cuda.synchronize()
            t0, n0 = time.perf_counter(), fp.launches
            p, st, m = train_step(p, st, place(b), cfg, oc)
            loss, norm = float(sh.full_tree(m)["loss"]), \
                float(sh.full_tree(m)["grad_norm"])
            torch.cuda.synchronize()
            hist.append({"loss": loss, "grad_norm": norm,
                         "ms": (time.perf_counter() - t0) * 1e3,
                         "flash_launches": fp.launches - n0})
            if len(hist) == 1:
                first_peak = torch.cuda.max_memory_allocated(dev)
        return hist, first_peak

    # the unsharded steps (outside the counted window: the comparison)
    plain, _ = steps(params, adamw_init(params, oc), lambda b: b)
    torch.cuda.empty_cache()

    # the mesh steps: the main path, counted
    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = make_test_mesh(data=1, model=1, device_type="cuda")
        with sh.set_mesh(mesh):
            p_specs = S.param_shardings(cfg, mesh, params)
            pd = sh.distribute(params, p_specs, mesh)
            st = adamw_init(params, oc)
            od = sh.distribute(st, S.opt_shardings(cfg, mesh, st, p_specs),
                               mesh)
            del st
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counters(k)                # ---- the main path: counted
            mesh_hist, peak = steps(pd, od, lambda b: sh.distribute(
                b, S.batch_shardings(mesh, b), mesh))
            launches = read_counters(k)      # ---- read right after
            launches.update(check_bodies(k, "production", launches,
                                         torch.float32))
            del pd, od
    finally:
        dist.destroy_process_group()
    want = 2 * cfg.n_layers                  # the forward and the recompute
    if any(h["flash_launches"] != want for h in mesh_hist):
        raise AssertionError(f"production: flash launches per mesh step "
                             f"{[h['flash_launches'] for h in mesh_hist]}, "
                             f"want {want}")
    others = {n: c for n, c in launches.items()
              if c and not n.startswith("flash_prefill")}
    if others:
        raise AssertionError(f"production: other kernels launched: {others}")
    for key in ("loss", "grad_norm"):
        for a, b in zip(mesh_hist, plain):
            if not (math.isfinite(a[key])
                    and abs(a[key] - b[key]) <= PROD_TOL * abs(b[key])):
                raise AssertionError(
                    f"production: mesh {key} {a[key]} against unsharded "
                    f"{b[key]} (tol {PROD_TOL})")
    ms = statistics.median(h["ms"] for h in mesh_hist[1:])
    plain_ms = statistics.median(h["ms"] for h in plain[1:])
    emit("production", model=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers,
         d_model=cfg.d_model, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
         mesh=[1, 1], steps=PROD_STEPS, tol=PROD_TOL,
         mesh_steps=mesh_hist, unsharded_steps=plain,
         mesh_ms_steady=ms, unsharded_ms_steady=plain_ms,
         live_bytes_before=before, peak_bytes_first_step=peak,
         launches=launches,
         predicted={"flops": pred["flops"], "bytes": pred["bytes"],
                    "argument_bytes": pred["argument_bytes"],
                    "peak_bytes": pred["peak_bytes"],
                    "trace_s": pred["trace_s"]},
         peak_ratio=pred["peak_bytes"] / peak,
         achieved_tflops=pred["flops"] / (ms * 1e-3) / 1e12,
         share_of_bf16_tensor_peak=pred["flops"] / (ms * 1e-3)
         / PEAK_FLOPS_BF16,
         share_of_f32_peak=pred["flops"] / (ms * 1e-3) / PEAK_FLOPS_F32)
    del params, batches, stream
    torch.cuda.empty_cache()
    return launches


def vqi_loop_phase(k, dev):
    """The paper's loop on the card at ``vqi_config()``: train the VQI
    model (asset accuracy > 0.9), publish v1's three variants, roll v1 out
    to one standard and one Pi-4-class device behind a gate on VQI task
    accuracy (``evaluate`` on labelled batches), run inspections that push
    telemetry, publish a noised v2 whose rollout must fail and roll back,
    retrain from the telemetry, and roll the result out as v3 (the gate
    must pass). Returns the launch totals of the whole loop."""
    import tempfile

    from repro_torch.api import ArtifactRegistry, HealthGate, RolloutPolicy
    from repro_torch.data import vqi_batch, vqi_eval_accuracy
    from repro_torch.fleet import vqi
    from repro_torch.models import forward
    from repro_torch.serving import RequestQueue
    from repro_torch.tree import map_with_path

    cfg = vqi.vqi_config()
    times = {}
    reset_counters(k)                        # ---- the loop: counted
    t0 = time.perf_counter()
    params, history = vqi.train_vqi_model(
        cfg, steps=VQI_TRAIN_STEPS, batch=VQI_TRAIN_BATCH,
        log_fn=lambda line: None, device=dev)
    torch.cuda.synchronize()
    times["train_s"] = time.perf_counter() - t0
    trained = vqi.evaluate(params, cfg, device=dev)
    if not trained["asset_acc"] > 0.9:
        raise AssertionError(f"vqi loop: the VQI model did not learn: "
                             f"{trained}")
    noise = torch.Generator(device=dev).manual_seed(SEED + 50)
    v2 = map_with_path(lambda _, t: t + 0.8 * torch.randn(
        t.shape, generator=noise, device=dev, dtype=t.dtype), params)
    # field captures under heavier noise than training saw: the
    # low-confidence or wrong ones go to the hub's retrain buffer
    field = vqi.VQITask(noise=VQI_FIELD_NOISE)
    gen = torch.Generator().manual_seed(SEED + 51)
    captures = []
    for i in range(VQI_LOOP_CAPTURES):
        raw = vqi_batch(gen, cfg, field, 1, dev)
        raw["asset_ids"] = [f"field-{i}"]
        captures.append(raw)

    def validate(agent):
        """The gate's metric: VQI task accuracy of the agent's active
        session on evaluate's labelled batches (no latency: at this width
        a forward is host-bound, a few ms that vary by half between
        calls)."""
        if agent.session is None:
            return {}
        return {"accuracy": vqi.evaluate(agent.session.params, cfg, 2,
                                         device=dev)["accuracy"]}

    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    policy = RolloutPolicy(gate=HealthGate())
    reports = {}
    with tempfile.TemporaryDirectory(dir=build) as root:
        registry = ArtifactRegistry(root)
        fleet = vqi.make_fleet(registry, 1, 1, device=dev)

        def release(version, weights):
            t0 = time.perf_counter()
            vqi.publish_variants(registry, "vqi", version, weights, cfg,
                                 device=dev)
            times[f"publish_{version}_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            reports[version] = fleet.staged_rollout("vqi", version, validate,
                                                    policy)
            times[f"rollout_{version}_s"] = time.perf_counter() - t0
            return {d: a.active.key for d, a in fleet.devices.items()}

        active_v1 = release("v1", params)
        if not reports["v1"].succeeded or "int8" not in active_v1[
                "edge-pi4-0"]:
            raise AssertionError(f"vqi loop v1: {reports['v1'].reason} "
                                 f"{active_v1}")
        for agent in fleet.devices.values():
            queue = RequestQueue(
                vqi.inspection_pipeline(agent, cfg, fleet.telemetry),
                max_batch=8, stack=_stack_captures,
                unstack=lambda res, n: [[p] for p in res])
            for c in captures:
                queue.submit(c)
            queue.drain()
        hub = fleet.telemetry
        if hub.total_records != len(captures) * len(fleet.devices):
            raise AssertionError(f"vqi loop telemetry: {hub.summary()}")
        active_v2 = release("v2", v2)
        if reports["v2"].succeeded or any(":v1:" not in key
                                          for key in active_v2.values()):
            raise AssertionError(f"vqi loop: v2 must fail and roll back: "
                                 f"{reports['v2'].reason} {active_v2}")
        t0 = time.perf_counter()
        v3, info = vqi.retrain_from_telemetry(hub, params, cfg,
                                              steps=VQI_RETRAIN_STEPS,
                                              log_fn=lambda line: None,
                                              device=dev)
        torch.cuda.synchronize()
        times["retrain_s"] = time.perf_counter() - t0
        retrained = vqi.evaluate(v3, cfg, device=dev)
        probe = vqi_batch(gen, cfg, field, 64, dev)
        with torch.no_grad():
            field_acc = {name: vqi_eval_accuracy(
                forward(p, probe, cfg)[0], probe, cfg)
                for name, p in (("v1", params), ("v3", v3))}
        active_v3 = release("v3", v3)
        if not reports["v3"].succeeded or any(":v3:" not in key
                                              for key in active_v3.values()):
            raise AssertionError(f"vqi loop v3: {reports['v3'].reason} "
                                 f"{active_v3}")
        torch.cuda.synchronize()
        launches = read_counters(k)          # ---- read right after
        launches.update(check_bodies(k, "vqi loop", launches,
                                     torch.float32))
        for name in ("flash_prefill", "qmatmul_dynamic", "qmatmul_static"):
            if launches[name] <= 0:
                raise AssertionError(f"vqi loop: {name} never launched")
        emit("vqi_loop", model=cfg.name, d_model=cfg.d_model,
             layers=cfg.n_layers, dtype=cfg.dtype,
             train_steps=VQI_TRAIN_STEPS, batch=VQI_TRAIN_BATCH,
             train_ms_per_step=times["train_s"] * 1e3 / VQI_TRAIN_STEPS,
             loss_first_last=[history[0]["loss"], history[-1]["loss"]],
             trained=trained, retrained=retrained,
             field_asset_cond_acc=field_acc,
             replayed_samples=info["replayed_samples"],
             retrain_final_loss=info["final_loss"],
             retrain_ms_per_step=times["retrain_s"] * 1e3
             / VQI_RETRAIN_STEPS,
             canary_metrics={v: {str(d): m for d, m in
                                 (r.canary_metrics or {}).items()}
                             for v, r in reports.items()},
             v2_reason=reports["v2"].reason[:200],
             active={"v1": active_v1, "v2": active_v2, "v3": active_v3},
             telemetry=hub.summary(), latencies_s=times, launches=launches)
        del fleet
    del params, v2, v3
    torch.cuda.empty_cache()
    return launches


def _noised(t, gen):
    """A float leaf plus N(0, 1) noise (the JAX system test's bad release)."""
    if not t.is_floating_point():
        return t
    return t + torch.randn(t.shape, generator=gen, device=t.device,
                           dtype=t.dtype)


# ------------------------------------------------------------------ #
# Phase 9: the chunked prefill and opt_attn_accum at full width
# ------------------------------------------------------------------ #
def _counted(k, dtype, where, fn):
    """``fn()`` with every launch counter zeroed just before and read just
    after; each flash launch must take its dtype's body."""
    reset_counters(k)                        # ---- this path: counted
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_counters(k)              # ---- read right after
    launches.update(check_bodies(k, where, launches, dtype))
    return out, ms, launches


def chunked_phase(k, dev):
    """stablelm-1.6b at full width and depth in bf16: a 255- and a
    600-token prompt (one and two query chunks of 512) prefilled through
    the flash kernels and through the chunked core (``opt_flash_prefill=
    False``, plain PyTorch, no attention kernel), and through the chunked
    core with ``opt_attn_accum=True``, over the fp, int8 and int4 tiers, on
    the same weights. Last-position logits beside the card's one-rounding
    nudge of the flash path: chunked against flash over the fp tier, and
    accum against plain chunked, held to 2.5x it; over a quantized tier the
    flash path attends over the codes and the chunked one over the fp K/V,
    as in the JAX package, so their difference (the tier's quantization
    error) is reported and the chunked logits must equal the fp tier's.
    The int8 / int4 caches' codes of layer 0 (the same K/V on both paths)
    equal over the prompt; later layers' inputs differ by that error, so
    the share of their codes that differ is reported; the chunked pad
    rows' scales (int8: the floor scale). Returns the launch totals."""
    from repro_torch import configs
    from repro_torch.models import init_params, prefill

    cfg = configs.get_config("stablelm-1.6b")
    params = init_params(cfg, seed=SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    prompts = {s: torch.randint(0, cfg.vocab_size, (1, s), generator=gen,
                                device=dev) for s in CHUNK_PROMPTS}
    dtype = getattr(torch, cfg.dtype)
    prefill_k = {"fp": "flash_prefill", "int8": "flash_qprefill",
                 "int4": "flash_q4prefill"}
    attention = ("flash_prefill", "flash_qprefill", "flash_q4prefill")
    with torch.no_grad():                    # warm-up, uncounted
        for flash in (True, False):
            prefill(params, {"tokens": prompts[CHUNK_PROMPTS[0]]},
                    cfg.with_overrides(opt_flash_prefill=flash), pad_to=264)
    torch.cuda.synchronize()
    totals, chunked_fp = {}, {}
    for tier in ("fp", "int8", "int4"):
        paths = {"flash": dict(opt_flash_prefill=True),
                 "chunked": dict(opt_flash_prefill=False),
                 "chunked_accum": dict(opt_flash_prefill=False,
                                       opt_attn_accum=True)}
        for s, tokens in prompts.items():
            out, row = {}, {}
            for path, over in paths.items():
                vcfg = cfg.with_overrides(kv_cache_precision=tier, **over)
                with torch.no_grad():
                    (last, cache), ms, launches = _counted(
                        k, dtype, f"chunked/{tier}/{path}/{s}",
                        lambda vcfg=vcfg: prefill(params, {"tokens": tokens},
                                                  vcfg, pad_to=s + 8))
                want = {n: (cfg.n_layers if path == "flash"
                            and n == prefill_k[tier] else 0)
                        for n in attention}
                if {n: launches[n] for n in attention} != want:
                    raise AssertionError(f"chunked/{tier}/{path}/{s}: "
                                         f"attention launches {launches}")
                if not torch.isfinite(last).all():
                    raise AssertionError(f"chunked/{tier}/{path}/{s}: "
                                         "non-finite logits")
                _merge(totals, launches)
                out[path] = (last.float(), cache)
                row[f"{path}_ms"] = ms
            vcfg = cfg.with_overrides(kv_cache_precision=tier)
            with torch.no_grad(), nudged_norms():
                nudged, _ = prefill(params, {"tokens": tokens}, vcfg,
                                    pad_to=s + 8)
            nudge_max, nudge_mean = logit_diff([nudged], [out["flash"][0]])
            ok = True
            for name, (a, b) in (("chunked_vs_flash", ("chunked", "flash")),
                                 ("accum_vs_chunked", ("chunked_accum",
                                                       "chunked"))):
                dmax, dmean = logit_diff([out[a][0]], [out[b][0]])
                row[name] = {"max_abs_dlogit": dmax, "mean_abs_dlogit": dmean}
                # a quantized tier's flash prefill attends over the codes,
                # the chunked one over the fp K/V (the JAX package's two
                # paths): their difference is the tier's quantization error
                if tier == "fp" or name == "accum_vs_chunked":
                    ok &= dmax <= 2.5 * nudge_max and dmean <= 2.5 * nudge_mean
            if tier == "fp":
                chunked_fp[s] = out["chunked"][0]
            else:
                # the chunked logits do not depend on the tier: it changes
                # only what the cache stores
                row["chunked_equals_fp_tier"] = torch.equal(
                    out["chunked"][0], chunked_fp[s])
                ok &= row["chunked_equals_fp_tier"]
            if tier != "fp":
                flash_c, chunk_c = out["flash"][1], out["chunked"][1]
                first = [torch.equal(f[:, :s], c[:, :s]) for f, c in
                         zip(flash_c["layers"][0], chunk_c["layers"][0])]
                later = [float((f[:, :s] != c[:, :s]).float().mean())
                         for lf, lc in zip(flash_c["layers"][1:],
                                           chunk_c["layers"][1:])
                         for f, c in zip(lf[::2], lc[::2])]
                # pads: zeros after quantizing (flash), the quantized zero
                # rows (chunked: int8's floor scale)
                pads = chunk_c["layers"][0][1][:, s:]
                row.update(layer0_codes_equal=all(first),
                           later_layers_codes_differ_share=max(later),
                           chunked_pad_scale=float(pads.float().max()),
                           flash_pad_scale=float(
                               flash_c["layers"][0][1][:, s:].float().max()))
                ok &= all(first)
            emit("chunked", model=cfg.name, dtype=cfg.dtype,
                 layers=cfg.n_layers, kv_cache=tier, prompt=s,
                 query_chunks=-(-s // 512), nudge_max=nudge_max,
                 nudge_mean=nudge_mean, tol_factor=2.5, **row, ok=ok)
            if not ok:
                raise AssertionError(f"chunked/{tier}/{s}: {row} against "
                                     f"the nudge {nudge_max} / {nudge_mean}")
            del out, nudged
    del params
    torch.cuda.empty_cache()
    return totals


# ------------------------------------------------------------------ #
# Phase 10: phi3-mini and deepseek-7b at published width and depth
# ------------------------------------------------------------------ #
def dense_configs_phase(k, dev):
    """phi3-mini-3.8b and deepseek-7b at their published width and depth,
    bf16, random seeded weights (deepseek-7b also as dynamic int8): a
    128-token prefill, 8 decode steps, then ``InferenceSession.generate``
    of 2 prompts x 16 tokens behind a RequestQueue, each counted; ms per
    prefill and per step, peak memory. The flash prefill's logits are
    held to the chunked core's (plain PyTorch, no attention kernel) on the
    same weights within 2.5x the card's one-rounding nudge. Returns the
    launch totals."""
    from repro_torch import configs
    from repro_torch.api.variants import VariantSpec
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving import InferenceSession, Pipeline, RequestQueue

    totals = {}
    for arch in DENSE_ARCHS:
        cfg = configs.get_config(arch)
        t0 = time.perf_counter()
        params = init_params(cfg, seed=SEED)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        gen = torch.Generator(device=dev).manual_seed(SEED + 31)
        prompt = torch.randint(0, cfg.vocab_size, (1, DENSE_PROMPT),
                               generator=gen, device=dev)
        queue_prompts = [torch.randint(0, cfg.vocab_size, (1, n),
                                       generator=gen, device=dev)
                         for n in DENSE_QUEUE]
        specs = [("bf16", VariantSpec.fp32())]
        if arch == "deepseek-7b":
            specs.append(("dynamic_int8", VariantSpec.dynamic_int8()))
        dtype = getattr(torch, cfg.dtype)
        ref_logits = None
        for label, spec in specs:
            t0 = time.perf_counter()
            qparams, info = spec.build(params, cfg)
            session = InferenceSession(qparams, cfg)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            with torch.no_grad():                    # warm-up, uncounted
                last, cache = prefill(session.params, {"tokens": prompt}, cfg,
                                      pad_to=256)
                decode_step(session.params, cache,
                            torch.argmax(last[:, -1], -1).reshape(1, 1),
                            DENSE_PROMPT, cfg)
                del cache
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)

            def run():
                with torch.no_grad():
                    t0 = time.perf_counter()
                    last, cache = prefill(session.params, {"tokens": prompt},
                                          cfg, pad_to=256)
                    torch.cuda.synchronize()
                    pre_ms = (time.perf_counter() - t0) * 1e3
                    first = last
                    toks = []
                    t0 = time.perf_counter()
                    for i in range(DENSE_STEPS):
                        nxt = torch.argmax(last[:, -1], -1).reshape(1, 1)
                        toks.append(nxt)
                        last, cache = decode_step(session.params, cache, nxt,
                                                  DENSE_PROMPT + i, cfg)
                    torch.cuda.synchronize()
                    step_ms = (time.perf_counter() - t0) * 1e3 / DENSE_STEPS
                return first, last, torch.cat(toks, 1), pre_ms, step_ms

            (first, last, toks, pre_ms, step_ms), _, launches = _counted(
                k, dtype, f"{arch}/{label}", run)
            pipe = Pipeline(preprocess=lambda raw: raw,
                            infer=lambda b: session.generate(b, 16),
                            postprocess=lambda out, raw: out)
            queue = RequestQueue(pipe, max_batch=1)
            reqs = [queue.submit({"tokens": p}) for p in queue_prompts]
            _, serve_ms, q_launches = _counted(k, dtype, f"{arch}/{label} q",
                                               queue.drain)
            need = ["flash_prefill"] + (["qmatmul_dynamic"]
                                        if label == "dynamic_int8" else [])
            for name in need:
                if launches[name] <= 0 or q_launches[name] <= 0:
                    raise AssertionError(f"{arch}/{label}: {name} never "
                                         f"launched ({launches})")
            if launches["flash_prefill"] != cfg.n_layers:
                raise AssertionError(f"{arch}/{label}: flash_prefill "
                                     f"launched {launches['flash_prefill']}"
                                     f" times in one prefill")
            for r in reqs:
                if not r.done or r.result.shape != (1, 16) or int(
                        r.result.min()) < 0 or int(
                        r.result.max()) >= cfg.vocab_size:
                    raise AssertionError(f"{arch}/{label}: bad result")
            if not (torch.isfinite(first).all() and torch.isfinite(last).all()):
                raise AssertionError(f"{arch}/{label}: non-finite logits")
            # the flash prefill against the chunked core on the same weights
            with torch.no_grad():
                chunked, _ = prefill(session.params, {"tokens": prompt},
                                     cfg.with_overrides(
                                         opt_flash_prefill=False), pad_to=256)
                with nudged_norms():
                    nudged, _ = prefill(session.params, {"tokens": prompt},
                                        cfg, pad_to=256)
            dmax, dmean = logit_diff([chunked], [first])
            nudge_max, nudge_mean = logit_diff([nudged], [first])
            if dmax > 2.5 * nudge_max or dmean > 2.5 * nudge_mean:
                raise AssertionError(
                    f"{arch}/{label}: flash vs chunked logits {dmax} / "
                    f"{dmean} above 2.5x the nudge {nudge_max} / {nudge_mean}")
            extra = {"flash_vs_chunked": {"max_abs_dlogit": dmax,
                                          "mean_abs_dlogit": dmean,
                                          "nudge_max": nudge_max,
                                          "nudge_mean": nudge_mean,
                                          "tol_factor": 2.5}}
            if ref_logits is None:
                ref_logits = first.float()
            else:
                extra["prefill_logit_delta_vs_bf16"] = dict(zip(
                    ("max", "mean"), logit_diff([first], [ref_logits])))
            _merge(totals, launches)
            _merge(totals, q_launches)
            emit("dense_configs", model=cfg.name, variant=label,
                 dtype=cfg.dtype, layers=cfg.n_layers, d_model=cfg.d_model,
                 heads=cfg.n_heads, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
                 init_s=init_s, build_s=build_s,
                 quantized_leaves=len(info["quantized_paths"]),
                 prefill_tokens=DENSE_PROMPT, prefill_ms=pre_ms,
                 decode_steps=DENSE_STEPS, decode_step_ms=step_ms,
                 greedy_tokens=toks[0].tolist(),
                 queue_requests=len(reqs), queue_tokens_each=16,
                 queue_serve_ms=serve_ms,
                 queue_tokens_per_s=len(reqs) * 16 / serve_ms * 1e3,
                 launches=launches, queue_launches=q_launches,
                 peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                 **extra)
            del session, qparams, pipe, queue, reqs
            torch.cuda.empty_cache()
        del params, ref_logits
        torch.cuda.empty_cache()
    return totals


# ------------------------------------------------------------------ #
# Phase 11: the quantization modes at full width
# ------------------------------------------------------------------ #
def _tensor_kwargs(qc):
    """``quantize_tree``'s arguments to ``quantize_tensor`` for ``qc``."""
    return dict(per_channel=qc.granularity != "per_tensor",
                symmetric=qc.symmetric, bits=qc.bits,
                group_size=qc.group_size if qc.granularity == "per_group"
                else 0, clip_percentile=qc.clip_percentile)


def quant_modes_phase(k, dev):
    """stablelm-1.6b at full width and depth, bf16: ``quantize_tree`` on the
    card for ``VariantSpec.int4()``, per-group int8 (g 128), int8 clipped
    at the 99.9th percentile and asymmetric per-channel int8. For each:
    codes and scales (and zero points) of layers/0 wq and wi, the embedding
    and the unembedding (205 M elements: the percentile's sort) bit for bit
    against the CPU's, ``tree_size_bytes``, the teacher-forced logit delta
    against bf16 on one 128-token prompt, and ms per 8-slot decode step
    beside dynamic int8's, each decode window counted. Returns the launch
    totals."""
    from repro_torch import configs
    from repro_torch.api.variants import VariantSpec
    from repro_torch.core.quant import (QuantConfig, quantize_tensor,
                                        quantize_tree, tree_size_bytes)
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving import InferenceSession
    from repro_torch.tree import get_path

    cfg = configs.get_config("stablelm-1.6b")
    params = init_params(cfg, seed=SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 32)
    prompt = torch.randint(0, cfg.vocab_size, (1, 128), generator=gen,
                           device=dev)
    batch8 = torch.randint(0, cfg.vocab_size, (8, 64), generator=gen,
                           device=dev)
    dtype = getattr(torch, cfg.dtype)
    with torch.no_grad():
        ref = InferenceSession(params, cfg).logits({"tokens": prompt})
    bf16_bytes = tree_size_bytes(params)
    modes = (("int4_g64", VariantSpec.int4().recipe.to_quant_config()),
             ("int8_g128", VariantSpec.dynamic_int8(
                 granularity="per_group",
                 group_size=128).recipe.to_quant_config()),
             ("int8_pct99.9", VariantSpec.dynamic_int8(
                 clip_percentile=99.9).recipe.to_quant_config()),
             ("int8_asym", QuantConfig(symmetric=False, min_size=1024)),
             ("dynamic_int8", VariantSpec.dynamic_int8()
              .recipe.to_quant_config()))
    leaves = ("layers/0/attn/wq", "layers/0/mlp/wi", "embed", "unembed")
    totals = {}
    for label, qc in modes:
        t0 = time.perf_counter()
        with torch.no_grad():
            qparams, paths = quantize_tree(params, qc)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        bits = {}
        for path in leaves if label != "dynamic_int8" else ():
            w = get_path(params, path)
            card = get_path(qparams, path)
            t0 = time.perf_counter()
            cpu = quantize_tensor(w.cpu(), **_tensor_kwargs(qc))
            bits[path] = {"keys": sorted(cpu),
                          "equal": set(cpu) == set(card) and all(
                              torch.equal(card[key].cpu(), cpu[key])
                              for key in cpu),
                          "numel": w.numel(),
                          "cpu_s": time.perf_counter() - t0}
        session = InferenceSession(qparams, cfg)
        with torch.no_grad():
            logits = session.logits({"tokens": prompt})
            _, cache = prefill(session.params, {"tokens": batch8}, cfg,
                               pad_to=128)
            nxt = batch8[:, -1:]
            decode_step(session.params, cache, nxt, 64, cfg)  # warm-up

            def window():
                last = None
                for i in range(8):
                    last, _ = decode_step(session.params, cache, nxt,
                                          65 + i, cfg)
                return last

            last, window_ms, launches = _counted(k, dtype,
                                                 f"quant/{label}", window)
            dtrace = profile_steps(
                lambda: decode_step(session.params, cache, nxt, 73, cfg), 2,
                window_ms / 8)
        gemm = launches["qmatmul_dynamic"]
        weight_only = label not in ("int8_pct99.9", "dynamic_int8")
        if (gemm == 0) != weight_only:
            raise AssertionError(f"quant/{label}: {gemm} int8 GEMM launches "
                                 "in the decode window")
        _merge(totals, launches)
        ok = all(b["equal"] for b in bits.values()) and bool(
            torch.isfinite(logits).all() and torch.isfinite(last).all())
        dmax, dmean = logit_diff([logits], [ref])
        emit("quant_modes", model=cfg.name, variant=label,
             recipe={f: getattr(qc, f) for f in (
                 "granularity", "group_size", "bits", "clip_percentile",
                 "symmetric", "min_size")},
             quantized_leaves=len(paths), build_s=build_s,
             card_vs_cpu_bits=bits, tree_size_bytes=tree_size_bytes(qparams),
             bf16_bytes=bf16_bytes,
             size_ratio=tree_size_bytes(qparams) / bf16_bytes,
             logit_delta_vs_bf16={"max": dmax, "mean": dmean},
             decode_step_ms_8_slots=window_ms / 8,
             decode_window_launches=launches, decode_trace=dtrace, ok=ok)
        if not ok:
            raise AssertionError(f"quant/{label}: card vs CPU {bits}")
        del qparams, session, cache
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return totals


# ------------------------------------------------------------------ #
# Phase 12: speculative decoding at full width
# ------------------------------------------------------------------ #
def _bf16_ulp(x: float) -> float:
    """One bf16 ulp at ``x`` (the logits are bf16 products upcast to f32),
    reported beside the nudge."""
    return torch.finfo(torch.bfloat16).eps * 2.0 ** math.floor(
        math.log2(abs(x)))


def _partings(params, cfg, trace, base, got, dev, memo, frontends=None,
              floor=0.0):
    """For each request whose spec stream parts from the non-spec one: the
    spec stream teacher-forced through the target's own dense decode path
    (the same prefix as the non-spec stream up to the parting), plainly and
    with every normalized activation nudged by one rounding
    (``nudged_norms``, the same forced tokens). A step's nudge is the
    largest change of its logits. At the parting step the non-spec
    stream's token, and at every step the spec stream's token, must lie
    within that step's nudge of the top logit: a tie up to one rounding.
    ``memo`` keeps the teacher-forced runs of each (request, spec stream):
    the drafts' streams are the same target's. ``frontends``: each
    request's conditioning embeds, put in front of its prompt. (The
    router phase holds the router's streams to the single engine's the
    same way.) ``floor``: the least nudge a step is given (the fleet phase's
    static-int8 class, whose activation codes a norm's nudge rarely moves:
    the dynamic-int8 forward's nudge, where one rounding moves every code
    of a row)."""
    out = []
    for rid, (b, g) in enumerate(zip(base, got)):
        if b == g:
            continue
        step = next(j for j, (x, y) in enumerate(zip(b, g)) if x != y)
        if (rid, tuple(g)) not in memo:
            tokens = trace.requests[rid].tokens
            forced = [torch.tensor([[t]]) for t in g[:-1]]
            fe = None if frontends is None else frontends[rid]
            plain, _ = teacher_forced(params, cfg, tokens, dev, False, forced,
                                      len(g) - 1, frontend=fe)
            with nudged_norms():
                nudged, _ = teacher_forced(params, cfg, tokens, dev, False,
                                           forced, len(g) - 1, frontend=fe)
            memo[rid, tuple(g)] = (
                [p[0, -1] for p in plain],
                [max(float((n - p).abs().max()), floor)
                 for n, p in zip(nudged, plain)])
        steps, nudge = memo[rid, tuple(g)]
        # each step's spec token below the top, over that step's nudge (a
        # step whose nudge is 0, as a static-int8 step where no code sits at
        # a rounding boundary, admits the top token only)
        below = [float(x.max() - x[t]) / n if n else
                 (0.0 if x[t] == x.max() else math.inf)
                 for x, t, n in zip(steps, g, nudge)]
        logits = steps[step]
        top = torch.topk(logits, 2).values
        base_below = float(top[0] - logits[b[step]])
        out.append({"request": rid, "step": step, "tokens": [b[step],
                                                            g[step]],
                    "top1_top2_margin": float(top[0] - top[1]),
                    "ulp": _bf16_ulp(float(top[0])), "nudge": nudge[step],
                    "gap": float(logits[b[step]] - logits[g[step]]),
                    "base_below_top": base_below,
                    "spec_below_top": below[step] * nudge[step],
                    "spec_worst_below_top_over_nudge": max(below),
                    "ok": base_below <= nudge[step] and max(below) <= 1})
    return out


def spec_phase(k, dev):
    """stablelm-1.6b at full width and SPEC_LAYERS layers in bf16 as the
    target, its
    dynamic-int8 and int4 variants published with ``draft_of="fp32"`` into
    an ArtifactRegistry in a temporary directory (v1 and v2) and resolved
    through ``Deployment.spec_config(k=3)``. The engine trace's 16 greedy
    requests served by the paged engine (the 65-block pool: it preempts)
    and the dense one, non-spec and with each draft, each replay counted;
    every spec stream held to the same engine's non-spec stream (where two
    part: both tokens within one rounding's nudge of the top there, and
    every token of the spec stream the target's greedy choice up to that
    nudge on its own prefix); after the paged
    int8-draft replay, 8 slots decoding: a spec step's ms and profile. Then
    one sampled request (temperature 0.8) alone and inside the trace.
    Returns the launch totals."""
    import tempfile

    from repro_torch import configs
    from repro_torch.api import (ArtifactRegistry, Deployment, ModelArtifact,
                                 VariantSpec)
    from repro_torch.models import init_params
    from repro_torch.serving import (ArrivalTrace, ContinuousBatchingEngine,
                                     InferenceSession, SamplingParams,
                                     replay)
    from repro_torch.serving.loadgen import TracedRequest

    cfg = configs.get_config("stablelm-1.6b").with_overrides(
        n_layers=SPEC_LAYERS)
    params = init_params(cfg, seed=SEED)
    trace = engine_trace(cfg)
    session = InferenceSession(params, cfg)
    dtype = getattr(torch, cfg.dtype)
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    totals = {}
    with tempfile.TemporaryDirectory(dir=build) as root:
        dep = Deployment(ArtifactRegistry(root), "stablelm")
        drafts = {}
        for version, spec in (("v1", VariantSpec.dynamic_int8(
                draft_of="fp32")), ("v2", VariantSpec.int4(draft_of="fp32"))):
            t0 = time.perf_counter()
            dep.publish(ModelArtifact.create("stablelm", version, params, cfg),
                        [spec])
            publish_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            drafts[spec.variant] = dep.spec_config(version, k=SPEC_K)
            torch.cuda.synchronize()
            emit("spec_publish", version=version, variant=spec.variant,
                 draft_of=spec.draft_of, publish_s=publish_s,
                 resolve_s=time.perf_counter() - t0,
                 draft_bytes=drafts[spec.variant].draft.size_bytes)
    sampled = TracedRequest(trace.requests[3].arrival_step,
                            trace.requests[3].tokens, N_NEW,
                            SamplingParams(temperature=0.8, seed=SEED + 33))
    with_sampled = ArrivalTrace(trace.requests[:4] + (sampled,)
                                + trace.requests[4:], trace.seed,
                                trace.mean_interarrival)
    streams, failures, memo = {}, [], {}
    runs = [("none", mode) for mode in ("paged", "dense")] + [
        (draft, mode) for draft in drafts for mode in ("paged", "dense")]
    for draft, mode in runs:
        kw = dict(ENGINE, **(PAGED if mode == "paged" else {}))
        if draft != "none":
            kw["spec"] = drafts[draft]
        engine = ContinuousBatchingEngine(session, **kw)
        engine.warmup(prompt_len=64, max_new_tokens=4)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        report, serve_ms, launches = _counted(
            k, dtype, f"spec/{draft}/{mode}", lambda: replay(engine, trace))
        reqs = engine.all_requests
        for r in reqs:
            if not r.done or len(r.out_tokens) != N_NEW:
                raise AssertionError(f"spec/{draft}/{mode}: request {r.rid} "
                                     f"ended {r.status}")
        streams[draft, mode] = [r.out_tokens for r in reqs]
        need = ["flash_prefill"] + (["paged_decode"] if (
            draft == "none" and mode == "paged") else []) + (
            ["qmatmul_dynamic"] if draft == "dynamic_int8" else [])
        for name in need:
            if launches[name] <= 0:
                raise AssertionError(f"spec/{draft}/{mode}: {name} never "
                                     f"launched ({launches})")
        if draft != "none" and launches["paged_decode"]:
            raise AssertionError(f"spec/{draft}/{mode}: the target decoded "
                                 "through paged_decode, not verify")
        if mode == "paged" and report["preempted"] < 1:
            raise AssertionError(f"spec/{draft}/{mode}: no preemption")
        extra = {}
        if draft == "dynamic_int8" and mode == "paged":
            # 8 slots decoding: a spec step's host ms and device profile
            gen = torch.Generator().manual_seed(SEED + 34)
            for _ in range(engine.n_slots):
                engine.submit(torch.randint(0, cfg.vocab_size, (1, 60),
                                            generator=gen), max_new_tokens=40)
            while not all(r is not None and r.status == "decode"
                          for r in engine.active):
                engine.step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(2):
                engine.step()
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3 / 2
            extra_trace = {"spec_step_ms_8_slots": step_ms,
                           "spec_step_trace": profile_steps(engine.step, 2,
                                                            step_ms)}
            engine.run()
        else:
            extra_trace = {}
        if draft != "none":
            partings = _partings(params, cfg, trace, streams["none", mode],
                                 streams[draft, mode], dev, memo)
            failures += [p for p in partings if not p["ok"]]
            extra = {"streams_equal_to_non_spec": sum(
                a == b for a, b in zip(streams["none", mode],
                                       streams[draft, mode])),
                     "partings": partings}
        _merge(totals, launches)
        tokens = report["generated_tokens"]
        emit("spec", model=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers,
             draft=draft, mode=mode, k=SPEC_K if draft != "none" else 0,
             requests=report["completed"], generated_tokens=tokens,
             decode_steps=report["decode_steps"], serve_ms=serve_ms,
             tokens_per_s=tokens / serve_ms * 1e3,
             p50_ttft_s=report["p50_ttft_s"], p99_ttft_s=report["p99_ttft_s"],
             **{key: report[key] for key in (
                 "acceptance_rate", "accepted_tokens_per_step", "spec_events",
                 "spec_draft_tokens", "spec_accepted_tokens", "preempted",
                 "prefix_hit_tokens", "kv_blocks_peak")},
             launches=launches,
             peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9, **extra,
             **extra_trace)
        del engine
        torch.cuda.empty_cache()
    # one sampled request: alone, then inside the trace (paged, int8 draft)
    sampled_streams = {}
    for where, tr in (("alone", ArrivalTrace((sampled,), 0, 0.0)),
                      ("in_trace", with_sampled)):
        engine = ContinuousBatchingEngine(
            session, spec=drafts["dynamic_int8"], **ENGINE, **PAGED)
        (_, _, launches) = _counted(k, dtype, f"spec/sampled/{where}",
                                    lambda: replay(engine, tr))
        _merge(totals, launches)
        req = next(r for r in engine.all_requests if not
                   r.sampling.is_greedy)
        sampled_streams[where] = req.out_tokens
        del engine
    same = sampled_streams["alone"] == sampled_streams["in_trace"]
    emit("spec_sampled", temperature=0.8, seed=SEED + 33, draft="dynamic_int8",
         mode="paged", streams=sampled_streams, identical=same,
         differs_from_greedy=sampled_streams["alone"] != streams[
             "none", "paged"][3])
    if failures or not same:
        raise AssertionError(f"spec: partings not at a tie {failures}, "
                             f"sampled streams identical: {same}")
    del session, params, drafts, memo
    torch.cuda.empty_cache()
    return totals


# ------------------------------------------------------------------ #
# Phase 13: MoE and MLA at published width
# ------------------------------------------------------------------ #
@contextlib.contextmanager
def moe_probes(drops=None, routes=None):
    """Records each MoE layer call of the port: ``drops`` gets (assignments
    T * k, ``fraction_dropped`` left on the device until read), ``routes``
    the router's (probs, top-k choices) on the host (a sync a call: only
    for the short routing runs)."""
    from repro_torch.models import moe

    route, ffn = moe.route, moe.moe_ffn

    def rec_route(p, xt, cfg):
        out = route(p, xt, cfg)
        routes.append((out[1].float().cpu(), out[3].cpu()))
        return out

    def rec_ffn(p, x, cfg):
        out, aux = ffn(p, x, cfg)
        drops.append((x.shape[0] * x.shape[1] * cfg.top_k,
                      aux["fraction_dropped"]))
        return out, aux

    try:
        if routes is not None:
            moe.route = rec_route
        if drops is not None:
            moe.moe_ffn = rec_ffn
        yield
    finally:
        moe.route, moe.moe_ffn = route, ffn


def dropped(drops):
    """(assignments dropped, of all, the largest fraction of one call)."""
    n = [round(float(fd) * a) for a, fd in drops]
    return sum(n), sum(a for a, _ in drops), max(
        (float(fd) for _, fd in drops), default=0.0)


def paged_split_forced(params, cfg, tokens, forced, dev,
                       bs=PAGED["block_size"]):
    """Host logits of ``tokens`` [1, n] admitted as the paged engine admits
    a cold prompt (its full-block prefix prefilled into the pools, the rest
    fed one token a decode step), then one decode step per ``forced``
    token: out[0] predicts the first new token, as ``teacher_forced``'s."""
    from repro_torch.models import decode_step_paged, prefill_paged
    from repro_torch.serving.kvcache import init_paged_pools

    n = tokens.shape[1]
    nb = -(-(n + len(forced)) // bs)
    pools = init_paged_pools(cfg, nb + 1, bs, device=dev)
    tables = torch.arange(1, nb + 1, dtype=torch.int32, device=dev)[None]
    chunk = ((n - 1) // bs) * bs or n
    feed = [t.reshape(1, 1) for t in tokens[0, chunk:]] + list(forced)
    out = []
    with torch.no_grad():
        last, _ = prefill_paged(params, pools,
                                {"tokens": tokens[:, :chunk].to(dev)}, chunk,
                                tables, cfg)
        if chunk == n:
            out.append(last.cpu())
        for i, tok in enumerate(feed):
            pos = torch.full((1,), chunk + i, device=dev)
            last, _ = decode_step_paged(params, pools, tok.to(dev), pos,
                                        tables, cfg)
            if chunk + i + 1 >= n:
                out.append(last.cpu())
    return out


def moe_partings(params, cfg, trace, dense, paged, dev):
    """Where a paged stream parts from the dense one: both paths
    teacher-forced with the common prefix (the dense path plainly and with
    ``nudged_norms``; the paged path as the paged engine admits the
    prompt). Capacity is shared by the tokens of one pass, so the paged
    path, whose prompt tail rides decode steps, keeps tail assignments
    that the dense prefill may drop. Where both paths dropped as many
    assignments (a rounding parting), their logits must agree within 2.5x
    the step's nudge and both tokens lie within the nudge of the top;
    where they did not (a capacity parting), each token must lie within
    the nudge of the top of its own path."""
    out = []
    for rid, (a, b) in enumerate(zip(dense, paged)):
        if a == b:
            continue
        step = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
        tokens = trace.requests[rid].tokens
        forced = [torch.tensor([[t]]) for t in a[:step]]
        d_drops, p_drops = [], []
        with moe_probes(drops=d_drops):
            d_plain, _ = teacher_forced(params, cfg, tokens, dev, False,
                                        forced, step)
        with nudged_norms():
            d_nudged, _ = teacher_forced(params, cfg, tokens, dev, False,
                                         forced, step)
        with moe_probes(drops=p_drops):
            p_plain = paged_split_forced(params, cfg, tokens, forced, dev)
        nudge = float((d_nudged[step] - d_plain[step]).abs().max())
        ld, lp = d_plain[step][0, -1], p_plain[step][0, -1]
        paths = float((ld - lp).abs().max())
        extra = dropped(d_drops)[0] - dropped(p_drops)[0]
        below = {"dense_on_dense": float(ld.max() - ld[a[step]]),
                 "paged_on_dense": float(ld.max() - ld[b[step]]),
                 "paged_on_paged": float(lp.max() - lp[b[step]])}
        if extra == 0:
            ok = (paths <= 2.5 * nudge and below["dense_on_dense"] <= nudge
                  and below["paged_on_dense"] <= nudge)
        else:
            ok = (below["dense_on_dense"] <= nudge
                  and below["paged_on_paged"] <= nudge)
        out.append({"request": rid, "step": step, "tokens": [a[step],
                                                            b[step]],
                    "kind": "rounding" if extra == 0 else "capacity",
                    "dense_minus_paged_assignments_dropped": extra,
                    "paths_max_abs_dlogit": paths, "nudge": nudge,
                    "below_top": below, "ok": ok})
    return out


def moe_route_check(params, cfg, dev):
    """deepseek-v2 at full width and depth 2 (its dense layer and one MoE
    layer), the same weights on the card and on the CPU (the port's plain
    path): a 32-token prefill and 4 decode steps fed the CPU's greedy
    tokens, the card's run also with ``nudged_norms``. Top-k choices must
    be equal but where the CPU's k-th and (k+1)-th router probabilities
    are within one rounding's effect on them (the card's nudged probs);
    the logits, at every step whose token routed the same, within 2.5x
    the step's nudge."""
    from repro_torch.models.layers import place_params

    cfg2 = cfg.with_overrides(n_layers=MOE_ROUTE_DEPTH)
    card = {**params, "layers": params["layers"][:MOE_ROUTE_DEPTH
                                                 - cfg.n_dense_layers]}
    t0 = time.perf_counter()
    host = place_params(card, "cpu")
    copy_s = time.perf_counter() - t0
    tokens = torch.randint(0, cfg.vocab_size, (1, MOE_ROUTE_PROMPT),
                           generator=torch.Generator().manual_seed(SEED + 51))
    r_cpu, r_card, r_nudged = [], [], []
    t0 = time.perf_counter()
    with moe_probes(routes=r_cpu):
        cpu, fed = teacher_forced(host, cfg2, tokens, "cpu", False, None,
                                  MOE_ROUTE_STEPS)
    cpu_s = time.perf_counter() - t0
    del host
    with moe_probes(routes=r_card):
        got, _ = teacher_forced(card, cfg2, tokens, dev, False, fed,
                                MOE_ROUTE_STEPS)
    with nudged_norms(), moe_probes(routes=r_nudged):
        nudged, _ = teacher_forced(card, cfg2, tokens, dev, False, fed,
                                   MOE_ROUTE_STEPS)
    k = cfg.top_k
    differ, near, outside, flipped = 0, 0, [], set()
    for step, ((p_cpu, i_cpu), (p_card, i_card), (p_n, _)) in enumerate(
            zip(r_cpu, r_card, r_nudged)):
        srt = torch.sort(p_cpu, dim=-1, descending=True).values
        gap = srt[:, k - 1] - srt[:, k]
        rounding = (p_n - p_card).abs().amax(dim=-1)
        near += int((gap <= rounding).sum())
        for t in range(p_cpu.shape[0]):
            if set(i_cpu[t].tolist()) == set(i_card[t].tolist()):
                continue
            differ += 1
            if t == p_cpu.shape[0] - 1:
                flipped.add(step)     # the position whose logits are read
            if gap[t] > rounding[t]:
                outside.append({"call": step, "token": t,
                                "gap": float(gap[t]),
                                "rounding": float(rounding[t])})
    steps = []
    for step, (a, b, n) in enumerate(zip(cpu, got, nudged)):
        steps.append({"max_abs_dlogit": float((a - b).abs().max()),
                      "nudge": float((n - b).abs().max()),
                      "routing_differs": step in flipped})
    bad = [s for s in steps if not s["routing_differs"]
           and s["max_abs_dlogit"] > 2.5 * s["nudge"]]
    emit("moe_routing_card_vs_cpu", model=cfg.name, layers=MOE_ROUTE_DEPTH,
         prompt=MOE_ROUTE_PROMPT, decode_steps=MOE_ROUTE_STEPS,
         host_copy_s=copy_s, cpu_s=cpu_s,
         tokens_routed=sum(p.shape[0] for p, _ in r_cpu),
         top_k_differ=differ, within_one_rounding=near,
         differ_outside_one_rounding=outside, steps=steps, tol_factor=2.5)
    if outside or bad or len(r_cpu) != MOE_ROUTE_STEPS + 1:
        raise AssertionError(f"moe routing card vs CPU: {outside} {bad}")


def moe_trace(cfg):
    """MOE_TRACE_N greedy requests, prompts uniform in MOE_PROMPT tokens,
    MOE_NEW new tokens each, Poisson arrivals TRACE_GAP ticks apart."""
    from repro_torch.serving import ArrivalTrace

    return ArrivalTrace.generate(cfg, MOE_TRACE_N, seed=SEED + 50,
                                 mean_interarrival=TRACE_GAP,
                                 prompt_len=MOE_PROMPT,
                                 max_new=(MOE_NEW, MOE_NEW))


def _flash_class(k, cfg) -> str:
    """The flash_tc width class of ``cfg``'s prefill (MLA: hd = qk_nope +
    qk_rope beside dv = v_head_dim)."""
    if cfg.attention == "mla":
        return k.flash_prefill.width_class(cfg.qk_nope_dim + cfg.qk_rope_dim,
                                           cfg.v_head_dim)
    hd = cfg.resolved_head_dim
    return k.flash_prefill.width_class(hd, hd)


def moe_serve(k, session, cfg, label, dev, spec=None, profile=False):
    """The batch-1 queue (``generate``, MOE_NEW tokens after each of
    DENSE_QUEUE's prompts), then the trace replayed by the dense and the
    paged engine (``spec``: one dense spec replay instead), each counted;
    every flash launch of the MLA model must take the 192 / 128 class.
    Returns (launches, streams by mode)."""
    from repro_torch.serving import (ContinuousBatchingEngine, Pipeline,
                                     RequestQueue, replay)

    dtype = getattr(torch, cfg.dtype)
    trace = moe_trace(cfg)
    cls = _flash_class(k, cfg)
    totals, streams = {}, {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 52)
    runs = ([("spec", spec)] if spec is not None
            else [("queue", None), ("dense", None), ("paged", None)])
    for mode, sp in runs:
        drops = []
        torch.cuda.reset_peak_memory_stats(dev)
        extra = {}
        if mode == "queue":
            prompts = [torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                                     device=dev) for n in DENSE_QUEUE]
            pipe = Pipeline(preprocess=lambda raw: raw,
                            infer=lambda b: session.generate(b, MOE_NEW),
                            postprocess=lambda out, raw: out)
            queue = RequestQueue(pipe, max_batch=1)
            reqs = [queue.submit({"tokens": p}) for p in prompts]
            with moe_probes(drops=drops):
                _, serve_ms, launches = _counted(
                    k, dtype, f"{label}/queue", queue.drain)
            for r in reqs:
                if not r.done or r.result.shape != (1, MOE_NEW) or int(
                        r.result.min()) < 0 or int(
                        r.result.max()) >= cfg.vocab_size:
                    raise AssertionError(f"{label}/queue: bad result")
            prefills = len(reqs)
            tokens = len(reqs) * MOE_NEW
            extra = {"queue_tokens_per_s": tokens / serve_ms * 1e3,
                     "host_ms_per_token": serve_ms / tokens}
        else:
            kw = dict(ENGINE, **(PAGED if mode == "paged" else {}))
            engine = ContinuousBatchingEngine(session, spec=sp, **kw)
            engine.warmup(prompt_len=64, max_new_tokens=4)
            torch.cuda.synchronize()
            with moe_probes(drops=drops):
                report, serve_ms, launches = _counted(
                    k, dtype, f"{label}/{mode}", lambda: replay(engine,
                                                                trace))
            for r in engine.all_requests:
                if not r.done or len(r.out_tokens) != MOE_NEW or not all(
                        0 <= t < cfg.vocab_size for t in r.out_tokens):
                    raise AssertionError(f"{label}/{mode}: request {r.rid} "
                                         f"ended {r.status}")
            streams[mode] = [r.out_tokens for r in engine.all_requests]
            prefills = None
            tokens = report["generated_tokens"]
            extra = {key: report[key] for key in (
                "p50_ttft_s", "p99_ttft_s", "decode_steps", "preempted",
                "kv_blocks_peak", "acceptance_rate", "spec_events")}
            extra.update(tokens_per_s=tokens / serve_ms * 1e3,
                         host_ms_per_step=serve_ms / report["decode_steps"])
            if profile and mode == "paged":
                watch = ("paged_decode_split" if cfg.attention != "mla"
                         else None)
                per_step, step_ms, dtrace = decode_window(
                    k, engine, cfg, torch.Generator().manual_seed(SEED + 53),
                    watch, cfg.n_layers if watch else None)
                extra.update(decode_step_ms_8_slots=step_ms,
                             launches_per_decode_step=per_step,
                             decode_trace=dtrace)
            del engine
        flash = launches["flash_prefill"]
        by_class = {c: launches[f"flash_prefill.class.{c}"]
                    for c in k.flash_prefill.CLASSES}
        if flash <= 0 or by_class[cls] != flash or flash % cfg.n_layers or (
                prefills is not None and flash != prefills * cfg.n_layers):
            raise AssertionError(f"{label}/{mode}: flash_prefill launches "
                                 f"{flash} by class {by_class}, want class "
                                 f"{cls}, {cfg.n_layers} a prefill")
        need = (["qmatmul_dynamic"] if "int8" in label else []) + (
            ["paged_decode"] if mode == "paged" and cfg.attention != "mla"
            else [])
        for name in need:
            if launches[name] <= 0:
                raise AssertionError(f"{label}/{mode}: {name} never "
                                     f"launched ({launches})")
        if cfg.attention == "mla" and launches["paged_decode"]:
            raise AssertionError(f"{label}/{mode}: MLA decoded through "
                                 "paged_decode")
        n_drop, n_all, worst = dropped(drops)
        emit("moe_mla", model=cfg.name, variant=label, mode=mode,
             layers=cfg.n_layers, d_model=cfg.d_model, experts=cfg.n_experts,
             top_k=cfg.top_k, generated_tokens=tokens, serve_ms=serve_ms,
             fraction_dropped=n_drop / max(n_all, 1),
             fraction_dropped_worst_call=worst, moe_calls=len(drops),
             flash_launches_by_class=by_class, launches=launches,
             peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
             **extra)
        _merge(totals, launches)
        torch.cuda.empty_cache()
    return totals, streams, trace


def moe_mla_phase(k, dev):
    """deepseek-v2-236b (MLA + MoE) at its published width and MOE_DEPTH
    layers in bf16: the queue, the dense and paged engines over
    ``moe_trace`` (an 8-slot paged decode step profiled), paged against
    dense streams (``moe_partings``), flash against chunked prefill logits
    and naive against absorbed decode logits (2.5x each step's nudge); its
    dynamic-int8 artifact built from the same weights drafting for it in a
    dense spec replay (``allow_moe_target``); the routing card vs CPU
    (``moe_route_check``); then, the bf16 weights freed, the int8 variant
    through the queue and both engines. Then kimi-k2-1t-a32b (GQA + MoE) in
    bf16 at MOE_DEPTH layers: the queue, both engines, paged against dense.
    Returns the launch totals."""
    from repro_torch import configs
    from repro_torch.api.variants import VariantSpec
    from repro_torch.core.quant import quantized_size_bytes
    from repro_torch.models import init_params, prefill
    from repro_torch.serving import InferenceSession, SpecConfig
    from repro_torch.tree import leaves_with_path

    totals = {}
    for arch in ("deepseek-v2-236b", "kimi-k2-1t-a32b"):
        cfg = configs.get_config(arch).with_overrides(n_layers=MOE_DEPTH[arch])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = init_params(cfg, seed=SEED)
        torch.cuda.synchronize()
        emit("moe_mla_setup", model=cfg.name, layers=cfg.n_layers,
             published_layers=configs.get_config(arch).n_layers,
             params=cfg.param_count(),
             active_params=cfg.param_count(active_only=True),
             param_gb=sum(t.numel() * t.element_size() for _, t in
                          leaves_with_path(params)) / 1e9,
             init_s=time.perf_counter() - t0,
             init_peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        session = InferenceSession(params, cfg)
        launches, streams, trace = moe_serve(k, session, cfg, "bf16", dev,
                                             profile=True)
        _merge(totals, launches)
        partings = moe_partings(session.params, cfg, trace, streams["dense"],
                                streams["paged"], dev)
        emit("moe_mla_paged_vs_dense", model=cfg.name,
             streams_equal=sum(a == b for a, b in zip(streams["dense"],
                                                      streams["paged"])),
             of=len(trace), partings=partings)
        if not all(p["ok"] for p in partings):
            raise AssertionError(f"{cfg.name}: paged vs dense partings "
                                 f"{partings}")
        # flash against the chunked core; naive against absorbed decode
        gen = torch.Generator(device=dev).manual_seed(SEED + 54)
        prompt = torch.randint(0, cfg.vocab_size, (1, DENSE_PROMPT),
                               generator=gen, device=dev)
        with torch.no_grad():
            flash, _ = prefill(params, {"tokens": prompt}, cfg, pad_to=256)
            chunked, _ = prefill(params, {"tokens": prompt},
                                 cfg.with_overrides(opt_flash_prefill=False),
                                 pad_to=256)
            with nudged_norms():
                nudged, _ = prefill(params, {"tokens": prompt}, cfg,
                                    pad_to=256)
        checks = {"flash_vs_chunked": [{
            "max_abs_dlogit": float((chunked - flash).abs().max()),
            "nudge": float((nudged - flash).abs().max())}]}
        if cfg.attention == "mla":
            naive, fed = teacher_forced(params, cfg, prompt.cpu(), dev, False)
            absorbed, _ = teacher_forced(
                params, cfg.with_overrides(opt_mla_absorb=True), prompt.cpu(),
                dev, False, fed)
            with nudged_norms():
                n_naive, _ = teacher_forced(params, cfg, prompt.cpu(), dev,
                                            False, fed)
            checks["naive_vs_absorbed"] = [
                {"max_abs_dlogit": float((a - b).abs().max()),
                 "nudge": float((n - a).abs().max())}
                for a, b, n in zip(naive, absorbed, n_naive)]
        bad = {name: rows for name, rows in checks.items()
               if any(r["max_abs_dlogit"] > 2.5 * r["nudge"] for r in rows)}
        emit("moe_mla_paths", model=cfg.name, tol_factor=2.5, **checks)
        if bad:
            raise AssertionError(f"{cfg.name}: beyond 2.5x the nudge {bad}")
        if arch == "deepseek-v2-236b":
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            qparams, info = VariantSpec.dynamic_int8().build(params, cfg)
            torch.cuda.synchronize()
            emit("moe_mla_int8_build", model=cfg.name,
                 build_s=time.perf_counter() - t0,
                 quantized_leaves=len(info["quantized_paths"]),
                 size_gb=quantized_size_bytes(qparams) / 1e9,
                 peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
            spec = SpecConfig(draft=(qparams, cfg), k=SPEC_K,
                              allow_moe_target=True)
            launches, s_streams, _ = moe_serve(k, session, cfg,
                                               "bf16_int8_draft", dev,
                                               spec=spec)
            _merge(totals, launches)
            same = sum(a == b for a, b in zip(streams["dense"],
                                               s_streams["spec"]))
            firsts = [next((j for j, (x, y) in enumerate(zip(a, b))
                            if x != y), None)
                      for a, b in zip(streams["dense"], s_streams["spec"])]
            emit("moe_mla_spec_agreement", model=cfg.name,
                 streams_equal_to_non_spec=same, of=len(trace),
                 first_parting_step=firsts)
            moe_route_check(params, cfg, dev)
            del session, params, spec
            torch.cuda.empty_cache()
            session = InferenceSession(qparams, cfg)
            del qparams
            launches, _, _ = moe_serve(k, session, cfg, "dynamic_int8", dev)
            _merge(totals, launches)
        del session
        params = None
        torch.cuda.empty_cache()
    return totals


# ------------------------------------------------------------------ #
# Phase 14: the recurrent models (Mamba2's SSD, the RG-LRU hybrid)
# ------------------------------------------------------------------ #
def rec_trace(cfg):
    """REC_TRACE_N greedy requests, prompts uniform in REC_PROMPT tokens,
    REC_NEW new tokens each, Poisson arrivals TRACE_GAP ticks apart."""
    from repro_torch.serving import ArrivalTrace

    return ArrivalTrace.generate(cfg, REC_TRACE_N, seed=SEED + 60,
                                 mean_interarrival=TRACE_GAP,
                                 prompt_len=REC_PROMPT,
                                 max_new=(REC_NEW, REC_NEW))


@contextlib.contextmanager
def ssd_paths(calls):
    """Counts into ``calls`` the SSD layers that took the chunked and the
    sequential path (the model code calls ``ssm.ssd_chunked`` /
    ``ssm.ssd_sequential`` by module attribute)."""
    from repro_torch.models import ssm

    saved = {name: getattr(ssm, name)
             for name in ("ssd_chunked", "ssd_sequential")}

    def counting(name):
        def call(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return saved[name](*args, **kw)
        return call
    try:
        for name in saved:
            setattr(ssm, name, counting(name))
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(ssm, name, fn)


def ssd_expect(cfg, lengths):
    """The SSD path of each prefill of ``lengths`` tokens, per layer: the
    chunked one where the chunk divides the length, else the sequential
    one (``ssm_prefill``'s rule)."""
    want = {}
    for n in lengths:
        path = ("ssd_chunked" if n % min(cfg.ssm_chunk, n) == 0
                else "ssd_sequential")
        want[path] = want.get(path, 0) + cfg.n_layers
    return want


def _bad_tokens(out, n, cfg) -> bool:
    return (out.shape[-1] != n or int(out.min()) < 0
            or int(out.max()) >= cfg.vocab_size)


def rec_serve(k, session, cfg, label, dev):
    """The batch-1 queue (``generate``, REC_NEW tokens after each of
    DENSE_QUEUE's prompts), then ``rec_trace`` replayed by the dense
    engine (8 slots of REC_ENGINE_LEN tokens, or of the window) and an
    8-slot decode window
    profiled, each counted. No flash prefill runs (mamba2 has no attention,
    the hybrid's window takes the banded chunked core); int8 weights go
    through the GEMMs; an int8-KV decode through qdecode's wide class, one
    launch per attention layer and step. Returns the launch totals."""
    from repro_torch.serving import (ContinuousBatchingEngine, Pipeline,
                                     RequestQueue, replay)

    dtype = getattr(torch, cfg.dtype)
    n_attn = cfg.layer_types().count("attn")
    kv = cfg.kv_precision
    int8 = "int8" in label
    totals = {}
    gen = torch.Generator(device=dev).manual_seed(SEED + 61)
    for mode in ("queue", "dense"):
        torch.cuda.reset_peak_memory_stats(dev)
        ssd = {}
        if mode == "queue":
            prompts = [torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                                     device=dev) for n in DENSE_QUEUE]
            pipe = Pipeline(preprocess=lambda raw: raw,
                            infer=lambda b: session.generate(b, REC_NEW),
                            postprocess=lambda out, raw: out)
            queue = RequestQueue(pipe, max_batch=1)
            reqs = [queue.submit({"tokens": p}) for p in prompts]
            with ssd_paths(ssd):
                _, serve_ms, launches = _counted(
                    k, dtype, f"{cfg.name}/{label}/queue", queue.drain)
            for r in reqs:
                if not r.done or _bad_tokens(r.result, REC_NEW, cfg):
                    raise AssertionError(f"{cfg.name}/{label}/queue: bad "
                                         "result")
            lengths, steps = DENSE_QUEUE, len(reqs) * REC_NEW
            tokens = len(reqs) * REC_NEW
            extra = {"queue_tokens_per_s": tokens / serve_ms * 1e3,
                     "host_ms_per_token": serve_ms / tokens}
        else:
            engine = ContinuousBatchingEngine(
                session, n_slots=ENGINE["n_slots"],
                max_len=max(REC_ENGINE_LEN, cfg.window))
            engine.warmup(prompt_len=64, max_new_tokens=4)
            torch.cuda.synchronize()
            trace = rec_trace(cfg)
            with ssd_paths(ssd):
                report, serve_ms, launches = _counted(
                    k, dtype, f"{cfg.name}/{label}/dense",
                    lambda: replay(engine, trace))
            for r in engine.all_requests:
                if not r.done or len(r.out_tokens) != REC_NEW or not all(
                        0 <= t < cfg.vocab_size for t in r.out_tokens):
                    raise AssertionError(f"{cfg.name}/{label}/dense: request "
                                         f"{r.rid} ended {r.status}")
            lengths = [r.tokens.shape[1] for r in trace.requests]
            steps = report["decode_steps"]
            tokens = report["generated_tokens"]
            extra = {key: report[key] for key in (
                "p50_ttft_s", "p99_ttft_s", "decode_steps")}
            extra.update(tokens_per_s=tokens / serve_ms * 1e3,
                         host_ms_per_step=serve_ms / steps)
            wide = kv == "int8"
            per_step, step_ms, dtrace = decode_window(
                k, engine, cfg, torch.Generator().manual_seed(SEED + 62),
                "qdecode_wide_tc" if wide else None, n_attn if wide else None)
            extra.update(decode_step_ms_8_slots=step_ms,
                         launches_per_decode_step=per_step,
                         decode_trace=dtrace)
            del engine
        if launches["flash_prefill"] or launches["flash_qprefill"] \
                or launches["flash_q4prefill"]:
            raise AssertionError(f"{cfg.name}/{label}/{mode}: a flash "
                                 f"prefill launched ({launches})")
        if int8 and launches["qmatmul_dynamic"] <= 0:
            raise AssertionError(f"{cfg.name}/{label}/{mode}: no int8 GEMM "
                                 f"launched ({launches})")
        if kv == "int8" and (launches["qdecode"] < n_attn
                             or launches["qdecode.class.wide"]
                             != launches["qdecode"]):
            raise AssertionError(f"{cfg.name}/{label}/{mode}: qdecode "
                                 f"launches {launches['qdecode']}, wide "
                                 f"{launches['qdecode.class.wide']}")
        if kv != "int8" and launches["qdecode"]:
            raise AssertionError(f"{cfg.name}/{label}/{mode}: qdecode "
                                 "launched without an int8 KV cache")
        if cfg.arch_type == "ssm" and ssd != ssd_expect(cfg, lengths):
            raise AssertionError(f"{cfg.name}/{label}/{mode}: SSD paths "
                                 f"{ssd}, want {ssd_expect(cfg, lengths)}")
        emit("recurrent", model=cfg.name, variant=label, kv_cache=kv,
             mode=mode, layers=cfg.n_layers, d_model=cfg.d_model,
             generated_tokens=tokens, serve_ms=serve_ms, launches=launches,
             ssd_paths=ssd or None,
             peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
             **extra)
        _merge(totals, launches)
        torch.cuda.empty_cache()
    return totals


def rec_refusals(session, cfg):
    """paged=True and spec= refused, with the JAX package's reasons (the
    recurrent models and musicgen)."""
    from repro_torch.serving import ContinuousBatchingEngine, SpecConfig

    why = {}
    for kw in ({"paged": True},
               {"spec": SpecConfig(draft=(session.params, cfg), k=SPEC_K)}):
        try:
            ContinuousBatchingEngine(session, n_slots=2,
                                     max_len=max(REC_ENGINE_LEN, cfg.window),
                                     **kw)
        except ValueError as e:
            why[next(iter(kw))] = str(e)
        else:
            raise AssertionError(f"{cfg.name}: {kw} was not refused")
    return why


def rec_card_vs_cpu(dev):
    """Each recurrent model at published width and REC_CPU_DEPTH layers in
    f32 (mamba2: 4 SSD layers; recurrentgemma: one (rec, rec, attn) group
    and one tail layer), the same weights on the CPU's plain path and the
    card's kernel path, a REC_CPU_PROMPT-token prompt and 8 teacher-forced
    decode steps: mamba2 with fp32 and dynamic-int8 weights, the hybrid
    over the fp and the int8 KV cache (the card's decode through qdecode's
    wide class). Each held to 2.5x the CPU's own one-rounding nudge, the
    f32 runs too: these models' f32 card readings sit within 1.3x of it."""
    from repro_torch import configs
    from repro_torch.api.variants import VariantSpec
    from repro_torch.models import init_params
    from repro_torch.models.layers import place_params
    from repro_torch.serving import InferenceSession

    runs = {"mamba2-780m": (("fp32", VariantSpec.fp32(), "fp"),
                            ("dynamic_int8", VariantSpec.dynamic_int8(),
                             "fp")),
            "recurrentgemma-9b": (("fp32", VariantSpec.fp32(), "fp"),
                                  ("fp32_int8kv", VariantSpec.fp32(),
                                   "int8"))}
    for arch in REC_ARCHS:
        cfg = configs.get_config(arch).with_overrides(
            n_layers=REC_CPU_DEPTH, dtype="float32")
        tokens = torch.randint(0, cfg.vocab_size, (1, REC_CPU_PROMPT),
                               generator=torch.Generator().manual_seed(
                                   SEED + 63))
        # drawn on the card (fast), copied to the host
        params = place_params(init_params(cfg, seed=SEED + 64), "cpu")
        torch.cuda.empty_cache()
        for label, spec, kv in runs[arch]:
            vcfg = cfg.with_overrides(kv_cache_precision=kv)
            qparams, _ = spec.build(params, vcfg)
            card = InferenceSession(qparams, vcfg)
            cpu_steps, fed = teacher_forced(qparams, vcfg, tokens, "cpu",
                                            False)
            card_steps, _ = teacher_forced(card.params, vcfg, tokens, dev,
                                           False, fed)
            with nudged_norms():
                nudge_steps, _ = teacher_forced(qparams, vcfg, tokens, "cpu",
                                                False, fed)
            worst_max, worst_mean = logit_diff(cpu_steps, card_steps)
            nudge_max, nudge_mean = logit_diff(cpu_steps, nudge_steps)
            tol_max, tol_mean = 2.5 * nudge_max, 2.5 * nudge_mean
            ok = worst_max <= tol_max and worst_mean <= tol_mean
            emit("recurrent_card_vs_cpu", model=cfg.name, variant=label,
                 kv_cache=kv, layers=cfg.n_layers, d_model=cfg.d_model,
                 vocab=cfg.vocab_size, prompt=REC_CPU_PROMPT,
                 decode_steps=8, max_abs_err=worst_max,
                 mean_abs_err=worst_mean, tol_max=tol_max,
                 tol_mean=tol_mean, cpu_nudge_max=nudge_max,
                 cpu_nudge_mean=nudge_mean,
                 logit_scale=float(cpu_steps[0].abs().max()), ok=ok)
            if not ok:
                raise AssertionError(f"{cfg.name} card vs CPU logits differ "
                                     f"by max {worst_max} / mean "
                                     f"{worst_mean} ({label})")
            del card, qparams
            torch.cuda.empty_cache()
        del params


def recurrent_phase(k, dev):
    """mamba2-780m and recurrentgemma-9b at published width and REC_LAYERS
    in bf16, random seeded weights. mamba2: bf16 and its dynamic-int8
    artifact through ``rec_serve``, a REC_SEQ_PROMPT-token ``generate`` on
    the sequential SSD path (every layer); recurrentgemma: bf16 through
    ``rec_serve`` and a REC_RING_PROMPT-token ``generate`` that wraps the
    ring, then (the bf16 weights freed) its dynamic-int8 artifact over the
    fp, int8 and int4 KV caches through ``rec_serve``; both refuse paged
    and speculative engines. Then ``rec_card_vs_cpu``. Returns the launch
    totals."""
    from repro_torch import configs
    from repro_torch.api.variants import VariantSpec
    from repro_torch.core.quant import quantized_size_bytes
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceSession
    from repro_torch.tree import leaves_with_path

    totals = {}
    for arch in REC_ARCHS:
        cfg = configs.get_config(arch).with_overrides(
            n_layers=REC_LAYERS[arch])
        dtype = getattr(torch, cfg.dtype)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        params = init_params(cfg, seed=SEED)
        torch.cuda.synchronize()
        emit("recurrent_setup", model=cfg.name, layers=cfg.n_layers,
             layer_types={t: cfg.layer_types().count(t)
                          for t in sorted(set(cfg.layer_types()))},
             params=cfg.param_count(),
             param_gb=sum(t.numel() * t.element_size() for _, t in
                          leaves_with_path(params)) / 1e9,
             init_s=time.perf_counter() - t0,
             init_peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        session = InferenceSession(params, cfg)
        refused = rec_refusals(session, cfg)
        _merge(totals, rec_serve(k, session, cfg, "bf16", dev))
        gen = torch.Generator(device=dev).manual_seed(SEED + 65)
        n_long, n_new = ((REC_SEQ_PROMPT, REC_NEW) if cfg.arch_type == "ssm"
                         else (REC_RING_PROMPT, REC_RING_NEW))
        prompt = torch.randint(0, cfg.vocab_size, (1, n_long), generator=gen,
                               device=dev)
        ssd = {}
        torch.cuda.reset_peak_memory_stats(dev)
        with ssd_paths(ssd):
            out, long_ms, launches = _counted(
                k, dtype, f"{cfg.name}/long",
                lambda: session.generate({"tokens": prompt}, n_new))
        if _bad_tokens(out, n_new, cfg):
            raise AssertionError(f"{cfg.name}: bad long-prompt result")
        if cfg.arch_type == "ssm" and not (
                ssd == ssd_expect(cfg, [n_long])
                == {"ssd_sequential": cfg.n_layers}):
            raise AssertionError(f"{cfg.name}: {n_long}-token prompt took "
                                 f"the SSD paths {ssd}")
        _merge(totals, launches)
        emit("recurrent_long_prompt", model=cfg.name, variant="bf16",
             prompt=n_long, new_tokens=n_new, ms=long_ms,
             ssd_paths=ssd or None,
             ring_wraps=(None if cfg.arch_type == "ssm"
                         else (n_long + n_new) // cfg.window),
             tokens=out[0].tolist(), refused=refused,
             peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        qparams, info = VariantSpec.dynamic_int8().build(params, cfg)
        torch.cuda.synchronize()
        emit("recurrent_int8_build", model=cfg.name,
             build_s=time.perf_counter() - t0,
             quantized_leaves=len(info["quantized_paths"]),
             size_gb=quantized_size_bytes(qparams) / 1e9,
             peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        del session, params
        torch.cuda.empty_cache()
        tiers = ("fp",) if cfg.arch_type == "ssm" else ("fp", "int8", "int4")
        for kv in tiers:
            vcfg = cfg.with_overrides(kv_cache_precision=kv)
            session = InferenceSession(qparams, vcfg)
            label = "dynamic_int8" + ("" if kv == "fp" else f"_kv{kv[3:]}")
            _merge(totals, rec_serve(k, session, vcfg, label, dev))
            del session
            torch.cuda.empty_cache()
        del qparams
        torch.cuda.empty_cache()
    rec_card_vs_cpu(dev)
    return totals


# ------------------------------------------------------------------ #
# Phase 15: musicgen-large (audio conditioning, 4 codebooks)
# ------------------------------------------------------------------ #
def frontend_trace(cfg, n, seed, prompt_len, n_new):
    """``n`` greedy requests with their conditioning: the arrivals and
    prompt lengths of ``ArrivalTrace.generate`` (Poisson, TRACE_GAP ticks
    apart on average), prompts ``[1, S, K]`` with K codebooks (drawn
    anew), ``n_new`` new tokens each, and ``n_frontend_tokens`` x
    ``frontend_dim`` embeds per request drawn N(0, 1) on the host.
    Returns (the trace, the embeds in request order)."""
    import dataclasses

    from repro_torch.serving import ArrivalTrace

    trace = ArrivalTrace.generate(cfg, n, seed=seed,
                                  mean_interarrival=TRACE_GAP,
                                  prompt_len=prompt_len,
                                  max_new=(n_new, n_new))
    gen = torch.Generator().manual_seed(seed + 1)
    reqs, embeds = [], []
    for tr in trace.requests:
        if cfg.n_codebooks > 1:
            tr = dataclasses.replace(tr, tokens=torch.randint(
                0, cfg.vocab_size, (1, tr.tokens.shape[1], cfg.n_codebooks),
                generator=gen))
        reqs.append(tr)
        embeds.append(torch.randn((1, cfg.n_frontend_tokens,
                                   cfg.frontend_dim), generator=gen))
    return ArrivalTrace(tuple(reqs), trace.seed,
                        trace.mean_interarrival), embeds


def frontend_replay(engine, trace, embeds):
    """``loadgen.replay`` for frontend requests: each submitted with its
    embeds at its arrival tick of a virtual clock, the engine stepped once
    a tick. Returns (the engine's metrics of these requests, them)."""
    from repro_torch.clock import VirtualClock

    clock, out, i = VirtualClock(), [], 0
    while (i < len(trace.requests) or engine.has_work) \
            and clock.ticks < 100_000:
        while (i < len(trace.requests)
               and trace.requests[i].arrival_step <= clock.ticks):
            tr = trace.requests[i]
            out.append(engine.submit(tr.tokens, tr.max_new_tokens,
                                     frontend_embeds=embeds[i]))
            i += 1
        engine.step()
        clock.tick()
    return engine.metrics(out), out


def _check_streams(where, reqs, n_new, cfg):
    """Every request done with ``n_new`` tokens inside the vocabulary (K
    of them a token with K codebooks)."""
    k = cfg.n_codebooks
    for r in reqs:
        toks = torch.tensor(r.out_tokens).reshape(-1)
        if (not r.done or len(r.out_tokens) != n_new
                or toks.numel() != n_new * max(k, 1)
                or int(toks.min()) < 0 or int(toks.max()) >= cfg.vocab_size):
            raise AssertionError(f"{where}: request {r.rid} ended "
                                 f"{r.status} with {r.out_tokens[:4]}")


def music_serve(k, session, cfg, label, dev):
    """The batch-1 queue (``generate``, MUSIC_NEW tokens of K codebooks
    after each of DENSE_QUEUE's prompts with its 64 conditioning frames),
    then the ``frontend_trace`` replayed by the dense engine (8 slots of
    MUSIC_ENGINE_LEN) and an 8-slot decode window profiled, each counted.
    Every prefill takes flash_tc (flash_qtc over an int8 KV cache), an
    int8-KV decode step one ``qdecode_split`` a layer, int8 weights the
    GEMMs (a decode step only the one-launch body). Returns the launch
    totals."""
    from repro_torch.serving import (ContinuousBatchingEngine, Pipeline,
                                     RequestQueue)

    dtype = getattr(torch, cfg.dtype)
    kv, nl = cfg.kv_precision, cfg.n_layers
    int8 = "int8" in label
    flash = "flash_qprefill" if kv == "int8" else "flash_prefill"
    totals = {}
    gen = torch.Generator().manual_seed(SEED + 71)
    for mode in ("queue", "dense"):
        torch.cuda.reset_peak_memory_stats(dev)
        if mode == "queue":
            batches = [{"tokens": torch.randint(
                0, cfg.vocab_size, (1, n, cfg.n_codebooks), generator=gen),
                "frontend_embeds": torch.randn(
                    (1, cfg.n_frontend_tokens, cfg.frontend_dim),
                    generator=gen)} for n in DENSE_QUEUE]
            pipe = Pipeline(preprocess=lambda raw: raw,
                            infer=lambda b: session.generate(b, MUSIC_NEW),
                            postprocess=lambda out, raw: out)
            queue = RequestQueue(pipe, max_batch=1)
            reqs = [queue.submit(b) for b in batches]
            _, serve_ms, launches = _counted(
                k, dtype, f"{cfg.name}/{label}/queue", queue.drain)
            for r in reqs:
                out = r.result
                if not r.done or tuple(out.shape) != (
                        1, MUSIC_NEW, cfg.n_codebooks) or int(out.min()) < 0 \
                        or int(out.max()) >= cfg.vocab_size:
                    raise AssertionError(f"{cfg.name}/{label}/queue: bad "
                                         "result")
            prefills = len(reqs)
            tokens = len(reqs) * MUSIC_NEW
            extra = {"queue_tokens_per_s": tokens / serve_ms * 1e3,
                     "host_ms_per_token": serve_ms / tokens}
        else:
            engine = ContinuousBatchingEngine(session,
                                              n_slots=ENGINE["n_slots"],
                                              max_len=MUSIC_ENGINE_LEN)
            engine.warmup(prompt_len=64, max_new_tokens=4)
            torch.cuda.synchronize()
            trace, embeds = frontend_trace(cfg, MUSIC_TRACE_N, SEED + 72,
                                           MUSIC_PROMPT, MUSIC_NEW)
            (report, reqs), serve_ms, launches = _counted(
                k, dtype, f"{cfg.name}/{label}/dense",
                lambda: frontend_replay(engine, trace, embeds))
            _check_streams(f"{cfg.name}/{label}/dense", reqs, MUSIC_NEW, cfg)
            prefills = len(reqs)
            tokens = report["generated_tokens"]
            steps = report["decode_steps"]
            extra = {key: report[key] for key in (
                "p50_ttft_s", "p99_ttft_s", "decode_steps")}
            extra.update(tokens_per_s=tokens / serve_ms * 1e3,
                         host_ms_per_step=serve_ms / steps)
            watch = "qdecode_split" if kv == "int8" else None
            per_step, step_ms, dtrace = decode_window(
                k, engine, cfg, torch.Generator().manual_seed(SEED + 73),
                watch, nl if watch else None)
            if kv == "int8" and per_step["qdecode.class.split"] != nl:
                raise AssertionError(f"{cfg.name}/{label}: a decode step "
                                     f"launched {per_step['qdecode']} "
                                     f"qdecode, want {nl} split")
            extra.update(decode_step_ms_8_slots=step_ms,
                         launches_per_decode_step=per_step,
                         decode_trace=dtrace)
            del engine
        other = "flash_prefill" if flash == "flash_qprefill" \
            else "flash_qprefill"
        if launches[flash] != nl * prefills or launches[other] \
                or launches["flash_q4prefill"]:
            raise AssertionError(f"{cfg.name}/{label}/{mode}: {flash} "
                                 f"launched {launches[flash]}, want "
                                 f"{nl} x {prefills} ({launches})")
        if int8 != (launches["qmatmul_dynamic"] > 0):
            raise AssertionError(f"{cfg.name}/{label}/{mode}: int8 GEMM "
                                 f"launches {launches['qmatmul_dynamic']}")
        if (kv == "int8") != (launches["qdecode"] > 0) \
                or launches["qdecode.class.wide"]:
            raise AssertionError(f"{cfg.name}/{label}/{mode}: qdecode "
                                 f"launches {launches['qdecode']}")
        emit("musicgen", model=cfg.name, variant=label, kv_cache=kv,
             mode=mode, layers=nl, d_model=cfg.d_model,
             codebooks=cfg.n_codebooks,
             frontend_tokens=cfg.n_frontend_tokens,
             generated_tokens=tokens, serve_ms=serve_ms, launches=launches,
             peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
             **extra)
        _merge(totals, launches)
        torch.cuda.empty_cache()
    return totals


def music_card_vs_cpu(dev):
    """musicgen-large at published width and MUSIC_CPU_DEPTH layers in
    f32, the same weights on the CPU's plain path and the card's kernel
    path: a MUSIC_CPU_PROMPT-token prompt of 4 codebooks after its 64
    conditioning frames and 8 teacher-forced decode steps (logits [1, 1,
    4, 2048] a step), with fp32 weights, dynamic-int8 weights and fp32
    weights over the int8 KV cache. Each held to the larger of its
    ``CPU_TOL`` bound (stablelm's) and 2.5x the CPU's own one-rounding
    nudge."""
    from repro_torch import configs
    from repro_torch.api.variants import VariantSpec
    from repro_torch.models import init_params
    from repro_torch.models.layers import place_params
    from repro_torch.serving import InferenceSession

    cfg = configs.get_config(MUSIC).with_overrides(
        n_layers=MUSIC_CPU_DEPTH, dtype="float32")
    gen = torch.Generator().manual_seed(SEED + 74)
    tokens = torch.randint(0, cfg.vocab_size,
                           (1, MUSIC_CPU_PROMPT, cfg.n_codebooks),
                           generator=gen)
    fe = torch.randn((1, cfg.n_frontend_tokens, cfg.frontend_dim),
                     generator=gen)
    # drawn on the card (fast), copied to the host
    params = place_params(init_params(cfg, seed=SEED + 75), "cpu")
    torch.cuda.empty_cache()
    for label, spec, kv in (("fp32", VariantSpec.fp32(), "fp"),
                            ("dynamic_int8", VariantSpec.dynamic_int8(),
                             "fp"),
                            ("fp32_int8kv", VariantSpec.fp32(), "int8")):
        vcfg = cfg.with_overrides(kv_cache_precision=kv)
        qparams, _ = spec.build(params, vcfg)
        card = InferenceSession(qparams, vcfg)
        cpu_steps, fed = teacher_forced(qparams, vcfg, tokens, "cpu", False,
                                        frontend=fe)
        card_steps, _ = teacher_forced(card.params, vcfg, tokens, dev, False,
                                       fed, frontend=fe)
        with nudged_norms():
            nudge_steps, _ = teacher_forced(qparams, vcfg, tokens, "cpu",
                                            False, fed, frontend=fe)
        worst_max, worst_mean = logit_diff(cpu_steps, card_steps)
        nudge_max, nudge_mean = logit_diff(cpu_steps, nudge_steps)
        fixed = CPU_TOL[label]
        tol_max = max(fixed[0], 2.5 * nudge_max)
        tol_mean = max(fixed[1], 2.5 * nudge_mean)
        ok = worst_max <= tol_max and worst_mean <= tol_mean
        emit("musicgen_card_vs_cpu", model=cfg.name, variant=label,
             kv_cache=kv, layers=cfg.n_layers, d_model=cfg.d_model,
             codebooks=cfg.n_codebooks, logits_shape=list(
                 card_steps[0].shape), prompt=MUSIC_CPU_PROMPT,
             decode_steps=8, max_abs_err=worst_max, mean_abs_err=worst_mean,
             tol_max=tol_max, tol_mean=tol_mean, cpu_nudge_max=nudge_max,
             cpu_nudge_mean=nudge_mean,
             logit_scale=float(cpu_steps[0].abs().max()), ok=ok)
        if not ok:
            raise AssertionError(f"{cfg.name} card vs CPU logits differ by "
                                 f"max {worst_max} / mean {worst_mean} "
                                 f"({label})")
        del card, qparams
        torch.cuda.empty_cache()


def musicgen_phase(k, dev):
    """musicgen-large at published width and MUSIC_LAYERS of its 48 layers
    (4 codebooks of 2048, 64 conditioning frames of 1024 a request) in
    bf16, random
    seeded weights, through ``music_serve``; paged and speculative engines
    refused; then (the bf16 weights freed) its dynamic-int8 artifact over
    the fp and the int8 KV cache through ``music_serve``; then
    ``music_card_vs_cpu``. Returns the launch totals."""
    from repro_torch import configs
    from repro_torch.api.variants import VariantSpec
    from repro_torch.core.quant import quantized_size_bytes
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceSession
    from repro_torch.tree import leaves_with_path

    cfg = configs.get_config(MUSIC).with_overrides(n_layers=MUSIC_LAYERS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=SEED)
    torch.cuda.synchronize()
    emit("musicgen_setup", model=cfg.name, layers=cfg.n_layers,
         codebooks=cfg.n_codebooks, params=cfg.param_count(),
         param_gb=sum(t.numel() * t.element_size() for _, t in
                      leaves_with_path(params)) / 1e9,
         init_s=time.perf_counter() - t0,
         leaves={key: list(params[key].shape)
                 for key in ("extra_embeds", "out_heads", "frontend_proj")})
    session = InferenceSession(params, cfg)
    refused = rec_refusals(session, cfg)
    totals = music_serve(k, session, cfg, "bf16", dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    qparams, info = VariantSpec.dynamic_int8().build(params, cfg)
    torch.cuda.synchronize()
    quantized = info["quantized_paths"]
    if not {"extra_embeds", "out_heads"} <= set(quantized):
        raise AssertionError(f"{cfg.name}: codebook leaves not quantized")
    emit("musicgen_int8_build", model=cfg.name,
         build_s=time.perf_counter() - t0, quantized_leaves=len(quantized),
         size_gb=quantized_size_bytes(qparams) / 1e9, refused=refused,
         peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    del session, params
    torch.cuda.empty_cache()
    for kv in ("fp", "int8"):
        vcfg = cfg.with_overrides(kv_cache_precision=kv)
        session = InferenceSession(qparams, vcfg)
        label = "dynamic_int8" + ("" if kv == "fp" else "_kv8")
        _merge(totals, music_serve(k, session, vcfg, label, dev))
        del session
        torch.cuda.empty_cache()
    del qparams
    torch.cuda.empty_cache()
    music_card_vs_cpu(dev)
    return totals


# ------------------------------------------------------------------ #
# Phase 16: frontend requests in the engines (phi-3-vision)
# ------------------------------------------------------------------ #
def frontend_phase(k, dev):
    """phi-3-vision-4.2b at published width and FRONTEND_LAYERS of its 32
    layers in bf16, random seeded weights: a trace of FRONTEND_TRACE_N
    requests, each 576 patch embeds and a prompt, replayed by the dense
    and then the paged engine (8 slots of FRONTEND_LEN; every prefill one
    flash_tc a layer over 576 + prompt rows at hd 96; a paged decode step
    one ``paged_decode_split`` a layer), an 8-slot decode window of each
    profiled. The paged engine hashes no block (no prefix hit). Its
    streams equal the dense engine's or part at a tie up to one rounding
    (``_partings``). Returns the launch totals."""
    from repro_torch import configs
    from repro_torch.models import init_params
    from repro_torch.serving import ContinuousBatchingEngine, InferenceSession

    cfg = configs.get_config(VLM).with_overrides(n_layers=FRONTEND_LAYERS)
    nl, dtype = cfg.n_layers, torch.bfloat16
    params = init_params(cfg, seed=SEED)
    session = InferenceSession(params, cfg)
    trace, embeds = frontend_trace(cfg, FRONTEND_TRACE_N, SEED + 76,
                                   FRONTEND_PROMPT, FRONTEND_NEW)
    blocks = -(-FRONTEND_LEN // 16)
    totals, streams = {}, {}
    for mode in ("dense", "paged"):
        kw = ({"paged": True, "block_size": 16,
               "n_blocks": ENGINE["n_slots"] * blocks + 1}
              if mode == "paged" else {})
        engine = ContinuousBatchingEngine(session, n_slots=ENGINE["n_slots"],
                                          max_len=FRONTEND_LEN, **kw)
        engine.warmup(prompt_len=16, max_new_tokens=2)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        where = f"{cfg.name}/frontend/{mode}"
        (report, reqs), serve_ms, launches = _counted(
            k, dtype, where, lambda: frontend_replay(engine, trace, embeds))
        _check_streams(where, reqs, FRONTEND_NEW, cfg)
        streams[mode] = [r.out_tokens for r in reqs]
        prefills = len(reqs) + report["preempted"]
        steps = report["decode_steps"]
        want_paged = nl * steps if mode == "paged" else 0
        if launches["flash_prefill"] != nl * prefills \
                or launches["paged_decode"] != want_paged \
                or report["prefix_hit_tokens"] != 0:
            raise AssertionError(f"{where}: flash_prefill "
                                 f"{launches['flash_prefill']} (want {nl} x "
                                 f"{prefills}), paged_decode "
                                 f"{launches['paged_decode']} (want "
                                 f"{want_paged}), prefix hits "
                                 f"{report['prefix_hit_tokens']}")
        watch = "paged_decode_split" if mode == "paged" else None
        per_step, step_ms, dtrace = decode_window(
            k, engine, cfg, torch.Generator().manual_seed(SEED + 77), watch,
            nl if watch else None)
        emit("frontend", model=cfg.name, dtype=cfg.dtype, layers=nl,
             published_layers=32, mode=mode, requests=len(reqs),
             frontend_tokens=cfg.n_frontend_tokens,
             prompt_lens=[r.prompt_len for r in reqs],
             generated_tokens=report["generated_tokens"], serve_ms=serve_ms,
             tokens_per_s=report["generated_tokens"] / serve_ms * 1e3,
             host_ms_per_step=serve_ms / steps, decode_steps=steps,
             p50_ttft_s=report["p50_ttft_s"], p99_ttft_s=report["p99_ttft_s"],
             preempted=report["preempted"],
             prefix_hit_tokens=report["prefix_hit_tokens"],
             kv_blocks_peak=report["kv_blocks_peak"], launches=launches,
             decode_step_ms_8_slots=step_ms,
             launches_per_decode_step=per_step, decode_trace=dtrace,
             peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        _merge(totals, launches)
        del engine
        torch.cuda.empty_cache()
    parted = _partings(session.params, cfg, trace, streams["dense"],
                       streams["paged"], dev, {}, frontends=embeds)
    emit("frontend_agreement", model=cfg.name,
         paged_equals_dense_streams=len(trace.requests) - len(parted),
         of=len(trace.requests), partings=parted)
    if not all(p["ok"] for p in parted):
        raise AssertionError(f"{cfg.name}: paged and dense frontend streams "
                             f"part beyond a tie: {parted}")
    del session, params
    torch.cuda.empty_cache()
    return totals


# ------------------------------------------------------------------ #
# Phase 17: the SLO router over prefill and decode workers
# ------------------------------------------------------------------ #
def router_handoffs(k, params, cfg, trace, dev):
    """One handoff per KV tier (bf16, int8, int4): a prompt prefilled by a
    prefill worker, exported, and decoded by a decode worker on the same
    ``SharedKVPool``, against one paged engine of the same slots serving
    the same prompt. Each tier's prefill takes its flash body (flash_tc,
    flash_qtc, flash_q4tc) and each decode step its paged split kernel.
    Returns the launch totals."""
    from repro_torch.serving import ContinuousBatchingEngine, SharedKVPool

    kernels = {"fp": ("flash_prefill", "paged_decode"),
               "int8": ("flash_qprefill", "paged_qdecode"),
               "int4": ("flash_q4prefill", "paged_q4decode")}
    prompt = max((r.tokens for r in trace.requests),
                 key=lambda t: t.shape[1])
    totals = {}
    for kv, (prefill_k, decode_k) in kernels.items():
        vcfg = cfg.with_overrides(kv_cache_precision=kv)
        store = SharedKVPool(vcfg, ROUTER_HANDOFF_BLOCKS, 16)
        pre, dec = (ContinuousBatchingEngine(
            params, vcfg, n_slots=2, max_len=ENGINE["max_len"], paged=True,
            shared_kv=store) for _ in range(2))
        single = ContinuousBatchingEngine(
            params, vcfg, n_slots=2, max_len=ENGINE["max_len"], paged=True,
            block_size=16, n_blocks=ROUTER_HANDOFF_BLOCKS)

        def disagg():
            r = pre.submit_prefill(prompt)
            pre.run()
            d = dec.submit_handoff(r.kv_handoff, max_new_tokens=ROUTER_NEW[1])
            dec.run()
            return d

        def alone():
            r = single.submit(prompt, max_new_tokens=ROUTER_NEW[1])
            single.run()
            return r

        where = f"router/handoff/{kv}"
        d, ms, launches = _counted(k, torch.bfloat16, where, disagg)
        s, single_ms, single_launches = _counted(k, torch.bfloat16,
                                                 f"{where}/single", alone)
        if (launches[prefill_k] != cfg.n_layers
                or launches[decode_k] < cfg.n_layers
                or launches[decode_k] != single_launches[decode_k]
                or dec.prompt_tokens_computed != 0
                or store.alloc.in_use != 0):
            raise AssertionError(f"{where}: {prefill_k} "
                                 f"{launches[prefill_k]}, {decode_k} "
                                 f"{launches[decode_k]} (single "
                                 f"{single_launches[decode_k]}), recomputed "
                                 f"{dec.prompt_tokens_computed}, blocks in "
                                 f"use {store.alloc.in_use}")
        emit("router_handoff", model=cfg.name, layers=cfg.n_layers,
             kv_cache=kv, prompt=prompt.shape[1], new_tokens=ROUTER_NEW[1],
             equal_to_single_engine=d.out_tokens == s.out_tokens,
             tokens=d.out_tokens, single_tokens=s.out_tokens,
             handoff_ms=ms, single_ms=single_ms,
             prefix_hit_tokens=d.prefix_hit, launches=launches)
        if d.out_tokens != s.out_tokens:
            raise AssertionError(f"{where}: the handoff's stream parts from "
                                 f"the single engine's")
        _merge(totals, launches)
        _merge(totals, single_launches)
        del pre, dec, single, store
        torch.cuda.empty_cache()
    return totals


def router_phase(k, dev):
    """stablelm-1.6b at full width and SERVE_LAYERS of its 24 layers in
    bf16, random seeded weights: a seeded trace of ROUTER_TRACE_N requests
    (every other one interactive) through ``single_engine_trace`` on one
    paged engine of 8 slots and through ``route_trace`` on a
    ``ServingRouter`` over 1 prefill and 2 decode workers (4 slots each)
    on one ``SharedKVPool`` of the same blocks: the router's virtual-time
    metrics beside the single arm's, wall time per tick, zero prompt tokens
    recomputed by the decode workers, the router's streams equal to the
    single engine's or parted at a tie up to one rounding (``_partings``),
    every block back in the pool; then 4 router ticks profiled with every
    worker busy, and ``router_handoffs``. Returns the launch totals."""
    from repro_torch import configs
    from repro_torch.models import init_params
    from repro_torch.serving import (ArrivalTrace, ContinuousBatchingEngine,
                                     ServingRouter, SharedKVPool,
                                     route_trace, single_engine_trace)

    cfg = configs.get_config("stablelm-1.6b")
    vcfg = cfg.with_overrides(n_layers=SERVE_LAYERS)
    full = init_params(cfg, seed=SEED)
    params = {**full, "layers": full["layers"][:vcfg.n_layers]}
    del full
    torch.cuda.empty_cache()
    nl, dtype = vcfg.n_layers, torch.bfloat16
    trace = ArrivalTrace.generate(vcfg, ROUTER_TRACE_N, seed=SEED + 80,
                                  mean_interarrival=TRACE_GAP,
                                  prompt_len=ROUTER_PROMPT,
                                  max_new=ROUTER_NEW)
    n_blocks = 2 * ENGINE["n_slots"] * -(-(ROUTER_PROMPT[1]
                                           + ROUTER_NEW[1]) // 16) + 1
    single = ContinuousBatchingEngine(params, vcfg, n_slots=ENGINE["n_slots"],
                                      max_len=ENGINE["max_len"], paged=True,
                                      block_size=16, n_blocks=n_blocks)
    single.warmup(prompt_len=64, max_new_tokens=4)
    torch.cuda.synchronize()
    s_report, single_ms, single_launches = _counted(
        k, dtype, "router/single", lambda: single_engine_trace(single,
                                                                trace))
    store = SharedKVPool(vcfg, n_blocks, 16)
    workers = [ContinuousBatchingEngine(
        params, vcfg, n_slots=ROUTER_SLOTS, max_len=ENGINE["max_len"],
        paged=True, shared_kv=store, max_queue_depth=q) for q in (0, 4, 4)]
    router = ServingRouter(workers[:1], workers[1:])
    router.warmup()
    r_report, router_ms, launches = _counted(
        k, dtype, "router/route", lambda: route_trace(router, trace))
    if r_report["decode_prompt_tokens_recomputed"] != 0 \
            or r_report["router_completed"] != len(trace.requests) \
            or s_report["single_completed"] != len(trace.requests) \
            or store.alloc.in_use != 0:
        raise AssertionError(f"router: recomputed "
                             f"{r_report['decode_prompt_tokens_recomputed']}"
                             f", completed {r_report['router_completed']}, "
                             f"blocks in use {store.alloc.in_use}")
    if launches["flash_prefill"] < nl * len(trace.requests) \
            or launches["paged_decode"] <= 0:
        raise AssertionError(f"router: launches {launches}")
    base = [r.out_tokens for r in single.all_requests]
    got = [rr.out_tokens for rr in router.requests]
    parted = _partings(params, vcfg, trace, base, got, dev, {})
    ticks = r_report["router_ticks"]
    gen_tokens = r_report["router_generated_tokens"]
    # steady state: every worker busy, 4 ticks profiled
    wgen = torch.Generator().manual_seed(SEED + 81)
    for _ in range(2 * ROUTER_SLOTS):
        # 49 tokens: a 48-token prefill and one tail tick on the worker
        router.submit(torch.randint(0, vcfg.vocab_size, (1, 49),
                                    generator=wgen), max_new_tokens=40)
    for _ in range(12):
        router.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        router.step()
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) * 1e3 / 8
    tick_trace = profile_steps(router.step, 4, tick_ms)
    router.run()
    emit("router", model=cfg.name, dtype=vcfg.dtype, layers=nl,
         requests=len(trace.requests), prompt_len=list(ROUTER_PROMPT),
         max_new=list(ROUTER_NEW), pool_blocks=n_blocks,
         workers={"prefill": 1, "decode": 2, "slots_each": ROUTER_SLOTS},
         single_slots=ENGINE["n_slots"],
         router_metrics=r_report, single_metrics=s_report,
         router_wall_ms=router_ms, single_wall_ms=single_ms,
         router_ms_per_tick=router_ms / ticks,
         single_ms_per_tick=single_ms / s_report["single_ticks"],
         router_tokens_per_s_wall=gen_tokens / router_ms * 1e3,
         single_tokens_per_s_wall=(sum(len(t) for t in base)
                                   / single_ms * 1e3),
         streams_equal=len(base) - len(parted), of=len(base),
         partings=parted, launches=launches,
         single_launches=single_launches,
         steady_tick_ms=tick_ms, steady_tick_trace=tick_trace)
    if not all(p["ok"] for p in parted):
        raise AssertionError(f"router streams part from the single engine's "
                             f"beyond a tie: {parted}")
    totals = {}
    _merge(totals, single_launches)
    _merge(totals, launches)
    del router, workers, store, single
    torch.cuda.empty_cache()
    _merge(totals, router_handoffs(k, params, vcfg, trace, dev))
    return totals


# ------------------------------------------------------------------ #
# Phase 18: tensor-parallel serving
# ------------------------------------------------------------------ #
#: the kernels a shard launches on its own head slice: a tp=2 engine
#: launches each of them twice for every launch of the tp=1 engine
TP_KERNELS = ("flash_prefill", "flash_qprefill", "flash_q4prefill",
              "qdecode", "paged_decode", "paged_qdecode", "paged_q4decode")
#: each tier's prefill kernel and its decode kernel, dense and paged (the
#: dense fp and int4 decodes are plain, as in the JAX package)
TP_TIER_KERNELS = {"fp": ("flash_prefill", None, "paged_decode"),
                   "int8": ("flash_qprefill", "qdecode", "paged_qdecode"),
                   "int4": ("flash_q4prefill", None, "paged_q4decode")}


def tp_serve(k, params, cfg, trace, tp, paged, combine="exact"):
    """``trace`` replayed by an engine of 8 slots of TP_LEN whose ``tp``
    shards share the card, counted. Returns (metrics, requests, serve ms,
    launches, the engine)."""
    from repro_torch.serving import ContinuousBatchingEngine

    kw = {"paged": True, "block_size": 16} if paged else {}
    engine = ContinuousBatchingEngine(params, cfg, n_slots=ENGINE["n_slots"],
                                      max_len=TP_LEN, tp=tp,
                                      tp_combine=combine, **kw)
    engine.warmup(prompt_len=16, max_new_tokens=2)
    torch.cuda.synchronize()
    where = (f"{cfg.name}/tp{tp}/{combine}/{cfg.kv_precision}/"
             f"{'paged' if paged else 'dense'}")
    (report, reqs), serve_ms, launches = _counted(
        k, cfg.activation_dtype, where,
        lambda: frontend_replay(engine, trace, [None] * len(trace.requests)))
    _check_streams(where, reqs, TP_NEW, cfg)
    return report, reqs, serve_ms, launches, engine


def tp_counts(where, nl, tier, paged, runs):
    """tp=1 launches each kernel of its tier once a layer a prefill (and a
    step, for its decode kernel), tp=2 twice that, on the same prefills
    and steps; no other kernel of TP_KERNELS launches."""
    prefill_k, dense_k, paged_k = TP_TIER_KERNELS[tier]
    decode_k = paged_k if paged else dense_k
    r1, r2 = runs[1], runs[2]
    if (r1["prefills"], r1["steps"]) != (r2["prefills"], r2["steps"]):
        raise AssertionError(f"{where}: prefills / steps {r1['prefills']} / "
                             f"{r1['steps']} at tp=1, {r2['prefills']} / "
                             f"{r2['steps']} at tp=2")
    for tp, r in runs.items():
        want = {name: 0 for name in TP_KERNELS}
        want[prefill_k] = tp * nl * r["prefills"]
        if decode_k is not None:
            want[decode_k] = tp * nl * r["steps"]
        got = {name: r["launches"][name] for name in TP_KERNELS}
        if got != want:
            raise AssertionError(f"{where}: tp={tp} launches {got}, want "
                                 f"{want}")


def tp_phase(k, dev, seen, layers=TP_LAYERS):
    """mistral-nemo-12b at published width (``layers`` of 40) in bf16
    on random seeded weights: the trace replayed by a tp=1 and a tp=2
    engine (both shards on the card), dense and paged, over the fp, int8
    and int4 KV caches. tp=2 streams equal tp=1's or part at a tie
    (``_partings``: the tp=2 stream teacher-forced through the tp=1 dense
    path, within one rounding's nudge); each per-shard kernel launches 2x
    the tp=1 count (``tp_counts``); a psum-combine engine over the fp pool
    likewise, its prefill logits within 2.5x the nudge of the exact
    combine's; an 8-slot paged step profiled at each tp. Then deepseek-v2's
    MLA attention with no experts at TP_MLA_LAYERS: ``flash_mla`` at 64
    heads a shard, 2x the tp=1 launches, streams held the same way. The
    per-shard shapes (Hq 16, Hkv 4, hd 128; MLA's 64 heads) must be among
    those ``recording_shapes`` gathered. Returns (the launch totals, the
    totals by tp)."""
    from repro_torch import configs
    from repro_torch.models import init_params
    from repro_torch.serving import ArrivalTrace

    base = configs.get_config(TP_MODEL).with_overrides(n_layers=layers)
    nl = base.n_layers
    params = init_params(base, seed=SEED)
    trace = ArrivalTrace.generate(base, TP_TRACE_N, seed=SEED + 90,
                                  mean_interarrival=TRACE_GAP,
                                  prompt_len=TP_PROMPT,
                                  max_new=(TP_NEW, TP_NEW))
    prompt = {"tokens": trace.requests[0].tokens.to(dev)}
    totals, by_tp = {}, {1: {}, 2: {}}
    fp_paged = {}

    def serve(cfg, tp, paged, combine="exact"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        report, reqs, serve_ms, launches, engine = tp_serve(
            k, params, cfg, trace, tp, paged, combine)
        steps = report["decode_steps"]
        run = {"launches": launches, "steps": steps,
               "prefills": len(reqs) + report["preempted"],
               "streams": [r.out_tokens for r in reqs]}
        emit("tp", model=cfg.name, dtype=cfg.dtype, layers=nl,
             published_layers=TP_PUBLISHED_LAYERS, tp=tp, combine=combine,
             kv=cfg.kv_precision, mode="paged" if paged else "dense",
             requests=len(reqs), prompt_lens=[r.prompt_len for r in reqs],
             generated_tokens=report["generated_tokens"], serve_ms=serve_ms,
             tokens_per_s=report["generated_tokens"] / serve_ms * 1e3,
             host_ms_per_step=serve_ms / steps, decode_steps=steps,
             p50_ttft_s=report["p50_ttft_s"], p99_ttft_s=report["p99_ttft_s"],
             preempted=report["preempted"],
             kv_hbm_bytes_per_req=report["kv_hbm_bytes_per_req"],
             kv_hbm_bytes_per_req_per_shard=report[
                 "kv_hbm_bytes_per_req_per_shard"],
             launches=launches,
             peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
        _merge(totals, launches)
        _merge(by_tp[tp], launches)
        return run, engine

    for tier in ("fp", "int8", "int4"):
        cfg = base.with_overrides(kv_cache_precision=tier)
        memo = {}
        for paged in (False, True):
            mode = "paged" if paged else "dense"
            runs = {}
            for tp in (1, 2):
                runs[tp], engine = serve(cfg, tp, paged)
                if tier == "fp" and paged:
                    # the profiled step, and at tp=2 the exact logits
                    per_step, step_ms, dtrace = decode_window(
                        k, engine, cfg, torch.Generator().manual_seed(
                            SEED + 91), "paged_decode_split", tp * nl)
                    if per_step["paged_decode"] != tp * nl:
                        raise AssertionError(f"tp={tp} step: paged_decode "
                                             f"{per_step['paged_decode']}")
                    emit("tp_profile", model=cfg.name, layers=nl, tp=tp,
                         kv=tier, mode=mode, decode_step_ms_8_slots=step_ms,
                         launches_per_decode_step=per_step,
                         decode_trace=dtrace)
                    if tp == 2:
                        with torch.no_grad():
                            fp_paged["exact"] = engine._tp_ctx.prefill_logits(
                                engine.params, prompt).cpu()
                del engine
                torch.cuda.empty_cache()
            where = f"{cfg.name}/tp/{tier}/{mode}"
            tp_counts(where, nl, tier, paged, runs)
            parted = _partings(params, cfg, trace, runs[1]["streams"],
                               runs[2]["streams"], dev, memo)
            emit("tp_agreement", model=cfg.name, layers=nl, kv=tier,
                 mode=mode, tp2_equals_tp1_streams=len(trace.requests)
                 - len(parted), of=len(trace.requests), partings=parted)
            if not all(p["ok"] for p in parted):
                raise AssertionError(f"{where}: tp=2 streams part from tp=1 "
                                     f"beyond a tie: {parted}")
            if tier == "fp" and paged:
                fp_paged["tp1"] = runs[1]
    # the psum combine (row-parallel wo, an all-reduce) over the fp pool
    cfg = base.with_overrides(kv_cache_precision="fp")
    run, engine = serve(cfg, 2, True, combine="psum")
    with torch.no_grad():
        psum_logits = engine._tp_ctx.prefill_logits(engine.params,
                                                    prompt).cpu()
    del engine
    torch.cuda.empty_cache()
    tp_counts(f"{cfg.name}/tp/psum", nl, "fp", True,
              {1: fp_paged["tp1"], 2: run})
    parted = _partings(params, cfg, trace, fp_paged["tp1"]["streams"],
                       run["streams"], dev, {})
    plain, _ = teacher_forced(params, cfg, prompt["tokens"], dev, False,
                              n_steps=0)
    with nudged_norms():
        nudged, _ = teacher_forced(params, cfg, prompt["tokens"], dev, False,
                                   n_steps=0)
    nudge = float((nudged[0] - plain[0]).abs().max())
    psum_err = float((psum_logits - fp_paged["exact"]).abs().max())
    emit("tp_psum", model=cfg.name, layers=nl, kv="fp", mode="paged",
         psum_vs_exact_logits_max_abs=psum_err, nudge=nudge,
         bound=2.5 * nudge, exact_vs_tp1_logits_max_abs=float(
             (fp_paged["exact"] - plain[0]).abs().max()),
         tp2_equals_tp1_streams=len(trace.requests) - len(parted),
         of=len(trace.requests), partings=parted)
    if psum_err > 2.5 * nudge or not all(p["ok"] for p in parted):
        raise AssertionError(f"psum: logits {psum_err} from exact (bound "
                             f"{2.5 * nudge}), partings {parted}")
    del params
    torch.cuda.empty_cache()
    # MLA: deepseek-v2's attention, its experts off
    mcfg = configs.get_config(TP_MLA_MODEL).with_overrides(
        n_layers=TP_MLA_LAYERS, n_experts=0)
    mparams = init_params(mcfg, seed=SEED + 92)
    mtrace = ArrivalTrace.generate(mcfg, TP_TRACE_N, seed=SEED + 93,
                                   mean_interarrival=TRACE_GAP,
                                   prompt_len=TP_PROMPT,
                                   max_new=(TP_NEW, TP_NEW))
    memo = {}
    for paged in (False, True):
        runs = {}
        for tp in (1, 2):
            report, reqs, serve_ms, launches, engine = tp_serve(
                k, mparams, mcfg, mtrace, tp, paged)
            del engine
            torch.cuda.empty_cache()
            prefills = len(reqs) + report["preempted"]
            runs[tp] = [r.out_tokens for r in reqs]
            want = tp * TP_MLA_LAYERS * prefills
            mla = (launches["flash_prefill"],
                   launches["flash_prefill.class.192x128"],
                   launches[f"flash_prefill.{k.flash_prefill.MLA_BODY}"])
            if mla != (want, want, want):
                raise AssertionError(f"MLA tp={tp}: flash_prefill / 192x128 "
                                     f"/ {k.flash_prefill.MLA_BODY} {mla}, "
                                     f"want {want}")
            emit("tp_mla", model=mcfg.name, layers=TP_MLA_LAYERS,
                 published_layers=60, n_experts=0, tp=tp,
                 mode="paged" if paged else "dense", requests=len(reqs),
                 serve_ms=serve_ms, decode_steps=report["decode_steps"],
                 tokens_per_s=report["generated_tokens"] / serve_ms * 1e3,
                 kv_hbm_bytes_per_req=report["kv_hbm_bytes_per_req"],
                 kv_hbm_bytes_per_req_per_shard=report[
                     "kv_hbm_bytes_per_req_per_shard"], launches=launches)
            _merge(totals, launches)
            _merge(by_tp[tp], launches)
        parted = _partings(mparams, mcfg, mtrace, runs[1], runs[2], dev, memo)
        emit("tp_mla_agreement", model=mcfg.name,
             mode="paged" if paged else "dense",
             tp2_equals_tp1_streams=len(mtrace.requests) - len(parted),
             of=len(mtrace.requests), partings=parted)
        if not all(p["ok"] for p in parted):
            raise AssertionError(f"MLA tp=2 streams part from tp=1 beyond a "
                                 f"tie: {parted}")
    del mparams
    torch.cuda.empty_cache()
    # the per-shard shapes the kernels were given
    shard = {
        "flash_prefill": any(key[2:5] == (16, 4, 128)
                             for key in seen.get("flash_prefill", ())),
        "flash_prefill_mla": any(key[2:6] == (64, 64, 192, 128)
                                 for key in seen.get("flash_prefill", ())),
        "flash_qprefill": any(key[2:5] == (16, 4, 128)
                              for key in seen.get("flash_qprefill", ())),
        "flash_q4prefill": any(key[2:5] == (16, 4, 128)
                               for key in seen.get("flash_q4prefill", ())),
        "qdecode": any(key[2:5] == (4, 4, 128)
                       for key in seen.get("qdecode", ())),
        **{name: any(key[1:4] == (4, 4, 128) for key in seen.get(name, ()))
           for name in ("paged_decode", "paged_qdecode", "paged_q4decode")}}
    emit("tp_shapes", per_shard_shapes_recorded=shard)
    if not all(shard.values()):
        raise AssertionError(f"per-shard shapes not recorded: {shard}")
    return totals, by_tp


# ------------------------------------------------------------------ #
# Phase 19: the fleet simulator and its EnginePool
# ------------------------------------------------------------------ #
#: the kernels of the fleet path (the f32 prefill body, both int8 GEMMs,
#: the fp paged decode); every other kernel row launches 0 times on it
FLEET_KERNELS = ("flash_prefill", "qmatmul_dynamic", "qmatmul_static",
                 "paged_decode")


def _fleet_example():
    """``examples/fleet_sim_torch.py``, for its SPECS, POLICY and FAULTS."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "fleet_sim_torch", os.path.join(ROOT, "examples",
                                        "fleet_sim_torch.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _busy(fn):
    """``fn()`` under a device-only profiler: (its result, device busy ms,
    kernels), the device drained before the window closes."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        out = fn()
        torch.cuda.synchronize()
    busy, kernels = 0.0, 0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA") \
                and not e.key.startswith("ProfilerStep"):
            busy += getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0.0))
            kernels += e.count
    return out, busy / 1e3, kernels


def _fleet_serve(engine, prompts):
    """Every prompt through one engine (or router) with FLEET_NEW new
    tokens, run to the end: the streams, and an engine's metrics over
    these requests (None for a router)."""
    reqs = [engine.submit(p, max_new_tokens=FLEET_NEW) for p in prompts]
    engine.run()
    states = [getattr(r, "state", None) or r.status for r in reqs]
    if any(s != "done" for s in states):
        raise AssertionError(f"fleet: requests not served: {states}")
    metrics = engine.metrics(reqs) if hasattr(engine, "kv") else None
    return [list(r.out_tokens) for r in reqs], metrics


def fleet_rollout(k, dev, registry, dep, pool, batch, sizes, variant_of):
    """The rollout: FLEET_DEVICES heterogeneous devices on the card, the
    example's POLICY and FAULTS, v2 regressed; v1 completes, v2 aborts and
    rolls back, the real forwards all land in the pool's shared sessions.
    Returns (the launches, the simulator)."""
    from repro_torch.api import WorkloadModel
    from repro_torch.fleet.simulator import DEVICE_CLASSES

    ex = _fleet_example()
    # the largest class transfer (its variant over its link, slowed) and
    # a wave's longest gate (soaks and extensions) set the virtual horizon;
    # v2 is deferred until v1 is done
    slowest = max(sizes[variant_of[cls]] * 8.0 / (link * 1e6)
                  for cls, _, _, link in DEVICE_CLASSES) \
        * ex.FAULTS.slow_link_factor
    gate_s = ex.POLICY.soak_s * (1 + ex.POLICY.max_gate_extensions)
    horizon = FLEET_HORIZON_TRANSFERS * (slowest + gate_s)
    sim = dep.simulator(seed=SEED, faults=ex.FAULTS, pool=pool,
                        workload=WorkloadModel(
                            version_error_rate={"v2": 0.6}),
                        real_every=FLEET_REAL_EVERY,
                        real_batch=lambda agent: batch)
    sim.add_heterogeneous_fleet(FLEET_DEVICES, device=dev,
                                inspection_interval_s=FLEET_INTERVAL)
    sim.schedule_rollout("v1", ex.POLICY, at=10.0)
    sim.schedule_rollout("v2", ex.POLICY, at=10.0 + slowest)
    reset_counters(k)                        # ---- the rollout: counted
    t0 = time.perf_counter()
    m = sim.run(until=horizon)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = read_counters(k)              # ---- read right after
    launches.update(check_bodies(k, "fleet/rollout", launches,
                                 torch.float32))
    v1, v2 = sim.rollouts
    real = m["inspections"] // FLEET_REAL_EVERY
    calls = {key: s.calls for key, s in pool.stats().items()}
    errors = sum(a.error_count for a in sim.dep.devices.values())
    distinct = sorted({e["artifact"] for e in sim.events
                       if e["kind"] == "device_activated"})
    emit("fleet_rollout", devices=m["devices"], seed=SEED,
         inspection_interval_s=FLEET_INTERVAL, slowest_transfer_s=slowest,
         horizon_s=horizon, v2_scheduled_at_s=10.0 + slowest,
         rollouts=m["rollouts"], events=m["events"],
         inspections=m["inspections"], active_artifacts=m["active_artifacts"],
         telemetry=m["telemetry"], pool_fetches=pool.fetches,
         activated_artifacts=distinct, real_every=FLEET_REAL_EVERY,
         real_inferences_scheduled=real, session_calls=calls,
         agent_errors=errors, run_wall_s=run_s, launches=launches)
    if v1.status != "complete" or v2.status != "aborted" \
            or v2.t_recovered is None or not v2.rolled_back \
            or any(key and ":v2:" in key for key in m["active_artifacts"]):
        raise AssertionError(f"fleet: v1 {v1.summary()}, v2 {v2.summary()}"
                             f", active {m['active_artifacts']}")
    if pool.fetches != len(distinct) \
            or sorted(calls) != [f"{key}@{dev}" for key in distinct] \
            or sum(calls.values()) != real or real == 0 or errors:
        raise AssertionError(f"fleet: {pool.fetches} fetches of {distinct},"
                             f" session calls {calls} (want {real} in "
                             f"all), agent errors {errors}")
    for name in ("flash_prefill", "qmatmul_dynamic", "qmatmul_static"):
        if launches[name] <= 0:
            raise AssertionError(f"fleet rollout: {name} never launched "
                                 f"({launches})")
    return launches, sim


def fleet_engines(k, dev, registry, pool, cfg, prompts, variant_of, floor):
    """Per device class a paged engine from the pool at ``fleet_bench``'s
    KV fraction (5 blocks' bytes of the lite class's RAM) over the
    shared-prefix prompts; the std class again at tp=2; the pi4 class's
    router. Streams held to ``generate`` (``_partings``, each int8
    variant's steps given at least ``floor``: the dynamic-int8 forward's
    nudge). Returns the launch totals."""
    from repro_torch.fleet.simulator import DEVICE_CLASSES
    from repro_torch.serving.kvcache import kv_bytes_per_block

    profiles = {cls: profile for cls, profile, _, _ in DEVICE_CLASSES}
    refs = {cls: registry.ref("vqi", "v1", variant_of[cls])
            for cls in profiles}
    sessions = {cls: pool.session(refs[cls], dev) for cls in profiles}
    base = {cls: [s.generate({"tokens": p.to(dev)}, FLEET_NEW)[0].tolist()
                  for p in prompts] for cls, s in sessions.items()}
    frac = 5.0 * kv_bytes_per_block(cfg, FLEET_BLOCK) / profiles[
        "lite"].memory_bytes
    geometry = {"kv_fraction": frac, "n_slots": 2, "max_len": 32,
                "block_size": FLEET_BLOCK}
    trace = types.SimpleNamespace(requests=[
        types.SimpleNamespace(tokens=p) for p in prompts])
    gemm = {"fp32": None, "static_int8": "qmatmul_static",
            "dynamic_int8": "qmatmul_dynamic"}
    totals, rows = {}, {}

    def serve(where, engine, cls):
        (streams, em), ms, launches = _counted(
            k, torch.float32, where, lambda: _fleet_serve(engine, prompts))
        _merge(totals, launches)
        s = sessions[cls]
        parted = _partings(s.params, s.cfg, trace, base[cls], streams, dev,
                           {}, floor=0.0 if variant_of[cls] == "fp32"
                           else floor)
        if not all(p["ok"] for p in parted):
            raise AssertionError(f"{where}: streams part from generate "
                                 f"beyond a tie: {parted}")
        return em, ms, launches, parted

    for cls, profile in profiles.items():
        variant = variant_of[cls]
        engine = pool.serving_engine(refs[cls], dev, profile, **geometry)
        (em, ms, launches, parted), busy, kernels = _busy(
            lambda: serve(f"fleet/{cls}", engine, cls))
        rows[cls] = {
            "variant": variant,
            "budget_bytes": pool.kv_budget_bytes(profile, frac),
            "usable_blocks": engine.kv.alloc.usable_blocks,
            "bytes_per_block": engine.kv.bytes_per_block,
            "completed": em["completed"], "preempted": em["preempted"],
            "prefix_hit_rate": em["prefix_hit_rate"],
            "kv_blocks_peak": em["kv_blocks_peak"],
            "decode_steps": em["decode_steps"], "serve_ms": ms,
            "host_ms_per_step": ms / max(em["decode_steps"], 1),
            "device_busy_ms": busy, "kernels": kernels,
            "streams_equal_generate": len(prompts) - len(parted),
            "nudge_floor": 0.0 if variant == "fp32" else floor,
            "partings": parted, "launches": launches}
        emit("fleet_class_engine", cls=cls, **rows[cls])
        others = {name for name in gemm.values() if name} - {gemm[variant]}
        if em["completed"] != len(prompts) or launches["paged_decode"] <= 0 \
                or any(launches[name] for name in others) \
                or (gemm[variant] and launches[gemm[variant]] <= 0):
            raise AssertionError(f"fleet/{cls}: {rows[cls]}")
    if not (rows["lite"]["usable_blocks"] < rows["std"]["usable_blocks"]
            and rows["lite"]["preempted"] >= rows["std"]["preempted"]):
        raise AssertionError(f"fleet: lite against std {rows}")

    # the std class at tp=2: both shards on the card
    engine = pool.serving_engine(refs["std"], dev, profiles["std"], tp=2,
                                 **geometry)
    em, ms, launches, parted = serve("fleet/std/tp2", engine, "std")
    by_tp = {row["tp"]: row for key, row in pool.memory_report().items()
             if "/router" not in key and "/edge-standard/" in key}
    emit("fleet_tp2", cls="std", completed=em["completed"], serve_ms=ms,
         decode_steps=em["decode_steps"],
         bytes_per_block_per_shard={tp: r["bytes_per_block_per_shard"]
                                    for tp, r in by_tp.items()},
         usable_blocks={tp: r["n_blocks"] for tp, r in by_tp.items()},
         streams_equal_generate=len(prompts) - len(parted),
         partings=parted, launches=launches)
    if sorted(by_tp) != [1, 2] or 2 * by_tp[2]["bytes_per_block_per_shard"] \
            != by_tp[1]["bytes_per_block_per_shard"] \
            or em["completed"] != len(prompts) \
            or launches["paged_decode"] <= 0:
        raise AssertionError(f"fleet tp=2: {by_tp}, {launches}")

    # the pi4 class's router: 1 prefill + 2 decode workers on one pool
    router = pool.request_router(refs["pi4"], dev, profiles["pi4"],
                                 kv_fraction=frac, max_len=32,
                                 block_size=FLEET_BLOCK)
    _, ms, launches, parted = serve("fleet/pi4/router", router, "pi4")
    rm = router.metrics()
    emit("fleet_router", cls="pi4", serve_ms=ms, router_metrics=rm,
         streams_equal_generate=len(prompts) - len(parted),
         partings=parted, launches=launches)
    if rm["decode_prompt_tokens_recomputed"] != 0 \
            or rm["router_completed"] != len(prompts):
        raise AssertionError(f"fleet router: {rm}")
    emit("fleet_memory", report=pool.memory_report())
    return totals


def fleet_card_vs_cpu(registry, pool, batch, dev):
    """One forward of each v1 variant through the pool's shared session on
    the card against the same artifact's forward on the CPU (its params
    copied to the host), within 2.5x
    the card's own one-rounding nudge (``nudged_norms``: what flipped int8
    activation codes do) or CPU_TOL["fp32"] where that is larger (the f32
    summation order every variant shares, which sets the fp32 bound of
    every card-vs-CPU check here: a static-int8 forward's nudge can be 0
    when no code sits at a rounding boundary). Returns each variant's
    nudge."""
    from repro_torch.serving import InferenceSession

    host = {key: t.cpu() for key, t in batch.items()}
    nudges = {}
    for variant in registry.variants("vqi", "v1"):
        ref = registry.ref("vqi", "v1", variant)
        session = pool.session(ref, dev)
        with torch.no_grad():
            card = session.logits(batch).cpu()
            with nudged_norms():
                nudged = session.logits(batch).cpu()
        art = pool.artifact(ref, dev)
        cpu = InferenceSession(art.params, art.config,
                               device="cpu").logits(host)
        err = float((card - cpu).abs().max())
        nudge = float((nudged - card).abs().max())
        bound = max(2.5 * nudge, CPU_TOL["fp32"][0])
        emit("fleet_card_vs_cpu", variant=variant, shape=list(card.shape),
             max_abs_err=err, card_nudge=nudge, bound=bound,
             logit_scale=float(cpu.abs().max()), ok=err <= bound)
        if not err <= bound:
            raise AssertionError(f"fleet card vs CPU ({variant}): {err} > "
                                 f"{bound}")
        nudges[variant] = nudge
    return nudges


def fleet_phase(k, dev):
    """stablelm-1.6b at published width and LIFECYCLE_LAYERS layers in f32
    (as the JAX example and ``fleet_bench`` publish it) on random seeded
    weights: v1 and v2 published with the example's three variants into a
    registry under ``build/``, each variant's bytes printed against each
    device class's memory; ``fleet_rollout`` (FLEET_DEVICES devices on the
    card, v1 completes, v2 aborts and rolls back, every FLEET_REAL_EVERY-th
    inspection a real [2, 64] forward through the shared sessions),
    ``fleet_card_vs_cpu``, ``fleet_engines`` (the per-class paged engines,
    tp=2, the router), then the serving launcher on the fp32 artifact's
    checkpoint (``--quant dynamic_int8 --requests 16``). The pool,
    its artifacts and engines are dropped before returning. Returns the
    launch totals."""
    import gc
    import tempfile

    from repro_torch import configs
    from repro_torch.api import ArtifactRegistry, Deployment, ModelArtifact
    from repro_torch.fleet.simulator import (DEVICE_CLASSES, EnginePool,
                                             profile_variant_policy)
    from repro_torch.launch import serve
    from repro_torch.models import init_params

    ex = _fleet_example()
    published = configs.get_config("stablelm-1.6b")
    cfg = published.with_overrides(n_layers=LIFECYCLE_LAYERS,
                                   dtype="float32")
    gen = torch.Generator().manual_seed(SEED + 101)
    calib = [{"tokens": torch.randint(0, cfg.vocab_size, FLEET_REAL_BATCH,
                                      generator=gen).to(dev)}
             for _ in range(2)]
    batch = {"tokens": torch.randint(0, cfg.vocab_size, FLEET_REAL_BATCH,
                                     generator=gen).to(dev)}
    prefix = torch.randint(0, cfg.vocab_size, (1, 8), generator=gen)
    prompts = [torch.cat([prefix, torch.randint(0, cfg.vocab_size, (1, 4),
                                                generator=gen)], dim=1)
               for _ in range(FLEET_PROMPTS)]
    variant_of = {cls: profile_variant_policy(
        types.SimpleNamespace(profile=profile))
        for cls, profile, _, _ in DEVICE_CLASSES}
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as root:
        registry = ArtifactRegistry(root)
        dep = Deployment(registry, model="vqi")
        params = init_params(cfg, seed=SEED + 100)
        t0 = time.perf_counter()
        for version in ("v1", "v2"):
            dep.publish(ModelArtifact.create("vqi", version, params, cfg),
                        ex.SPECS, calib_data=calib)
        torch.cuda.synchronize()
        publish_s = time.perf_counter() - t0
        del params, calib
        torch.cuda.empty_cache()
        sizes = {v: registry.ref("vqi", "v1", v).size_bytes
                 for v in registry.variants("vqi", "v1")}
        admits = {cls: {v: profile.admits(registry.ref("vqi", "v1", v))
                        or "admitted" for v in sizes}
                  for cls, profile, _, _ in DEVICE_CLASSES}
        emit("fleet_sizes", model=cfg.name, layers=cfg.n_layers,
             published_layers=published.n_layers,
             d_model=cfg.d_model, dtype=cfg.dtype, size_bytes=sizes,
             class_memory_bytes={cls: p.memory_bytes
                                 for cls, p, _, _ in DEVICE_CLASSES},
             class_variant=variant_of, admits=admits, publish_s=publish_s)
        refused = {cls: admits[cls][v] for cls, v in variant_of.items()
                   if admits[cls][v] != "admitted"}
        if refused:
            raise AssertionError(f"fleet: a class refuses its variant: "
                                 f"{refused}")
        pool = EnginePool(registry)
        totals, sim = fleet_rollout(k, dev, registry, dep, pool, batch,
                                    sizes, variant_of)
        del sim
        nudges = fleet_card_vs_cpu(registry, pool, batch, dev)
        _merge(totals, fleet_engines(k, dev, registry, pool, cfg, prompts,
                                     variant_of, nudges["dynamic_int8"]))
        ckpt = registry._index[registry.ref("vqi", "v1", "fp32").key]["dir"]
        argv = ["--arch", cfg.name, "--checkpoint", ckpt, "--quant",
                "dynamic_int8", "--requests", "16"]
        reqs, ms, launches = _counted(k, torch.float32, "fleet/serve",
                                      lambda: serve.main(argv))
        _merge(totals, launches)
        emit("fleet_serve_launcher", argv=argv[2:], requests=len(reqs),
             served=sum(r.done for r in reqs), ms=ms, launches=launches)
        if len(reqs) != 16 or not all(r.done for r in reqs) \
                or launches["qmatmul_dynamic"] <= 0:
            raise AssertionError(f"fleet serve launcher: {launches}")
        del reqs, pool, dep, registry
        gc.collect()
        torch.cuda.empty_cache()
    emit("fleet_launches", launches={name: totals.get(name, 0)
                                     for name in _wrappers(k)},
         peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    wrong = {name: totals.get(name, 0) for name in _wrappers(k)
             if (totals.get(name, 0) > 0) != (name in FLEET_KERNELS)}
    if wrong:
        raise AssertionError(f"fleet launches: {wrong} (want > 0 exactly "
                             f"for {FLEET_KERNELS})")
    return totals


# ------------------------------------------------------------------ #
# Phase 20: every shape the main paths gave a kernel, against plain
# ------------------------------------------------------------------ #
def _flash_key(kernel, q, k, dv):
    # (B, S, Hq, Hkv, hd, dv, dtype), as FLASH_SHAPES, then the tile the
    # cuda leg resolves for the call
    from repro_torch.api import get_backend

    b, s, hq, hd = q.shape
    return (b, s, hq, k.shape[2], hd, dv, q.dtype,
            get_backend("cuda").flash_tile(kernel, q))


def _gemm_key(x, n):
    # (M, K, N, x dtype) of an x [M, K]
    return (*x.shape, n, x.dtype)


def _qdecode_key(q, k):
    # (B, S, Hkv, G, hd, q dtype), as QDECODE_SHAPES
    b, hkv, g, hd = q.shape
    return (b, k.shape[1], hkv, g, hd, q.dtype)


def _paged_key(q, pool, tables):
    # (B, Hkv, G, hd, block size, table entries, pool blocks, q dtype,
    # pool dtype), as PAGED_SHAPES
    return (*q.shape, pool.shape[1], tables.shape[1], pool.shape[0], q.dtype,
            pool.dtype)


#: flash kernel -> {"<body>:<block_q>x<block_k>": calls} that the cuda legs
#: resolved since the last ``reset_counters`` (``recording_shapes`` counts
#: them; ``read_counters`` holds each prefill's launches per tile to them)
RESOLVED_TILES = {}
_RESOLVED_LOCK = threading.Lock()


def _resolve_count(kernel, key, q, k, v):
    """One call of ``kernel`` at ``key`` (``_flash_key``'s; q, k, v its
    first three arguments) counted in RESOLVED_TILES with the body it
    takes, where the backend in scope launches the CUDA kernels (``cuda``
    or a twin of it)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.api import current_backend
    from repro_torch.kernels import flash_prefill as fp

    backend = current_backend()
    if getattr(backend, "inner", backend).name != "cuda":
        return
    if kernel == "flash_prefill":
        local = [t.to_local() if isinstance(t, DTensor) else t
                 for t in (q, k, v)]
        body = fp.body_for(*local)
    else:
        body = (fp.QBODY if kernel == "flash_qprefill" else fp.Q4BODY)[
            q.dtype]
    tile = f"{body}:{key[7][0]}x{key[7][1]}"
    with _RESOLVED_LOCK:
        tiles = RESOLVED_TILES.setdefault(kernel, {})
        tiles[tile] = tiles.get(tile, 0) + 1


@contextlib.contextmanager
def recording_shapes(seen):
    """Records into ``seen`` (kernel name -> set of shape keys) the shape of
    every call that the model code makes through ``kernels.ops`` to the
    flash prefills (with the tile the cuda leg resolves, also counted in
    RESOLVED_TILES), the dense and paged decodes and the int8 GEMMs; the
    wrappers and their counters are left as they are."""
    from repro_torch.kernels import ops

    keys = {"flash_prefill": lambda q, k, v: (
                "flash_prefill", _flash_key("flash_prefill", q, k,
                                            v.shape[-1])),
            "flash_qprefill": lambda q, k, ks, v, vs: (
                "flash_qprefill", _flash_key("flash_qprefill", q, k,
                                             v.shape[-1])),
            # int4 V: two codes a byte
            "flash_q4prefill": lambda q, k, ks, v, vs: (
                "flash_q4prefill", _flash_key("flash_q4prefill", q, k,
                                              2 * v.shape[-1])),
            "qmatmul_dynamic": lambda x, w, *a, **kw: (
                "qmatmul_dynamic", _gemm_key(x, w.shape[1])),
            "qmatmul_static": lambda x, w, *a, **kw: (
                "qmatmul_static", _gemm_key(x, w.shape[1])),
            # a packed weight is [N, Kp]
            "qmatmul_packed": lambda x, w, s, act_scale=None, **kw: (
                "qmatmul_dynamic" if act_scale is None else "qmatmul_static",
                _gemm_key(x, w.shape[0])),
            "qdecode": lambda q, k, ks, v, vs, bias: (
                "qdecode", _qdecode_key(q, k)),
            "paged_decode": lambda q, kp, vp, tables, pos: (
                "paged_decode", _paged_key(q, kp, tables)),
            "paged_qdecode": lambda q, kp, ks, vp, vs, tables, pos: (
                "paged_qdecode", _paged_key(q, kp, tables)),
            "paged_q4decode": lambda q, kp, ks, vp, vs, tables, pos: (
                "paged_q4decode", _paged_key(q, kp, tables))}
    saved = {name: getattr(ops, name) for name in keys}

    def recorder(name):
        def call(*args, **kw):
            kernel, key = keys[name](*args, **kw)
            seen.setdefault(kernel, set()).add(key)
            if kernel.startswith("flash_"):
                _resolve_count(kernel, key, *args[:3])
            return saved[name](*args, **kw)
        return call
    try:
        for name in keys:
            setattr(ops, name, recorder(name))
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def held_paged(k, name, key, gen, dev):
    """One paged decode of ``key`` (as ``_paged_key``) on random q and pools
    against its plain version: positions drawn so every table fits the
    pool, the last row idle when B > 1 (its output NaN on both sides).
    Returns max |err| over the live rows."""
    b, hkv, g, hd, bs, m, n, qdt, pdt = key
    hi = min(m, (n - 1) // b) * bs - 1
    pos = torch.randint(min(36, hi), hi + 1, (b,), generator=gen).tolist()
    if b > 1:
        pos[-1] = -1
    q, kp, vp, tables, pos_t, live = paged_case(
        dev, gen, (b, hkv, g, hd, bs, m, n, pdt, tuple(pos)))
    q = q.to(qdt)
    if name == "paged_decode":
        pools, atol = (kp, vp), PAGED_ATOL
    else:
        codes = int8_codes if name == "paged_qdecode" else int4_codes
        pools, atol = (*codes(gen, tuple(kp.shape), dev),
                       *codes(gen, tuple(vp.shape), dev)), INT8KV_ATOL
    got = getattr(k.paged_attn, name)(q, *pools, tables, pos_t)
    want = getattr(k.ref, f"{name}_ref")(q, *pools, tables, pos_t)
    err = float((got[live] - want[live]).abs().max())
    idle_nan = bool(got[~live].isnan().all()) and bool(
        want[~live].isnan().all())
    if not torch.isfinite(got[live]).all() or err > atol or not idle_nan:
        raise AssertionError(f"{name} {key}: max |err| {err} > {atol} or "
                             "idle rows not 0/0")
    return err


def held_shapes_phase(k, dev, seen):
    """Every flash-prefill, qdecode, paged-decode and int8-GEMM shape that
    the main paths gave a kernel (``recording_shapes``), held against the
    plain version on random inputs of that shape and dtype, a flash prefill
    at the tile the ``cuda`` leg resolved for it. Shapes the kernel phases
    already held (TILE_SHAPES and MLA_FLASH at every tile, QDECODE_SHAPES,
    PAGED_SHAPES, GEMM_CASES at bf16 activations) are counted; the rest run
    here, at the kernel phases' tolerances: flash FLASH_ATOL, paged fp
    PAGED_ATOL, int8 / int4 K/V INT8KV_ATOL, GEMMs rtol 1e-6."""
    ref, fp, qm, dq = k.ref, k.flash_prefill, k.qmatmul, k.dynquant
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    cpu_gen = torch.Generator().manual_seed(SEED + 41)
    gemm_held = {(m, kk, n, torch.bfloat16) for kk, n, ms in GEMM_CASES
                 for m in ms}
    codes = {"flash_qprefill": int8_codes, "flash_q4prefill": int4_codes}
    qdecode_held = {shape[:6] for shape in QDECODE_SHAPES.values()}
    paged = ("paged_decode", "paged_qdecode", "paged_q4decode")
    paged_held = {name: {(*shape[:8], shape[7] if name == "paged_decode"
                          else torch.int8)
                         for shape in PAGED_SHAPES.values()}
                  for name in paged}
    summary = {}
    for name in sorted(seen):
        keys = sorted(seen[name], key=str)
        gemm = name.startswith("qmatmul")
        held = (gemm_held if gemm else qdecode_held if name == "qdecode"
                else paged_held[name] if name in paged
                else TILE_SHAPES + (MLA_FLASH,))
        flash = name.startswith("flash_")     # its key ends in the tile
        new = [key for key in keys if (key[:7] if flash else key) not in held]
        worst = 0.0
        for key in new:
            if name in paged:
                worst = max(worst, held_paged(k, name, key, cpu_gen, dev))
                continue
            if name == "qdecode":
                b, s, hkv, g, hd, dt = key
                q = torch.randn((b, hkv, g, hd), generator=cpu_gen).to(dev, dt)
                kv = [*int8_codes(cpu_gen, (b, s, hkv, hd), dev),
                      *int8_codes(cpu_gen, (b, s, hkv, hd), dev)]
                pos = torch.randint(0, s, (b, 1), generator=cpu_gen).to(dev)
                bias = torch.where(torch.arange(s, device=dev)[None] <= pos,
                                   torch.zeros((), device=dev),
                                   torch.full((), -2.0e38, device=dev))
                got = k.qdecode.qdecode(q, *kv, bias)
                want = ref.qdecode_ref(q, *kv, bias)
                err = float((got - want).abs().max())
                if not torch.isfinite(got).all() or err > INT8KV_ATOL:
                    raise AssertionError(f"qdecode {key}: max |err| {err} > "
                                         f"{INT8KV_ATOL}")
            elif gemm:
                m, kk, n, dt = key
                w = torch.randint(-127, 128, (kk, n), generator=gen,
                                  device=dev, dtype=torch.int8)
                ws = torch.rand((1, n), generator=gen, device=dev) * 1e-3 \
                    + 1e-5
                x = (torch.randn((m, kk), generator=gen, device=dev)
                     * 2).to(dt)
                wp = qm.pack_weight(w)
                if name == "qmatmul_dynamic":
                    got = dq.qmatmul_dynamic_packed(x, wp, ws)
                    want = ref.qmatmul_dynamic_ref(x, w, ws)
                else:
                    act = (x.float().abs().amax() / 127.0).reshape(())
                    got = qm.qmatmul_static_packed(x, wp, ws, act)
                    want = ref.qmatmul_static_ref(x, w, ws, act)
                torch.testing.assert_close(got, want, rtol=1e-6, atol=0,
                                           msg=lambda m, key=key: f"{name} "
                                           f"{key}: {m}")
                del w, wp
            else:
                b, s, hq, hkv, hd, dv, dt, (bq, bk) = key
                q = torch.randn((b, s, hq, hd), generator=gen,
                                device=dev).to(dt)
                if name == "flash_prefill":
                    kv = [torch.randn((b, s, hkv, d), generator=gen,
                                      device=dev).to(dt) for d in (hd, dv)]
                    got = fp.flash_prefill(q, *kv, block_q=bq, block_k=bk)
                    want, atol = ref.flash_prefill_ref(q, *kv), FLASH_ATOL
                else:
                    kv = [*codes[name](cpu_gen, (b, s, hkv, hd), dev),
                          *codes[name](cpu_gen, (b, s, hkv, dv), dev)]
                    got = getattr(fp, name)(q, *kv, block_q=bq, block_k=bk)
                    want = getattr(ref, f"{name}_ref")(q, *kv)
                    atol = INT8KV_ATOL
                err = float((got - want).abs().max())
                if not torch.isfinite(got).all() or err > atol:
                    raise AssertionError(f"{name} {key}: max |err| {err} > "
                                         f"{atol}")
            worst = max(worst, float((got - want).abs().max()))
            del got, want
        if flash:
            summary[f"{name}_tiles"] = {
                f"{t[0]}x{t[1]}": sum(key[7] == t for key in keys)
                for t in sorted({key[7] for key in keys})}
        summary[name] = {"shapes": len(keys),
                         "held_by_kernel_phases": len(keys) - len(new),
                         "held_here": len(new), "max_abs_err_here": worst,
                         "here": [[str(v) for v in key] for key in new]}
    torch.cuda.empty_cache()
    emit("held_shapes", **summary)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs one GPU",
              file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, src)
    procs = {}
    try:
        return _main(procs)
    finally:
        production_stop(procs)


def _main(procs) -> int:
    from repro_torch.kernels import (_build, autotune, dynquant,
                                     flash_prefill, paged_attn, qdecode,
                                     qmatmul, quantize, ref)

    k = types.SimpleNamespace(ref=ref, qmatmul=qmatmul, dynquant=dynquant,
                              flash_prefill=flash_prefill, autotune=autotune,
                              paged_attn=paged_attn, qdecode=qdecode,
                              quantize=quantize, ptxas={})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    smi = gpu_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    # the host's dry-run subprocesses overlap the card phases from here
    procs.update(production_start())
    ptxas = {n: sorted({ln.split(":", 1)[-1].strip()
                        for ln in log.splitlines() if "Used" in ln
                        or ("spill" in ln and " 0 bytes spill stores" not in ln)})
             for n, log in _build.BUILD_LOG.items()}
    # kernel instantiation -> (registers, spill st, spill ld)
    filt = os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
    for log in _build.BUILD_LOG.values():
        k.ptxas.update(ptxas_kernels(log, filt))
    spilled = sorted(name for name, (_, st, ld) in k.ptxas.items()
                     if st or ld)
    emit("card", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=build_s, ptxas=ptxas,
         ptxas_redesigned={name: k.ptxas[name] for name in sorted(k.ptxas)
                           if "flash_q" in name or "_split" in name
                           or "qdecode_wide" in name or "flash_mla" in name
                           or name.startswith(("quantize_cluster",
                                               "quantize_cols"))
                           or "flash_tc<" in name},
         ptxas_spilled=spilled)

    timer = Timer(dev)
    one = torch.zeros(1, device=dev)
    emit("timer", floor_ms=timer.graph_ms(lambda: one.add_(1), iters=20),
         what="one 1-element kernel timed as every kernel row is")
    heads = gemm_phase(k, dev, timer)
    heads["flash_prefill"], heads["flash_prefill_mla"] = flash_phase(
        k, dev, timer)
    heads["paged_decode"] = paged_phase(k, dev, timer)
    heads["qdecode"], heads["qdecode_wide"] = qdecode_phase(k, dev, timer)
    heads["paged_qdecode"] = paged_qdecode_phase(k, dev, timer)
    heads["flash_qprefill"] = flash_qprefill_phase(k, dev, timer)
    heads["paged_q4decode"] = paged_q4decode_phase(k, dev, timer)
    heads["flash_q4prefill"] = flash_q4prefill_phase(k, dev, timer)
    # every tile of the three flash bodies, then the environment pin and
    # the refusal of a pair no body instantiates
    tile_rows = tiles_phase(k, dev, timer)
    tile_pins_check(k, dev)
    quantize_int4_phase(k, dev)
    heads["quantize_weights"] = quantize_weights_phase(k, dev, timer)
    del timer
    torch.cuda.empty_cache()
    # every main path below records the shapes it gives the flash
    # prefills and the int8 GEMMs; held_shapes_phase holds each one
    seen = {}
    with recording_shapes(seen):
        # launches: the queue runs, plus the paged replays for paged_decode
        # and every quantized-KV replay for the quantized-KV kernels
        totals = e2e_phase(k, dev)
        paged_totals, all_totals, streams = engine_phase(k, dev)
        totals["paged_decode"] = paged_totals["paged_decode"]
        for name in ("qdecode", "paged_qdecode", "flash_qprefill",
                     "paged_q4decode", "flash_q4prefill",
                     *(f"qdecode.class.{c}"
                       for c in k.qdecode.qdecode.launches_by_class),
                     *(f"flash_qprefill.{body}"
                       for body in k.flash_prefill.QBODY.values()),
                     *(f"flash_q4prefill.{body}"
                       for body in k.flash_prefill.Q4BODY.values()),
                     *(f"{name}.tile.{t}"
                       for name in ("flash_qprefill", "flash_q4prefill")
                       for t in _flash(k)[name].launches_by_tile)):
            totals[name] = totals.get(name, 0) + all_totals[name]
        paged_vs_dense_phase(dev, streams)
        # the backend registry: cuda and ref sessions over one artifact,
        # a cuda-tp engine, a spec engine with a ref draft
        _merge(totals, backends_phase(k, dev))
        card_vs_cpu_phase(dev, paged=False)
        card_vs_cpu_phase(dev, paged=True)
        # the VQI paths through the registry: the inspection queue at full
        # depth, then the lifecycle at 2 layers; quantize_weights is on
        # neither (artifacts are built by quantize_tensor, as in the JAX
        # package), so it counts 0
        totals["quantize_weights"] = 0
        totals.update({f"quantize_weights.{route}": 0
                       for route in k.quantize.ROUTES})

        _merge(totals, vqi_phase(k, dev))
        _merge(totals, lifecycle_phase(k, dev))
        vqi_card_vs_cpu_phase(dev)
        # training at full width and depth (flash_prefill under autograd:
        # the forward and the recompute), then the paper's loop at
        # vqi_config()
        _merge(totals, train_phase(k, dev))
        _merge(totals, production_phase(k, dev, procs))
        _merge(totals, vqi_loop_phase(k, dev))
        # the dense model's and quantization's remaining modules, then
        # speculative decoding on them
        for phase in (chunked_phase, dense_configs_phase, quant_modes_phase,
                      spec_phase):
            _merge(totals, phase(k, dev))
        # the MoE and MLA models at published width (the flash prefill's
        # 192 / 128 class)
        _merge(totals, moe_mla_phase(k, dev))
        # the recurrent models at published width (qdecode's wide class)
        _merge(totals, recurrent_phase(k, dev))
        # the last architecture (musicgen's codebooks), frontend requests
        # in the engines, then the router over prefill and decode workers
        for phase in (musicgen_phase, frontend_phase, router_phase):
            _merge(totals, phase(k, dev))
        # tensor-parallel serving: two shards on the card
        tp_totals, tp_by = tp_phase(k, dev, seen)
        _merge(totals, tp_totals)
        # the fleet simulator's EnginePool: the per-class engines, tp=2,
        # the router and the serving launcher over published artifacts
        fleet_totals = fleet_phase(k, dev)
        _merge(totals, fleet_totals)
    held_shapes_phase(k, dev, seen)

    sources = {"flash_prefill": ("src/repro_torch/csrc/flash_prefill.cu",
                                 "src/repro/kernels/flash_prefill.py:244"),
               "qmatmul_dynamic": ("src/repro_torch/csrc/qmatmul.cu",
                                   "src/repro/kernels/dynquant.py:36"),
               "qmatmul_static": ("src/repro_torch/csrc/qmatmul.cu",
                                  "src/repro/kernels/qmatmul.py:42"),
               "paged_decode": ("src/repro_torch/csrc/paged_attn.cu",
                                "src/repro/kernels/paged_attn.py:186"),
               "qdecode": ("src/repro_torch/csrc/qdecode.cu",
                           "src/repro/kernels/qdecode.py:48"),
               "paged_qdecode": ("src/repro_torch/csrc/paged_attn.cu",
                                 "src/repro/kernels/paged_attn.py:196"),
               "flash_qprefill": ("src/repro_torch/csrc/flash_prefill.cu",
                                  "src/repro/kernels/flash_prefill.py:267"),
               "paged_q4decode": ("src/repro_torch/csrc/paged_attn.cu",
                                  "src/repro/kernels/paged_attn.py:207"),
               "flash_q4prefill": ("src/repro_torch/csrc/flash_prefill.cu",
                                   "src/repro/kernels/flash_prefill.py:295"),
               "quantize_weights": ("src/repro_torch/csrc/quantize_weights.cu",
                                    "src/repro/kernels/quantize.py:96")}
    kernels = []
    for name, (src_path, replaces) in sources.items():
        h = heads[name]
        shape = {key: h[key] for key in ("M", "K", "N", "B", "S", "Hq", "Hkv",
                                         "G", "hd", "dv", "bs", "dtype",
                                         "kv", "pools")
                 if key in h}
        kernels.append({"name": name, "route": "cuda", "source": src_path,
                        "replaces": replaces, "launches": totals[name],
                        "max_abs_err": h["max_abs_err"], "ms": h["ms"],
                        "eager_ms": h["eager_ms"],
                        "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
                        "bound_by": h["bound_by"],
                        "library_ms": h["library_ms"], "shape": shape,
                        "launches_tp": {f"tp{tp}": tp_by[tp].get(name, 0)
                                        for tp in (1, 2)},
                        "launches_fleet": fleet_totals.get(name, 0)})
        if name in _flash(k):
            kernels[-1]["body"] = h["body"]
            kernels[-1]["launches_by_body"] = {
                body: totals[f"{name}.{body}"]
                for body in read_bodies(k, name)}
            by_tile = {t: totals.get(f"{name}.tile.{t}", 0)
                       for t in _flash(k)[name].launches_by_tile}
            if sum(by_tile.values()) != totals[name]:
                raise AssertionError(f"{name}: launches by tile {by_tile} "
                                     f"do not sum to {totals[name]}")
            kernels[-1]["launches_by_tile"] = by_tile
            # the tile sweep: per shape the analytic winner, (64, 64) and
            # the fastest candidate, ms each
            kernels[-1]["tiles"] = [
                {key: row[key] for key in ("B", "S", "Hq", "Hkv", "hd", "dv",
                                           "dtype", "winner", "winner_ms",
                                           "default", "default_ms",
                                           "fastest", "fastest_ms")}
                for row in tile_rows[name]]
        if name == "flash_prefill":
            kernels[-1]["launches_by_class"] = {
                c: totals.get(f"flash_prefill.class.{c}", 0)
                for c in k.flash_prefill.CLASSES}
            kernels[-1]["mla_class"] = heads["flash_prefill_mla"]
        if name == "qdecode":
            kernels[-1]["launches_by_class"] = {
                c: totals.get(f"qdecode.class.{c}", 0)
                for c in k.qdecode.qdecode.launches_by_class}
            kernels[-1]["wide_class"] = dict(
                heads["qdecode_wide"],
                launches=totals.get("qdecode.class.wide", 0))
        if name in ("paged_decode", "paged_q4decode"):
            kernels[-1]["body"] = h["body"]
        if name == "quantize_weights":
            kernels[-1]["plan"] = h["plan"]
            kernels[-1]["launches_by_route"] = {
                route: totals[f"quantize_weights.{route}"]
                for route in k.quantize.ROUTES}
            kernels[-1]["compare_launches_by_route"] = h[
                "compare_launches_by_route"]
        if name in _gemms(k):
            kernels[-1]["body"] = h["body"]
            kernels[-1]["bf16_library_ms"] = h["bf16_library_ms"]
            kernels[-1]["launches_by_body"] = {
                body: totals[f"{name}.{body}"] for body in k.qmatmul.BODIES}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
