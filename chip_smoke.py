#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/csrc`` (into ``build/``) and
prints one JSON line per phase:

1. card: ``nvidia-smi`` name and power limit, kernel build time;
2. kernels: each CUDA kernel against its plain PyTorch version on the card
   at the main paths' shapes, with its time (a CUDA-graph replay: device
   time; and the eager call, launch gaps included), the plain version's
   time, its bound and a library yardstick's time (timed here only, never
   used by the port);
3. e2e: stablelm-1.6b at full width in bf16 with random seeded weights, the
   three default variants (fp32 passthrough, dynamic int8, static int8
   calibrated on 2 batches of 2 x 128 tokens), 4 requests served through a
   RequestQueue -> InferenceSession.generate, with every kernel's launch
   counter zeroed before and read after;
4. engine: stablelm-1.6b at full width in bf16 behind the paged
   ContinuousBatchingEngine (8 slots, 16-token blocks, a 65-block pool
   small enough to preempt) and then the dense one, replaying a seeded
   trace of 16 greedy requests (4 share a 128-token prefix) through
   ``loadgen.replay``, for the fp32-passthrough and dynamic-int8 variants,
   with every kernel's launch counter zeroed before each replay and read
   after it, plus a timed and profiled window of batched decode steps;
5. card vs CPU: the same fp32 weights at full width and 2 layers, the CPU's
   plain path against the card's kernel path on one prompt plus 8
   teacher-forced decode steps, dense and then paged (a block table with
   scattered ids and a -1 tail);
6. a ``kernels`` line, the ``nvidia-smi`` line, and last the device line.

Any failed check raises and the exit code is non-zero. Without a CUDA
device, or outside the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import types

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0

# H100 SXM published peaks (dense): HBM bytes/s and operations/s by type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"int8": 1979e12, "bfloat16": 989e12, "float32": 67e12}

GEMM_MS = (4, 1024, 1023)
GEMM_KN = ((2048, 2048), (2048, 11264), (5632, 2048), (2048, 100352))
HEADLINE_GEMM = (4, 2048, 11264)          # a decode GEMM (wi of one layer)
# (B, S, Hq, Hkv, hd, dv, dtype)
FLASH_SHAPES = ((4, 256, 32, 32, 64, 64, torch.bfloat16),
                (2, 300, 32, 8, 128, 128, torch.bfloat16),
                (2, 200, 16, 16, 128, 64, torch.bfloat16),
                (1, 64, 32, 32, 64, 64, torch.float32))
HEADLINE_FLASH = FLASH_SHAPES[0]
FLASH_ATOL = 1e-4     # f32 on both sides; summation order differs
# paged decode: (B, Hkv, G, hd, block size, table entries, pool blocks,
# pool dtype, positions: None = drawn in 36..511, idle rows have -1)
PAGED_SHAPES = {
    "a": (8, 32, 1, 64, 16, 32, 257, torch.bfloat16, None),   # stablelm
    "b": (8, 8, 4, 128, 16, 32, 257, torch.bfloat16, None),   # nemo width
    "c": (1, 32, 1, 64, 16, 32, 257, torch.bfloat16, (511,)),
    "d": (8, 32, 1, 64, 16, 32, 257, torch.float32, None),
    "e": (4, 32, 1, 64, 16, 32, 257, torch.bfloat16, (300, -1, 45, 511)),
}
HEADLINE_PAGED = "a"
PAGED_ATOL = 1e-4     # f32 on both sides; online vs one-pass softmax
# the engine phase: a pool of 64 usable 16-token blocks (1024 tokens) for
# 8 slots whose requests average ~146 + 32 tokens, so preemption happens
ENGINE = {"n_slots": 8, "max_len": 512}
PAGED = {"paged": True, "block_size": 16, "n_blocks": 65}
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
CPU_TOL = {"fp32": (2e-3, 2e-4), "dynamic_int8": (0.2, 0.03)}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


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


def reset_counters(k):
    for fn in (k.flash_prefill.flash_prefill, k.dynquant.qmatmul_dynamic,
               k.qmatmul.qmatmul_static, k.paged_attn.paged_decode):
        fn.launches = 0


def read_counters(k):
    return {"flash_prefill": k.flash_prefill.flash_prefill.launches,
            "qmatmul_dynamic": k.dynquant.qmatmul_dynamic.launches,
            "qmatmul_static": k.qmatmul.qmatmul_static.launches,
            "paged_decode": k.paged_attn.paged_decode.launches}


# ------------------------------------------------------------------ #
# Phase 2: kernels against their plain versions
# ------------------------------------------------------------------ #
def gemm_phase(k, dev, timer):
    ref, qm = k.ref, k.qmatmul
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = {"qmatmul_dynamic": 0.0, "qmatmul_static": 0.0}
    headline = {}
    for kk, n in GEMM_KN:
        w = torch.randint(-127, 128, (kk, n), generator=gen, device=dev,
                          dtype=torch.int8)
        ws = torch.rand((1, n), generator=gen, device=dev) * 1e-3 + 1e-5
        for m in GEMM_MS:
            x = (torch.randn((m, kk), generator=gen, device=dev) * 2).to(
                torch.bfloat16)
            act = (x.float().abs().amax() / 127.0).reshape(())
            for name in ("qmatmul_dynamic", "qmatmul_static"):
                static = name == "qmatmul_static"
                a = act if static else None
                codes, a_scale = qm.quantize_activations(x, a)
                if static:
                    want_codes = ref.quantize_static_ref(x, act)
                    run = lambda: qm.qmatmul_static(x, w, ws, act)  # noqa: E731
                    plain = lambda: ref.qmatmul_static_ref(x, w, ws, act)  # noqa: E731
                else:
                    want_codes, want_scale = ref.quantize_rows_ref(x)
                    if not torch.equal(a_scale, want_scale):
                        raise AssertionError(f"{name} row scales differ at "
                                             f"M={m} K={kk} N={n}")
                    run = lambda: k.dynquant.qmatmul_dynamic(x, w, ws)  # noqa: E731
                    plain = lambda: ref.qmatmul_dynamic_ref(x, w, ws)  # noqa: E731
                if not torch.equal(codes, want_codes):
                    bad = int((codes != want_codes).sum())
                    raise AssertionError(f"{name}: {bad} activation codes "
                                         f"differ at M={m} K={kk} N={n}")
                got, want = run(), plain()
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                # same int32 sums, same epilogue order: rtol 1e-6 is one f32
                # rounding of the scale products
                torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
                worst[name] = max(worst[name], err)
                t_k = timer.graph_ms(run)
                t_eager = timer.eager_ms(run)
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
                nbytes = m * kk * x.element_size() + kk * n + 4 * n + 4 * m * n
                b_ms, b_by = bound(nbytes, 2.0 * m * n * kk, "int8")
                row = dict(kernel=name, M=m, K=kk, N=n, max_abs_err=err,
                           codes_identical=True, ms=t_k, eager_ms=t_eager,
                           plain_ms=t_p, library_ms=lib,
                           library_padded_m=pad_m if pad_m != m else None,
                           bound_ms=b_ms, bound_by=b_by)
                emit("kernel", **row)
                if (m, kk, n) == HEADLINE_GEMM:
                    headline[name] = row
        del w
    for name in headline:
        headline[name]["max_abs_err"] = worst[name]
    return headline


def flash_phase(k, dev, timer):
    ref, fp = k.ref, k.flash_prefill
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    worst, headline = 0.0, None
    for shape in FLASH_SHAPES:
        b, s, hq, hkv, hd, dv, dt = shape
        q = torch.randn((b, s, hq, hd), generator=gen, device=dev).to(dt)
        kk = torch.randn((b, s, hkv, hd), generator=gen, device=dev).to(dt)
        v = torch.randn((b, s, hkv, dv), generator=gen, device=dev).to(dt)
        got, want = fp.flash_prefill(q, kk, v), ref.flash_prefill_ref(q, kk, v)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not torch.isfinite(got).all() or err > FLASH_ATOL:
            raise AssertionError(f"flash_prefill {shape}: max |err| {err} > "
                                 f"{FLASH_ATOL}")
        worst = max(worst, err)
        t_k = timer.graph_ms(lambda: fp.flash_prefill(q, kk, v))
        t_eager = timer.eager_ms(lambda: fp.flash_prefill(q, kk, v))
        t_p = timer.graph_ms(lambda: ref.flash_prefill_ref(q, kk, v), iters=3)
        g = hq // hkv
        qt = q.transpose(1, 2).contiguous()
        kt = kk.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
        vt = v.repeat_interleave(g, dim=2).transpose(1, 2).contiguous()
        lib = timer.graph_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True))
        visible = s * (s + 1) // 2                 # causal (query, key) pairs
        flops = 2.0 * (hd + dv) * visible * b * hq
        nbytes = (q.numel() + kk.numel() + v.numel()) * q.element_size() \
            + 4 * b * s * hq * dv
        b_ms, b_by = bound(nbytes, flops, str(dt).split(".")[-1])
        row = dict(kernel="flash_prefill", B=b, S=s, Hq=hq, Hkv=hkv, hd=hd,
                   dv=dv, dtype=str(dt).split(".")[-1], max_abs_err=err,
                   atol=FLASH_ATOL, gflop=flops / 1e9, ms=t_k,
                   eager_ms=t_eager, plain_ms=t_p,
                   library_ms=lib, bound_ms=b_ms, bound_by=b_by)
        emit("kernel", **row)
        if shape == HEADLINE_FLASH:
            headline = row
    headline["max_abs_err"] = worst
    return headline


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
        got = pa.paged_decode(q, kp, vp, tables, pos)
        want = ref.paged_decode_ref(q, kp, vp, tables, pos)
        torch.cuda.synchronize()
        idle_nan = bool(got[~live].isnan().all()) and bool(
            want[~live].isnan().all())
        err = float((got[live] - want[live]).abs().max())
        if not torch.isfinite(got[live]).all() or err > PAGED_ATOL \
                or not idle_nan:
            raise AssertionError(f"paged_decode ({label}): max |err| {err} "
                                 f"> {PAGED_ATOL} or idle rows not 0/0")
        worst = max(worst, err)
        run = lambda: pa.paged_decode(q, kp, vp, tables, pos)  # noqa: E731
        t_k = timer.graph_ms(run)
        t_eager = timer.eager_ms(run)
        t_p = timer.graph_ms(
            lambda: ref.paged_decode_ref(q, kp, vp, tables, pos), iters=3)
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
        n_valid = int(valid.sum())            # this run's valid slots
        item = kp.element_size()
        nbytes = (2 * n_valid * hkv * hd * item + q.numel() * q.element_size()
                  + tables.numel() * 4 + pos.numel() * 4 + got.numel() * 4)
        flops = 4.0 * g * hd * n_valid * hkv
        b_ms, b_by = bound(nbytes, flops, str(dt).split(".")[-1])
        row = dict(kernel="paged_decode", case=label, B=b, Hkv=hkv, G=g,
                   hd=hd, bs=bs, M=m, N=n, dtype=str(dt).split(".")[-1],
                   positions=pos.tolist(), valid_slots=n_valid,
                   idle_rows=int((~live).sum()), max_abs_err=err,
                   atol=PAGED_ATOL, ms=t_k, eager_ms=t_eager, plain_ms=t_p,
                   library_ms=t_lib, library_gather_ms=t_gather,
                   library_max_abs_err=lib_err, mbytes=nbytes / 1e6,
                   bound_ms=b_ms, bound_by=b_by)
        emit("kernel", **row)
        if label == HEADLINE_PAGED:
            headline = row
        del q, kp, vp, kg, vg
    headline["max_abs_err"] = worst
    return headline


def profile_decode(step_fn, n_steps: int, step_ms: float):
    """Device time inside ``n_steps`` decode steps from a torch.profiler
    trace: busy ms per step, the idle share against the unprofiled step
    time, and the kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step_fn()
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        # kernels only: CPU-side aten ops carry their kernels' time too
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    busy_ms = sum(r[0] for r in rows) / 1e3 / n_steps
    if busy_ms <= 0:
        return {"device_busy_ms_per_step": "not measured"}
    rows.sort(reverse=True)
    return {"device_busy_ms_per_step": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / step_ms),
            "kernels_per_step": sum(r[2] for r in rows) / n_steps,
            "top_kernels": [{"name": name[:80],
                             "ms_per_step": us / 1e3 / n_steps,
                             "calls_per_step": cnt / n_steps}
                            for us, name, cnt in rows[:8]]}


# ------------------------------------------------------------------ #
# Phase 3: the main path at full width
# ------------------------------------------------------------------ #
def e2e_phase(k, dev):
    from repro_torch import configs
    from repro_torch.api.variants import DEFAULT_VARIANTS
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving import InferenceSession, Pipeline, RequestQueue

    cfg = configs.get_config("stablelm-1.6b")
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
    totals = {"flash_prefill": 0, "qmatmul_dynamic": 0, "qmatmul_static": 0}
    for spec in DEFAULT_VARIANTS:
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

        for r in reqs:
            out = r.result
            if not r.done or out.shape != (1, N_NEW) \
                    or int(out.min()) < 0 or int(out.max()) >= cfg.vocab_size:
                raise AssertionError(f"{spec.variant}: bad result {out}")
        need = ["flash_prefill"] + {"dynamic_int8": ["qmatmul_dynamic"],
                                    "static_int8": ["qmatmul_static"]}.get(
                                        spec.variant, [])
        for name in need:
            if launches[name] <= 0:
                raise AssertionError(f"{spec.variant}: {name} never launched "
                                     f"on the main path ({launches})")
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
            if not torch.isfinite(last).all():
                raise AssertionError(f"{spec.variant}: non-finite logits")
            nxt = torch.argmax(last[:, -1], dim=-1).reshape(1, 1)
            reset_counters(k)
            logits, cache = decode_step(session.params, cache, nxt,
                                        PROMPT_LENS[-1], cfg)
            per_step = read_counters(k)
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
            trace = profile_decode(one_step, 4, decode_ms)
        emit("e2e", variant=spec.variant, quantized_leaves=len(info["quantized_paths"]),
             calibration_batches=info.get("calibration_batches", 0),
             build_s=build_s, requests=len(reqs), prompt_lens=PROMPT_LENS,
             new_tokens_each=N_NEW, serve_s=elapsed,
             tokens_per_s=len(reqs) * N_NEW / elapsed,
             prefill_ms_s255=prefill_ms, decode_step_ms=decode_ms,
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


def decode_window(k, engine, cfg, gen):
    """Fill every slot with a 60-token request (40 new tokens: 7 blocks
    each, so the window never preempts), step until all slots decode, then
    count one step's launches, time 8 steps and profile 4."""
    for _ in range(engine.n_slots):
        engine.submit(torch.randint(0, cfg.vocab_size, (1, 60), generator=gen),
                      max_new_tokens=40)
    for _ in range(16):
        engine.step()
    if not all(r is not None and r.status == "decode" for r in engine.active):
        raise AssertionError("decode window: a slot is not decoding")
    reset_counters(k)
    engine.step()
    per_step = read_counters(k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        engine.step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / 8
    trace = profile_decode(engine.step, 4, step_ms)
    engine.run()
    return per_step, step_ms, trace


def engine_phase(k, dev):
    from repro_torch import configs
    from repro_torch.api.variants import VariantSpec
    from repro_torch.models import init_params
    from repro_torch.serving import (ContinuousBatchingEngine,
                                     InferenceSession, replay)

    cfg = configs.get_config("stablelm-1.6b")
    params = init_params(cfg, seed=SEED)
    trace = engine_trace(cfg)
    prompt_tokens = sum(r.tokens.shape[1] for r in trace.requests)
    emit("engine_setup", model=cfg.name, dtype=cfg.dtype, layers=cfg.n_layers,
         requests=len(trace), prompt_lens=[r.tokens.shape[1]
                                           for r in trace.requests],
         arrival_ticks=[r.arrival_step for r in trace.requests],
         prompt_tokens=prompt_tokens, new_tokens_each=N_NEW,
         shared_prefix_requests=list(SHARED), **ENGINE, **PAGED)
    totals = {}
    for spec in (VariantSpec.fp32(), VariantSpec.dynamic_int8()):
        qparams, _ = spec.build(params, cfg)
        session = InferenceSession(qparams, cfg)
        streams = {}
        for mode in ("paged", "dense"):
            kw = dict(ENGINE, **(PAGED if mode == "paged" else {}))
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
            reqs = engine.all_requests
            for r in reqs:
                if not r.done or len(r.out_tokens) != N_NEW or not all(
                        0 <= t < cfg.vocab_size for t in r.out_tokens):
                    raise AssertionError(f"{spec.variant}/{mode}: request "
                                         f"{r.rid} ended {r.status} with "
                                         f"{r.out_tokens}")
            streams[mode] = [r.out_tokens for r in reqs]
            need = ["flash_prefill"] + (["paged_decode"] if mode == "paged"
                                        else []) + (
                ["qmatmul_dynamic"] if spec.variant == "dynamic_int8" else [])
            for name in need:
                if launches[name] <= 0:
                    raise AssertionError(f"{spec.variant}/{mode}: {name} "
                                         f"never launched ({launches})")
            if mode == "paged" and (report["preempted"] < 1
                                    or report["prefix_hit_tokens"] <= 0):
                raise AssertionError(
                    f"{spec.variant}: the paged replay must preempt and hit "
                    f"the prefix cache ({report['preempted']}, "
                    f"{report['prefix_hit_tokens']})")
            peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
            gen = torch.Generator().manual_seed(SEED + 8)
            per_step, step_ms, dtrace = decode_window(k, engine, cfg, gen)
            if mode == "paged" and per_step["paged_decode"] != cfg.n_layers:
                raise AssertionError(f"paged_decode launched "
                                     f"{per_step['paged_decode']} times in "
                                     f"one decode step, not {cfg.n_layers}")
            tokens = report["generated_tokens"]
            emit("engine", variant=spec.variant, mode=mode,
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
                     "prompt_tokens_computed")},
                 launches=launches, launches_per_decode_step=per_step,
                 decode_trace=dtrace, peak_mem_gb=peak_gb)
            if mode == "paged":
                for name, n in launches.items():
                    totals[name] = totals.get(name, 0) + n
            del engine
            torch.cuda.empty_cache()
        same = sum(a == b for a, b in zip(streams["paged"], streams["dense"]))
        emit("engine_agreement", variant=spec.variant,
             paged_equals_dense_streams=same, of=len(trace))
        del session, qparams
        torch.cuda.empty_cache()
    return totals


# ------------------------------------------------------------------ #
# Phase 5: card against CPU
# ------------------------------------------------------------------ #
def cpu_phase(dev):
    from repro_torch import configs
    from repro_torch.api.variants import VariantSpec
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving import InferenceSession

    cfg = configs.get_config("stablelm-1.6b").with_overrides(
        n_layers=2, dtype="float32")
    params = init_params(cfg, seed=SEED + 3, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 48),
                           generator=torch.Generator().manual_seed(SEED + 4))
    for spec in (VariantSpec.fp32(), VariantSpec.dynamic_int8()):
        qparams, _ = spec.build(params, cfg)
        card = InferenceSession(qparams, cfg)          # moves to the card
        with torch.no_grad():
            c_last, c_cache = prefill(qparams, {"tokens": tokens}, cfg,
                                      pad_to=64)
            g_last, g_cache = prefill(card.params,
                                      {"tokens": tokens.to(dev)}, cfg,
                                      pad_to=64)
            steps = [(c_last, g_last)]
            for i in range(8):
                nxt = torch.argmax(c_last[:, -1], dim=-1).reshape(1, 1)
                c_last, c_cache = decode_step(qparams, c_cache, nxt, 48 + i,
                                              cfg)
                g_last, g_cache = decode_step(card.params, g_cache,
                                              nxt.to(dev), 48 + i, cfg)
                steps.append((c_last, g_last))
        worst_max = max(float((c - g.cpu()).abs().max()) for c, g in steps)
        worst_mean = max(float((c - g.cpu()).abs().mean()) for c, g in steps)
        tol_max, tol_mean = CPU_TOL[spec.variant]
        ok = worst_max <= tol_max and worst_mean <= tol_mean
        emit("card_vs_cpu", variant=spec.variant, layers=cfg.n_layers,
             d_model=cfg.d_model, vocab=cfg.vocab_size, prompt=48,
             decode_steps=8, max_abs_err=worst_max, mean_abs_err=worst_mean,
             tol_max=tol_max, tol_mean=tol_mean,
             logit_scale=float(steps[0][0].abs().max()), ok=ok)
        if not ok:
            raise AssertionError(f"card vs CPU logits differ by max "
                                 f"{worst_max} / mean {worst_mean} "
                                 f"({spec.variant})")
        del card


def cpu_paged_phase(dev):
    """The paged path, card against CPU: prefill_paged of a 48-token prompt
    (token axis padded to 64, pads written to the trash block) through a
    table of scattered block ids with a -1 tail, then 8 teacher-forced
    decode_step_paged calls."""
    from repro_torch import configs
    from repro_torch.api.variants import VariantSpec
    from repro_torch.models import decode_step_paged, init_params, prefill_paged
    from repro_torch.serving import InferenceSession
    from repro_torch.serving.kvcache import init_paged_pools

    cfg = configs.get_config("stablelm-1.6b").with_overrides(
        n_layers=2, dtype="float32")
    params = init_params(cfg, seed=SEED + 3, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (1, 48),
                           generator=torch.Generator().manual_seed(SEED + 4))
    padded = torch.nn.functional.pad(tokens, (0, 16))
    tables = torch.tensor([[7, 2, 9, 4, -1, -1, -1, -1]], dtype=torch.int32)
    for spec in (VariantSpec.fp32(), VariantSpec.dynamic_int8()):
        qparams, _ = spec.build(params, cfg)
        card = InferenceSession(qparams, cfg)          # moves to the card
        c_pools = init_paged_pools(cfg, 12, 16, device="cpu")
        g_pools = init_paged_pools(cfg, 12, 16, device=dev)
        g_tables = tables.to(dev)
        with torch.no_grad():
            c_last, _ = prefill_paged(qparams, c_pools, {"tokens": padded},
                                      48, tables, cfg)
            g_last, _ = prefill_paged(card.params, g_pools,
                                      {"tokens": padded.to(dev)}, 48,
                                      g_tables, cfg)
            steps = [(c_last, g_last)]
            for i in range(8):
                nxt = torch.argmax(c_last[:, -1], dim=-1).reshape(1, 1)
                pos = torch.tensor([48 + i])
                c_last, _ = decode_step_paged(qparams, c_pools, nxt, pos,
                                              tables, cfg)
                g_last, _ = decode_step_paged(card.params, g_pools,
                                              nxt.to(dev), pos.to(dev),
                                              g_tables, cfg)
                steps.append((c_last, g_last))
        worst_max = max(float((c - g.cpu()).abs().max()) for c, g in steps)
        worst_mean = max(float((c - g.cpu()).abs().mean()) for c, g in steps)
        tol_max, tol_mean = CPU_TOL[spec.variant]
        ok = worst_max <= tol_max and worst_mean <= tol_mean
        emit("card_vs_cpu_paged", variant=spec.variant, layers=cfg.n_layers,
             d_model=cfg.d_model, prompt=48, decode_steps=8,
             table=tables.tolist(), max_abs_err=worst_max,
             mean_abs_err=worst_mean, tol_max=tol_max, tol_mean=tol_mean,
             ok=ok)
        if not ok:
            raise AssertionError(f"paged card vs CPU logits differ by max "
                                 f"{worst_max} / mean {worst_mean} "
                                 f"({spec.variant})")
        del card, g_pools


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
    from repro_torch.kernels import (_build, dynquant, flash_prefill,
                                     paged_attn, qmatmul, ref)

    k = types.SimpleNamespace(ref=ref, qmatmul=qmatmul, dynquant=dynquant,
                              flash_prefill=flash_prefill,
                              paged_attn=paged_attn)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    smi = gpu_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {n: sorted({ln.split(":", 1)[-1].strip()
                        for ln in log.splitlines() if "Used" in ln
                        or ("spill" in ln and " 0 bytes spill stores" not in ln)})
             for n, log in _build.BUILD_LOG.items()}
    emit("card", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda, build_s=build_s, ptxas=ptxas)

    timer = Timer(dev)
    heads = gemm_phase(k, dev, timer)
    heads["flash_prefill"] = flash_phase(k, dev, timer)
    heads["paged_decode"] = paged_phase(k, dev, timer)
    del timer
    torch.cuda.empty_cache()
    totals = e2e_phase(k, dev)
    totals["paged_decode"] = engine_phase(k, dev)["paged_decode"]
    cpu_phase(dev)
    cpu_paged_phase(dev)

    sources = {"flash_prefill": ("src/repro_torch/csrc/flash_prefill.cu",
                                 "src/repro/kernels/flash_prefill.py:244"),
               "qmatmul_dynamic": ("src/repro_torch/csrc/qmatmul.cu",
                                   "src/repro/kernels/dynquant.py:36"),
               "qmatmul_static": ("src/repro_torch/csrc/qmatmul.cu",
                                  "src/repro/kernels/qmatmul.py:42"),
               "paged_decode": ("src/repro_torch/csrc/paged_attn.cu",
                                "src/repro/kernels/paged_attn.py:186")}
    kernels = []
    for name, (src_path, replaces) in sources.items():
        h = heads[name]
        shape = {key: h[key] for key in ("M", "K", "N", "B", "S", "Hq", "Hkv",
                                         "G", "hd", "dv", "bs", "dtype")
                 if key in h}
        kernels.append({"name": name, "route": "cuda", "source": src_path,
                        "replaces": replaces, "launches": totals[name],
                        "max_abs_err": h["max_abs_err"], "ms": h["ms"],
                        "eager_ms": h["eager_ms"],
                        "plain_ms": h["plain_ms"], "bound_ms": h["bound_ms"],
                        "bound_by": h["bound_by"],
                        "library_ms": h["library_ms"], "shape": shape})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
