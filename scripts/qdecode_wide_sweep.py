#!/usr/bin/env python3
"""Times the shapes ``qdecode``'s wide class could take, on one card.

    python3 scripts/qdecode_wide_sweep.py

Builds ``scripts/qdecode_wide_sweep.cu`` (the split-K loop of
``src/repro_torch/csrc/decode_split.cuh``, one instantiation per pair of
lanes a slot row and query heads a CTA) into ``build/`` and, at
recurrentgemma-9b's decode shapes (B8 and B1 over its 2048-slot ring, 16
query heads x 256 over one kv head, bf16 q) and a ragged one (B3 S257 G12
hd192), launches every variant with the host's split rule and with 4 and 8
splits forced, holds each to the plain ``qdecode_ref`` and times it as
``chip_smoke.py`` times a kernel (a CUDA-graph replay, L2 flushed before
each call), beside the library's own ``qdecode``. Prints one JSON line per
shape and variant with its ms and its multiple of the byte bound. Needs
one CUDA card; without one it exits non-zero and prints no result.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = ((8, 2048, 1, 16, 256), (1, 2048, 1, 16, 256), (3, 257, 1, 12, 192))
# (lanes a slot row, query heads a CTA) of each variant of the .cu file
VARIANTS = ((32, 8), (16, 4), (16, 2), (16, 1))
ATOL = 1e-4


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("qdecode_wide_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build, qdecode, ref

    dev = torch.device("cuda")
    print(cs.gpu_line(), flush=True)
    lib_path = os.path.join(ROOT, "build", "qdecode_wide_sweep.so")
    os.makedirs(os.path.dirname(lib_path), exist_ok=True)
    built = subprocess.run(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I",
         str(_build.CSRC), "-o", lib_path,
         os.path.join(ROOT, "scripts", "qdecode_wide_sweep.cu")],
        capture_output=True, text=True)
    if built.returncode:
        print(built.stdout + built.stderr, file=sys.stderr)
        return 1
    print(json.dumps({"ptxas": [ln.split(":", 1)[-1].strip() for ln in (
        built.stdout + built.stderr).splitlines() if "Used" in ln]}),
        flush=True)
    lib = ctypes.CDLL(lib_path)
    P, I = _build.P, _build.I
    lib.wide_sweep_fwd.argtypes = [P, I, P, P, P, P, P, P, I, I, I, I, I, I,
                                   I, P, ctypes.POINTER(I)]
    lib.wide_sweep_fwd.restype = I
    timer = cs.Timer(dev)
    gen = torch.Generator().manual_seed(cs.SEED + 70)
    for b, s, hkv, g, hd in SHAPES:
        q = torch.randn((b, hkv, g, hd), generator=gen).to(dev, torch.bfloat16)
        kq, ks = cs.int8_codes(gen, (b, s, hkv, hd), dev)
        vq, vs = cs.int8_codes(gen, (b, s, hkv, hd), dev)
        pos = torch.randint(0, s, (b, 1), generator=gen).to(dev)
        bias = torch.where(torch.arange(s, device=dev)[None] <= pos,
                           torch.zeros((), device=dev),
                           torch.full((), -2.0e38, device=dev))
        want = ref.qdecode_ref(q, kq, ks, vq, vs, bias)
        nbytes = (2 * b * s * hkv * hd + 2 * 4 * b * s * hkv + 4 * b * s
                  + q.numel() * 2 + want.numel() * 4)
        bound_ms, _ = cs.bound(nbytes, 4.0 * g * hd * s * hkv * b, "bfloat16")
        shape = {"B": b, "S": s, "Hkv": hkv, "G": g, "hd": hd,
                 "bound_ms": bound_ms}

        def library():
            return qdecode.qdecode(q, kq, ks, vq, vs, bias)
        err = float((library() - want).abs().max())
        ms = timer.graph_ms(library)
        print(json.dumps({**shape, "variant": "library", "ms": ms,
                          "x_bound": ms / bound_ms, "max_abs_err": err}),
              flush=True)
        for variant, (lpr, gb) in enumerate(VARIANTS):
            for splits in (0, 4, 8):
                out = torch.empty_like(want)
                used = I(0)

                def call():
                    rc = lib.wide_sweep_fwd(
                        q.data_ptr(), 1, kq.data_ptr(), ks.data_ptr(),
                        vq.data_ptr(), vs.data_ptr(), bias.data_ptr(),
                        out.data_ptr(), b, s, hkv, g, hd, variant, splits,
                        torch.cuda.current_stream().cuda_stream,
                        ctypes.byref(used))
                    if rc:
                        raise RuntimeError(f"variant {variant}: CUDA error "
                                           f"{rc}")
                call()
                torch.cuda.synchronize()
                err = float((out - want).abs().max())
                if not torch.isfinite(out).all() or err > ATOL:
                    raise AssertionError(f"variant {variant} splits {splits}"
                                         f": max |err| {err}")
                ms = timer.graph_ms(call)
                print(json.dumps({**shape, "lanes": lpr, "heads_a_cta": gb,
                                  "splits": used.value,
                                  "forced": bool(splits), "ms": ms,
                                  "x_bound": ms / bound_ms,
                                  "max_abs_err": err}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
