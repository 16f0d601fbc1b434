#!/usr/bin/env python3
"""Times ``quantize_weights``' cluster route at every cluster size c its
K-slices fit, against the size the plan picks, on one card.

    python3 scripts/qw_sweep.py

For phi-3-vision's five weight shapes in bf16 and f32, each c from 1 to
CLUSTER_MAX whose K-slice fits a CTA (``quantize.cluster_smem`` within
SMEM_CAP) is launched through the library's ``qw_cluster``, held to the
plain ``quantize_ref`` bit for bit, and timed as ``chip_smoke.py`` times a
kernel (a CUDA-graph replay, L2 flushed before each call). Prints one JSON
line per shape and dtype: every c's ms and its multiple of the byte bound,
and the plan's c. Needs one CUDA card; without one it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("qw_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import _build, quantize, ref

    dev = torch.device("cuda")
    print(cs.gpu_line(), flush=True)
    timer = cs.Timer(dev)
    P, I = _build.P, _build.I
    fn = _build.function("quantize_weights", "qw_cluster",
                         [P, I, I, I, I, I, I, I, P, P, P])
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 22)
    for kk, n in cs.VQI_GEMM_KN:
        for dt in (torch.bfloat16, torch.float32):
            w = (torch.randn((kk, n), generator=gen, device=dev)
                 * 0.05).to(dt)
            codes = torch.empty((kk, n), dtype=torch.int8, device=dev)
            scale = torch.empty((1, n), dtype=torch.float32, device=dev)
            want_codes, want_scale = ref.quantize_ref(w)
            b_ms, _ = cs.bound(kk * n * (w.element_size() + 1) + 4 * n, 0.0,
                               "float32")
            rows_by_c = {}
            for c in range(1, quantize.CLUSTER_MAX + 1):
                rows, box = quantize.slice_rows(kk, c)
                if quantize.cluster_smem(rows, box, w.element_size()) \
                        > quantize.SMEM_CAP:
                    continue

                def call(c=c, rows=rows, box=box):
                    rc = fn(w.data_ptr(), 1 if dt == torch.bfloat16 else 0,
                            kk, n, c, rows, box, 1, codes.data_ptr(),
                            scale.data_ptr(), _build.stream_of(w))
                    _build.check("quantize_weights", rc, "qw_cluster")

                codes.fill_(99)
                call()
                torch.cuda.synchronize()
                if not (torch.equal(codes, want_codes)
                        and torch.equal(scale.view(torch.int32),
                                        want_scale.view(torch.int32))):
                    raise AssertionError(f"[{kk},{n}] {dt} c {c}: codes or "
                                         "scales differ from quantize_ref")
                ms = timer.graph_ms(call, iters=20)
                rows_by_c[c] = {"ms": ms, "x_bound": ms / b_ms}
            print(json.dumps({"K": kk, "N": n,
                              "dtype": str(dt).split(".")[-1],
                              "bound_ms": b_ms,
                              "plan_c": quantize.plan_for(w).cluster,
                              "by_c": rows_by_c}), flush=True)
            del w, codes, scale, want_codes, want_scale
    return 0


if __name__ == "__main__":
    sys.exit(main())
