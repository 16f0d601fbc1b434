#!/usr/bin/env python3
"""Tensor-parallel serving on one card at the published depth:
``chip_smoke.py``'s ``tp`` phase alone (mistral-nemo-12b at published width
and all 40 of its layers, tp=1 against tp=2 with both shards on the card,
dense and paged over the fp, int8 and int4 KV caches, the psum combine, a
profiled 8-slot paged step at each tp, then deepseek-v2's MLA attention at
2 layers), followed by its ``held_shapes`` check of every shape the phase
gave a kernel. One JSON line per result, as
``chip_smoke.py`` prints them.

    python3 scripts/tp_probe.py

``chip_smoke.py`` runs the phase at ``TP_LAYERS``; this script measures it
at ``TP_PUBLISHED_LAYERS``. Needs one GPU (about 45 GB of its memory).
"""
from __future__ import annotations

import os
import sys
import time
import types

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    if not torch.cuda.is_available():
        print("tp_probe: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import chip_smoke as cs
    from repro_torch.kernels import (_build, dynquant, flash_prefill,
                                     paged_attn, qdecode, qmatmul, quantize,
                                     ref)

    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.gpu_line(), flush=True)
    # repro: allow-wallclock -- the kernels' build time on the card
    t0 = time.perf_counter()
    _build.build_all()
    # repro: allow-wallclock -- the kernels' build time on the card
    cs.emit("build", build_s=time.perf_counter() - t0)
    k = types.SimpleNamespace(ref=ref, qmatmul=qmatmul, dynquant=dynquant,
                              flash_prefill=flash_prefill,
                              paged_attn=paged_attn, qdecode=qdecode,
                              quantize=quantize, ptxas={})
    dev = torch.device("cuda")
    layers = cs.TP_PUBLISHED_LAYERS
    seen = {}
    # repro: allow-wallclock -- the phase's own time on the card
    t0 = time.perf_counter()
    with cs.recording_shapes(seen):
        _, by_tp = cs.tp_phase(k, dev, seen, layers=layers)
    cs.emit("tp_probe", layers=layers,
            # repro: allow-wallclock -- the phase's own time on the card
            phase_s=time.perf_counter() - t0,
            launches={name: {f"tp{tp}": by_tp[tp].get(name, 0)
                             for tp in (1, 2)} for name in cs.TP_KERNELS})
    cs.held_shapes_phase(k, dev, seen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
