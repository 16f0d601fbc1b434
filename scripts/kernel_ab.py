#!/usr/bin/env python3
"""The kernel phases of ``chip_smoke.py`` from several checkouts, in turns,
on one card: the way to compare two versions of the port's kernels inside
one call, on one card.

    mkdir -p build/parent && git archive HEAD | tar -x -C build/parent
    python3 scripts/kernel_ab.py build/parent . . build/parent

Each argument is the root of a checkout. Each turn runs, in a fresh
process, that checkout's own ``chip_smoke.py`` pieces: its kernels built
from its sources into its own ``build/``, the timer line, then every
attention kernel phase (flash prefill, paged decode, the int8-KV and
int4-KV kernels) and the weight quantizer's phase that its
``chip_smoke.py`` defines, each kernel held to its plain version and timed
as ``chip_smoke.py`` times it. Every JSON line
is printed as that checkout's ``chip_smoke.py`` prints it, with ``root``
and ``turn`` added; a turn that built its checkout's kernels also prints their
ptxas registers and spills per instantiation. Needs one CUDA card; without
one it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import types

PHASES = ("flash_phase", "paged_phase", "qdecode_phase",
          "paged_qdecode_phase", "flash_qprefill_phase",
          "paged_q4decode_phase", "flash_q4prefill_phase",
          "quantize_weights_phase")


def one(root: str) -> int:
    """One turn: the kernel phases of the checkout at ``root``."""
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [root, os.path.join(root, "src")]
    import chip_smoke as cs

    from repro_torch.kernels import (_build, dynquant, flash_prefill,
                                     paged_attn, qdecode, qmatmul, quantize,
                                     ref)

    k = types.SimpleNamespace(ref=ref, qmatmul=qmatmul, dynquant=dynquant,
                              flash_prefill=flash_prefill,
                              paged_attn=paged_attn, qdecode=qdecode,
                              quantize=quantize, ptxas={})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    _build.build_all()
    # ptxas registers and spills per instantiation, where this turn built
    # the checkout's kernels (a later turn of the same checkout reuses them)
    filt = os.path.join(os.path.dirname(_build._nvcc()), "cu++filt")
    for log in _build.BUILD_LOG.values():
        k.ptxas.update(cs.ptxas_kernels(log, filt))
    cs.emit("card", nvidia_smi=cs.gpu_line(), ptxas=k.ptxas)
    timer = cs.Timer(dev)
    one_el = torch.zeros(1, device=dev)
    cs.emit("timer", floor_ms=timer.graph_ms(lambda: one_el.add_(1),
                                             iters=20))
    for name in PHASES:
        if hasattr(cs, name):
            getattr(cs, name)(k, dev, timer)
    return 0


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        return one(os.path.abspath(argv[1]))
    if not argv or argv[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    for turn, root in enumerate(argv):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--one", root], capture_output=True,
                              text=True)
        for line in proc.stdout.splitlines():
            try:
                row = json.loads(line)
            except ValueError:
                continue
            print(json.dumps({"root": root, "turn": turn, **row}),
                  flush=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
