#!/usr/bin/env python3
"""Host ms a batch-1 decode step in two checkouts of the repository, taken
in turns (a, b, b, a, a, b), each in a process of its own.

    python3 scripts/decode_ab.py PARENT_DIR CHANGE_DIR

Each process builds the tree's kernels, then serves stablelm-1.6b at
published width and 6 of its 24 layers (bf16, random seeded weights) as
fp32 passthrough, dynamic int8 and dynamic int8 over an int8 KV cache:
a 255-token prefill, then 4 rounds of 32 unpinned decode steps (the first
round warms up), host clock around a synchronize. One line a process,
``DECODE_AB {...}``, with the least, the median and every round's ms per
variant. Needs one GPU."""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

ORDER = (0, 1, 1, 0, 0, 1)
STEPS, ROUNDS = 32, 4


def one(tree: str) -> None:
    sys.path.insert(0, os.path.join(os.path.abspath(tree), "src"))
    import torch

    from repro_torch import configs
    from repro_torch.api.variants import VariantSpec
    from repro_torch.kernels import _build
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serving import InferenceSession

    _build.build_all()
    cfg = configs.get_config("stablelm-1.6b").with_overrides(n_layers=6)
    params = init_params(cfg, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(2)
    prompt = torch.randint(0, cfg.vocab_size, (1, 255), generator=gen,
                           device="cuda")
    batch = {"tokens": torch.nn.functional.pad(prompt, (0, 1))}
    out = {}
    for label, spec, vcfg in (
            ("fp32", VariantSpec.fp32(), cfg),
            ("dynamic_int8", VariantSpec.dynamic_int8(), cfg),
            ("dynamic_int8_kv8", VariantSpec.dynamic_int8(),
             cfg.with_overrides(kv_cache_int8=True))):
        qparams, _ = spec.build(params, vcfg)
        session = InferenceSession(qparams, vcfg)
        rounds = []
        with torch.no_grad():
            logits, cache = prefill(session.params, batch, vcfg, pad_to=512,
                                    n_valid=255)
            pos = 255
            for r in range(ROUNDS):
                torch.cuda.synchronize()
                # repro: allow-wallclock -- a decode step's host time
                t0 = time.perf_counter()
                for _ in range(STEPS):
                    nxt = torch.argmax(logits[:, -1], dim=-1).reshape(1, 1)
                    logits, cache = decode_step(session.params, cache, nxt,
                                                pos, vcfg)
                    pos += 1
                torch.cuda.synchronize()
                if r:
                    # repro: allow-wallclock -- interval vs t0 above
                    rounds.append((time.perf_counter() - t0) * 1e3 / STEPS)
        out[label] = {"min": min(rounds), "median": statistics.median(rounds),
                      "rounds": rounds}
        del session, qparams, cache, logits
        torch.cuda.empty_cache()
    print("DECODE_AB " + json.dumps({"tree": tree, **out}), flush=True)


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        one(argv[1])
        return 0
    trees, failed = argv[:2], 0
    for i in ORDER:
        proc = subprocess.run([sys.executable, __file__, "--one", trees[i]],
                              capture_output=True, text=True, timeout=600)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("DECODE_AB")]
        print(lines[0] if lines and not proc.returncode
              else f"DECODE_AB {trees[i]} failed: {proc.stderr[-500:]}",
              flush=True)
        failed += bool(proc.returncode)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
