"""Paged KV-cache serving with prefix reuse on the PyTorch port (the twin
of ``examples/paged_serving.py``).

Demonstrates the block-pooled serving path end to end on a shared-prefix
VQI-style workload (one common prompt prefix across every request, the
paper's repeated inspection prompt):

  1. dense engine (compat path): whole-prompt prefill, (n_slots, max_len)
     cache reserved up front;
  2. paged engine: block allocator + hash-based prefix reuse: only the
     first request computes the shared prefix, later requests attach the
     cached blocks and recompute just their suffix;
  3. paged engine at a Pi-4-sized block budget: preemption-on-exhaustion
     with token-identical resume;
  4. int8 KV blocks: the paper's signed-int8 scheme extended from weights
     to the cache (quarter the KV bytes per token).

Asserts the paged outputs equal the dense outputs token-for-token, the
prefill-token reduction is >= 30%, and KV bytes per request shrink.

    PYTHONPATH=src python examples/paged_serving_torch.py [--fast]
        [--device cpu]

Runs on the card by default (the paged decode kernels); ``--device cpu``
runs the plain PyTorch path. The weights and prompts are the port's own
seeded draws.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import configs as C
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import ContinuousBatchingEngine

ARCH = "mistral-nemo-12b"
PREFIX_LEN = 64
N_REQUESTS = 32
BLOCK_SIZE = 16


def build_prompts(cfg, n, prefix_len, seed=11):
    gen = torch.Generator().manual_seed(seed)
    prefix = torch.randint(0, cfg.vocab_size, (1, prefix_len), generator=gen)
    out = []
    for _ in range(n):
        slen = int(torch.randint(4, 13, (), generator=gen))
        out.append(torch.cat(
            [prefix, torch.randint(0, cfg.vocab_size, (1, slen),
                                   generator=gen)], dim=1))
    return out


def serve(engine, prompts, max_new):
    reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    engine.run()
    if not all(r.done for r in reqs):
        raise RuntimeError("a request did not finish")
    return [r.out_tokens for r in reqs], engine.metrics(reqs)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n = 16 if args.fast else N_REQUESTS
    max_new = 4 if args.fast else 6

    cfg = C.smoke_config(ARCH).with_overrides(dtype="float32")
    params = init_params(cfg, seed=0, device=dev)
    prompts = build_prompts(cfg, n, PREFIX_LEN)

    def engine(**kw):
        return ContinuousBatchingEngine(params, cfg, n_slots=4, max_len=96,
                                        device=dev, **kw)

    print(f"== {n} requests, {PREFIX_LEN}-token shared prefix ==")
    dense_out, dense_m = serve(engine(), prompts, max_new)
    print(f"dense : prompt tokens computed "
          f"{dense_m['prompt_tokens_computed']:5.0f}  "
          f"kv_hbm_bytes_per_req {dense_m['kv_hbm_bytes_per_req']:8.0f}")

    paged_out, paged_m = serve(engine(paged=True, block_size=BLOCK_SIZE),
                               prompts, max_new)
    reduction = 1 - (paged_m["prompt_tokens_computed"]
                     / dense_m["prompt_tokens_computed"])
    print(f"paged : prompt tokens computed "
          f"{paged_m['prompt_tokens_computed']:5.0f}  "
          f"kv_hbm_bytes_per_req {paged_m['kv_hbm_bytes_per_req']:8.0f}  "
          f"prefix_hit_rate {paged_m['prefix_hit_rate']:.2f}  "
          f"reduction {reduction:.1%}")
    assert paged_out == dense_out, "paged outputs diverged from dense"
    assert reduction >= 0.30, f"prefix reuse reduction only {reduction:.1%}"
    assert (paged_m["kv_hbm_bytes_per_req"]
            < dense_m["kv_hbm_bytes_per_req"]), "paged must hold fewer bytes"

    small_out, small_m = serve(
        engine(paged=True, block_size=BLOCK_SIZE, n_blocks=8),
        prompts, max_new)
    print(f"small : preempted {small_m['preempted']:3.0f} under an 8-block "
          f"pool; outputs identical: {small_out == dense_out}")
    assert small_out == dense_out, "preemption changed tokens"

    cfg8 = cfg.with_overrides(kv_cache_int8=True)
    eng8 = ContinuousBatchingEngine(params, cfg8, n_slots=4, max_len=96,
                                    paged=True, block_size=BLOCK_SIZE,
                                    device=dev)
    out8, m8 = serve(eng8, prompts, max_new)
    agree = sum(a == b for a, b in zip(out8, dense_out))
    print(f"int8  : kv_hbm_bytes_per_req {m8['kv_hbm_bytes_per_req']:8.0f}  "
          f"token agreement with fp32 {agree}/{n}")
    assert m8["kv_hbm_bytes_per_req"] < paged_m["kv_hbm_bytes_per_req"]
    print("OK")
    return {"dense": dense_m, "paged": paged_m, "small": small_m,
            "int8": m8, "reduction": reduction, "int8_agree": agree}


if __name__ == "__main__":
    main()
