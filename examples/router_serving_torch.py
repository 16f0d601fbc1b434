"""Disaggregated prefill/decode serving behind an SLO-aware router, on the
PyTorch port (the twin of ``examples/router_serving.py``).

One combined engine couples the two serving regimes: a long prompt holds a
decode slot for its whole generation, so bursty interactive traffic queues
behind batch work and TTFT grows. This example splits the roles:

  1. a *prefill worker* computes each prompt's paged KV (+ exactly one
     token) and exports the blocks as a ``KVHandoff``;
  2. two *decode workers* attach handed-off blocks from the same
     ``SharedKVPool`` (zero prompt recompute) and stream the rest;
  3. the ``ServingRouter`` owns admission (queue-depth backpressure), SLO
     classes (interactive dispatches first), least-loaded placement, and
     starvation-free re-dispatch when a decode worker rejects a handoff
     under KV pressure.

Both arms replay the same seeded open-loop arrival trace on a virtual clock
and the same total KV block budget. Asserts that every stream both arms
complete is bit-identical and that the decode workers recompute no prompt
token, and prints the interactive class's p99 TTFT side by side (virtual
seconds: one tick is one step of every worker).

    PYTHONPATH=src python examples/router_serving_torch.py [--fast]
        [--device cpu]

Runs on the card by default; ``--device cpu`` runs the plain PyTorch path.
The weights are the port's own seeded draw, and the trace comes from the
port's ``ArrivalTrace.generate``, so the numbers are not the JAX
example's.
"""
from __future__ import annotations

import argparse

from repro_torch import configs as C
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import (ArrivalTrace, ContinuousBatchingEngine,
                                 ServingRouter, SharedKVPool, route_trace,
                                 single_engine_trace)

ARCH = "mistral-nemo-12b"
N_SLOTS = 4                # single-engine arm; the router splits 2 + 2 + 2
MAX_LEN = 96
BLOCK_SIZE = 16
PREFILL_CHUNK = 6
SEED = 29


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true",
                    help="a 40-request trace instead of 200")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    n_requests = 40 if args.fast else 200

    cfg = C.smoke_config(ARCH).with_overrides(dtype="float32")
    params = init_params(cfg, seed=0, device=dev)
    trace = ArrivalTrace.generate(cfg, n_requests=n_requests, seed=SEED,
                                  mean_interarrival=4.0,
                                  prompt_len=(8, 32), max_new=(8, 24))
    n_blocks = 2 * N_SLOTS * (-(-MAX_LEN // BLOCK_SIZE)) + 1
    max_ticks = 60 * n_requests

    print(f"== single combined engine ({N_SLOTS} slots, "
          f"{n_blocks} blocks) ==")
    single = ContinuousBatchingEngine(
        params, cfg, n_slots=N_SLOTS, max_len=MAX_LEN,
        prefill_chunk=PREFILL_CHUNK, paged=True, block_size=BLOCK_SIZE,
        n_blocks=n_blocks, device=dev)
    single.warmup()
    s = single_engine_trace(single, trace, max_ticks=max_ticks)
    print(f"completed {s['single_completed']}/{n_requests}  "
          f"tok/s {s['single_tok_s']:.2f}  "
          f"interactive p99 TTFT {s['interactive']['p99_ttft_s']:.1f}s")

    print(f"== router: 1 prefill + 2 decode workers, same "
          f"{n_blocks}-block pool ==")
    store = SharedKVPool(cfg, n_blocks, BLOCK_SIZE, dev)
    prefill = [ContinuousBatchingEngine(
        params, cfg, n_slots=2, max_len=MAX_LEN,
        prefill_chunk=PREFILL_CHUNK, paged=True, shared_kv=store,
        device=dev)]
    decode = [ContinuousBatchingEngine(
        params, cfg, n_slots=2, max_len=MAX_LEN, paged=True,
        shared_kv=store, max_queue_depth=4, device=dev) for _ in range(2)]
    router = ServingRouter(prefill, decode)
    router.warmup()
    m = route_trace(router, trace, max_ticks=max_ticks)
    print(f"completed {m['router_completed']}/{n_requests}  "
          f"tok/s {m['router_tok_s']:.2f}  "
          f"interactive p99 TTFT {m['interactive']['p99_ttft_s']:.1f}s  "
          f"redispatches {m['router_redispatches']}")

    assert m["decode_prompt_tokens_recomputed"] == 0, \
        "decode workers recomputed prompt KV"
    by_rid = {rr.rid: rr for rr in router.requests}
    checked = 0
    for i, req in enumerate(single.all_requests):
        rr = by_rid.get(i)
        if rr is None or not req.done or rr.state != "done":
            continue
        assert list(req.out_tokens) == list(rr.out_tokens), \
            f"stream {i} diverged after handoff"
        checked += 1
    print(f"bit-identical streams: {checked}/{n_requests}")
    ratio = (m["interactive"]["p99_ttft_s"]
             / max(s["interactive"]["p99_ttft_s"], 1e-9))
    print(f"interactive p99 TTFT ratio router/single: {ratio:.3f}")


if __name__ == "__main__":
    main()
