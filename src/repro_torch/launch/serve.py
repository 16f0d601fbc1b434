"""Serving launcher, the port of ``repro.launch.serve``: load an artifact's
checkpoint (or draw a smoke model ad hoc) and serve batched requests
through the micro-batching queue on ``--device`` (default: the card;
without one, pass ``--device cpu``)::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \\
        --requests 32 --quant dynamic_int8 [--device cpu] [--checkpoint DIR]

``--checkpoint`` reads the JAX-layout checkpoint both packages write
(``training/checkpoint.py``, an artifact's directory in a registry).
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--quant", default="none",
                    choices=["none", "dynamic_int8", "static_int8"])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for ad-hoc params and request payloads")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import configs as C
    from repro_torch.core.quant import QuantConfig, quantize_tree
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params
    from repro_torch.serving import InferenceSession, Pipeline, RequestQueue
    from repro_torch.training import load_checkpoint

    dev = resolve_device(args.device)
    if args.checkpoint:
        params, cfg, _ = load_checkpoint(args.checkpoint, dev)
    else:
        cfg = C.smoke_config(args.arch).with_overrides(dtype="float32")
        params = init_params(cfg, seed=args.seed, device=dev)
    if args.quant != "none":
        params, paths = quantize_tree(
            params, QuantConfig(mode=args.quant, min_size=1024))
        print(f"quantized {len(paths)} weight tensors ({args.quant})")

    session = InferenceSession(params, cfg, device=dev)
    pipe = Pipeline(
        preprocess=lambda b: b,
        infer=lambda b: session.generate(b, args.new_tokens),
        postprocess=lambda out, raw: out,
    )
    q = RequestQueue(pipe, max_batch=args.max_batch)

    gen = torch.Generator().manual_seed(args.seed)
    shape = ((1, 16, cfg.n_codebooks) if cfg.n_codebooks > 1 else (1, 16))
    reqs = []
    for _ in range(args.requests):
        payload = {"tokens": torch.randint(0, cfg.vocab_size, shape,
                                           generator=gen).to(dev)}
        if cfg.frontend != "none":
            payload["frontend_embeds"] = torch.randn(
                (1, cfg.n_frontend_tokens, cfg.frontend_dim),
                generator=gen).to(dev)
        reqs.append(q.submit(payload))

    t0 = time.perf_counter()  # repro: allow-wallclock -- reported tok/s is real
    q.drain()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0  # repro: allow-wallclock -- interval vs t0
    if not all(r.done for r in reqs):
        raise RuntimeError("the queue drained with requests left unserved")
    print(f"served {len(reqs)} requests x {args.new_tokens} new tokens "
          f"in {dt:.2f}s ({len(reqs) * args.new_tokens / dt:.1f} tok/s), "
          f"mean session latency {session.stats.mean_ms:.1f} ms")
    return reqs


if __name__ == "__main__":
    main()
