"""Quantization benchmark as a serving workload (paper Fig. 6 analog) on
the PyTorch port (the twin of ``examples/quantized_serving.py``).

Runs the same batched inference workload through fp32, static-int8 and
dynamic-int8 sessions of the stablelm family model and reports mean latency
and its distribution, on ``--device`` (default: the card).

    PYTHONPATH=src python examples/quantized_serving_torch.py [--scale 256]
        [--device cpu]

The weights and batches are the port's own seeded draws, so the numbers are
not the JAX example's; each session is pinned to the device's kernel
backend: on the card ``cuda`` (the int8 variants run the hand-written w8a8
GEMMs), on the CPU ``ref`` (their plain versions).
"""
import argparse

import torch

from repro_torch import configs as C
from repro_torch.api import DEFAULT_VARIANTS, use_backend
from repro_torch.core.quant import tree_size_bytes
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import InferenceSession


def build_variants(cfg, params, calib_batches):
    """Declarative: each VariantSpec builds its params (static specs run
    their own calibration passes over ``calib_batches``)."""
    return {spec.variant: spec.build(params, cfg, calib_data=calib_batches)[0]
            for spec in DEFAULT_VARIANTS}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=192,
                    help="d_model of the benchmark model")
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = C.smoke_config("stablelm-1.6b").with_overrides(
        dtype="float32", d_model=args.scale, n_layers=4,
        d_ff=3 * args.scale, vocab_size=2048)
    params = init_params(cfg, seed=0, device=dev)

    def mk_batch(seed):
        gen = torch.Generator().manual_seed(seed)
        return {"tokens": torch.randint(0, cfg.vocab_size,
                                        (args.batch, args.seq),
                                        generator=gen).to(dev)}

    backend = "cuda" if dev.type == "cuda" else "ref"
    with use_backend(backend):          # static specs calibrate under it
        variants = build_variants(cfg, params,
                                  [mk_batch(100 + i) for i in range(3)])
    print(f"{'variant':14s} {'size MB':>8s} {'mean ms':>9s} {'p10':>7s} "
          f"{'p90':>7s}")
    results = {}
    for name, p in variants.items():
        session = InferenceSession(p, cfg, backend=backend, device=dev)
        session.logits(mk_batch(0))                     # warmup
        session.stats.reset()
        for i in range(args.iters):
            session.logits(mk_batch(i))
        lat = sorted(session.stats.latencies_ms)
        results[name] = session.stats.mean_ms
        print(f"{name:14s} {tree_size_bytes(p)/1e6:8.2f} "
              f"{session.stats.mean_ms:9.2f} {lat[len(lat)//10]:7.2f} "
              f"{lat[9*len(lat)//10]:7.2f}")
    print(f"\nspeedup vs fp32:  static "
          f"{results['fp32']/results['static_int8']:.2f}x"
          f"  dynamic {results['fp32']/results['dynamic_int8']:.2f}x")
    return results


if __name__ == "__main__":
    main()
