"""Quickstart on the PyTorch port: train a small LM, quantize it both ways
(dynamic and calibrated static int8), compare, generate.

    PYTHONPATH=src python examples/quickstart_torch.py [--arch stablelm-1.6b]
        [--steps 60] [--device cpu]

Runs on the card by default; ``--device cpu`` runs the plain PyTorch path.
"""
import argparse

import torch

from repro_torch import configs as C
from repro_torch.api import VariantSpec
from repro_torch.core.quant import tree_size_bytes
from repro_torch.data import lm_stream
from repro_torch.device import resolve_device
from repro_torch.models import forward
from repro_torch.serving import InferenceSession
from repro_torch.training import OptimizerConfig, fit


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg = C.smoke_config(args.arch).with_overrides(dtype="float32")
    print(f"== training reduced {cfg.name} on {dev} ==")
    oc = OptimizerConfig(lr=1e-3, warmup_steps=5, total_steps=args.steps)
    params, history = fit(cfg, oc, lm_stream(cfg, 8, 64, device=dev),
                          args.steps, device=dev)
    assert history[-1]["loss"] < history[0]["loss"], \
        "training must reduce loss"

    batch = next(lm_stream(cfg, 4, 64, seed=9, device=dev))
    print("== quantizing (paper §5: signed int8, dynamic and static) ==")
    variants = {
        "dynamic_int8": VariantSpec.dynamic_int8().build(params, cfg),
        "static_int8": VariantSpec.static_int8(calib_batches=2).build(
            params, cfg, calib_data=[
                next(lm_stream(cfg, 4, 64, seed=s, device=dev))
                for s in (7, 8)]),
    }
    with torch.no_grad():
        lf = forward(params, batch, cfg)[0]
        for name, (qparams, info) in variants.items():
            ratio = tree_size_bytes(params) / tree_size_bytes(qparams)
            lq = forward(qparams, batch, cfg)[0]
            top1 = (lf.argmax(-1) == lq.argmax(-1)).float().mean().item()
            print(f"{name}: quantized {len(info['quantized_paths'])} "
                  f"tensors; size ratio fp32/int8 = {ratio:.2f}x; "
                  f"fp32 vs int8 top-1 agreement: {top1:.3f}")

    print("== greedy generation through the serving session ==")
    session = InferenceSession(variants["dynamic_int8"][0], cfg, device=dev)
    out = session.generate({"tokens": batch["tokens"][:1, :8]}, n_new=12)
    print("generated token ids:", out[0].tolist())


if __name__ == "__main__":
    main()
