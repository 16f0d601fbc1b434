"""Training launcher: the port of ``repro.launch.train``.

Smoke scale (default): streams synthetic LM data (``data.lm_stream``)
through the reduced config of ``--arch`` and trains it for ``--steps`` on
``--device`` (default: the card; without one, pass ``--device cpu``)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --steps 50 [--device cpu] [--checkpoint DIR]

Production scale (``--production``): the full config's sharded
``train_step`` at ``train_4k`` on JAX's 16 x 16 pod mesh, traced on fake
tensors over a fake world of 256 ranks by ``launch.dryrun.run_one`` (no
device is touched); prints its roofline and memory JSON against the H100's
constants. Run it in a process of its own: it initialises this process's
default process group.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--production", action="store_true",
                    help="trace the full config's sharded step on the pod "
                         "mesh (fake tensors, no device)")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    if args.production:
        import json

        from repro_torch.launch.dryrun import run_one

        rec = run_one(args.arch, "train_4k", "single")
        print(json.dumps(rec["roofline"], indent=2))
        print(json.dumps(rec["memory"], indent=2))
        print(f"trace_s: {rec['lower_s'] + rec['compile_s']:.2f}")
        return rec

    from repro_torch import configs as C
    from repro_torch.data import lm_stream
    from repro_torch.device import resolve_device
    from repro_torch.training import OptimizerConfig, fit, save_checkpoint

    dev = resolve_device(args.device)
    cfg = C.smoke_config(args.arch)
    oc = OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                         total_steps=args.steps)
    stream = lm_stream(cfg, args.batch, args.seq, device=dev)
    params, history = fit(cfg, oc, stream, args.steps, device=dev)
    print(f"final loss: {history[-1]['loss']:.4f}")
    if args.checkpoint:
        save_checkpoint(args.checkpoint, params, cfg,
                        meta={"history": history[-3:]})
        print(f"saved to {args.checkpoint}")
    return history


if __name__ == "__main__":
    main()
