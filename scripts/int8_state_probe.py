#!/usr/bin/env python3
"""Why AdamW with int8 moments diverges where fp32 moments do not, on the
card: stablelm-1.6b at its published width and depth in f32 (remat on),
trained by ``fit`` for 6 steps on ``lm_stream`` batches of 8 x 128, then
3 more steps on the same 3 batches twice, from fresh fp32 moments and from
fresh int8 moments. Per step: the loss, the grad norm and, for int8, the
share of v codes at 0 overall and in the three leaves where it is
highest. One JSON line per step.

    python3 scripts/int8_state_probe.py

Needs one GPU (about 55 GB of its memory).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    if not torch.cuda.is_available():
        print("int8_state_probe: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch import configs
    from repro_torch.data import lm_stream
    from repro_torch.models import init_params
    from repro_torch.training import (OptimizerConfig, adamw_init, fit,
                                      train_step)
    from repro_torch.tree import get_path, leaves_with_path

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = configs.get_config("stablelm-1.6b").with_overrides(dtype="float32")
    stream = lm_stream(cfg, 8, 128, seed=41, device=dev)
    params, hist = fit(cfg, OptimizerConfig(lr=1e-3, warmup_steps=1,
                                            total_steps=6),
                       stream, 6, params=init_params(cfg, seed=40),
                       log_every=1, log_fn=lambda line: None, device=dev)
    print(json.dumps({"fit": "fp32", "losses": [h["loss"] for h in hist]}),
          flush=True)
    batches = [next(stream) for _ in range(3)]
    for moments in ("fp32", "int8"):
        oc = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=3,
                             int8_state=moments == "int8")
        p, state = params, adamw_init(params, oc)
        for i, batch in enumerate(batches):
            p, state, m = train_step(p, state, batch, cfg, oc)
            row = {"moments": moments, "step": i, "loss": m["loss"].item(),
                   "grad_norm": m["grad_norm"].item()}
            if oc.int8_state:
                zeros = {path: get_path(state["mu"], path)["v"]["q"]
                         for path, _ in leaves_with_path(p)}
                n = sum(c.numel() for c in zeros.values())
                share = {path: (c == 0).float().mean().item()
                         for path, c in zeros.items()}
                row["v_zero_share"] = sum(
                    (c == 0).sum().item() for c in zeros.values()) / n
                row["v_zero_share_top"] = sorted(
                    share.items(), key=lambda kv: kv[1])[-3:]
            print(json.dumps(row), flush=True)
        del p, state
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
