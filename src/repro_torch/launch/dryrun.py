"""Dry-run: trace every (arch x input shape x mesh) step on fake tensors
laid out on a DTensor mesh, and report what it costs each device.

The twin of ``repro.launch.dryrun``. Where JAX lowers and compiles the
sharded step for a v5e pod and reads XLA's cost and memory analyses, the
port builds fake-tensor stand-ins (``launch/specs.py``), distributes them by
the GSPMD rules on a mesh of JAX's production shape over a fake world
(``launch/mesh.py``), runs the step once under ``set_mesh`` and counts its
local ops (``launch/step_analysis.py``). Nothing is allocated, no device is
touched, and the roofline terms are the H100's::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape train_4k --mesh single --out build/dryrun

Each result is written to <out>/<arch>__<shape>__<mesh>[__tag].json and
skipped if already present. One process holds one default process group:
run each mesh shape in a process of its own (``--mesh`` takes one).
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import time
import traceback
from typing import Any, Dict


from repro_torch import configs as C
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import (CARD, HBM_BW, NVLINK_BW,
                                     PEAK_FLOPS_BF16, hbm_per_chip,
                                     make_production_mesh)
from repro_torch.launch.step_analysis import analyze_step
from repro_torch.models import decode_step, prefill
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import distribute, set_mesh
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_step import train_step

# --------------------------------------------------------------------- #
# Variants: cfg overrides and/or quantized (int8-weight) param trees, as in
# the JAX package
VARIANTS: Dict[str, Dict[str, Any]] = {
    "": {},
    "attnopt": {"cfg": {"opt_attn_accum": True}},
    "int8w": {"quant": True},
    "int8w-attnopt": {"cfg": {"opt_attn_accum": True}, "quant": True},
    "accum2x": {"accum_mult": 2},
    "accum4x": {"accum_mult": 4},
    "fsdp": {"cfg": {"fsdp": True}},
    "int8kv": {"cfg": {"kv_cache_int8": True, "opt_attn_accum": True}},
    "int8all": {"cfg": {"kv_cache_int8": True, "opt_attn_accum": True},
                "quant": True},
    "mlaabsorb": {"cfg": {"opt_mla_absorb": True, "opt_attn_accum": True}},
    "mlaabsorb-int8w": {"cfg": {"opt_mla_absorb": True,
                                "opt_attn_accum": True}, "quant": True},
    "moesharded": {"cfg": {"opt_moe_shardmap": True, "opt_attn_accum": True}},
    # accum trade: FSDP weight-gather traffic scales with #microbatches,
    # activation memory scales inversely
    "moesharded-accum4": {"cfg": {"opt_moe_shardmap": True,
                                  "opt_attn_accum": True, "grad_accum": 4}},
    "moesharded-accum16": {"cfg": {"opt_moe_shardmap": True,
                                   "opt_attn_accum": True, "grad_accum": 16}},
}


def qparam_structs(cfg: ModelConfig, fake=None):
    """Fake structs of the dynamic-int8 artifact (weights-only
    quantization)."""
    from repro_torch.core.quant import QuantConfig, quantize_tree

    with S.fake_mode(fake):
        qp, _ = quantize_tree(S.param_structs(cfg, fake),
                              QuantConfig("dynamic_int8"))
        return qp


def build_lowerable(cfg: ModelConfig, shape_name: str, mesh,
                    quantized: bool = False, fake=None, batch=None,
                    seq=None):
    """(step fn, its args as DTensors over fake shards) of ``shape_name``:
    train_4k -> ``train_step``, prefill_32k -> ``prefill``, a decode shape
    -> ``decode_step``. ``batch`` / ``seq`` override the shape's global
    batch and sequence."""
    info = C.INPUT_SHAPES[shape_name]
    kind = info["kind"]
    b = batch or info["global_batch"]
    s = seq or info["seq_len"]
    cfg = S.config_for_shape(cfg, shape_name)
    fake = S.fake_mode(fake)

    # int8 artifacts are serving-side only (training differentiates weights)
    quantized = quantized and kind != "train"
    p_structs = (qparam_structs(cfg, fake) if quantized
                 else S.param_structs(cfg, fake))
    p_specs = S.param_shardings(cfg, mesh, p_structs)
    params = distribute(p_structs, p_specs, mesh)

    if kind == "train":
        oc = OptimizerConfig()
        o_structs = S.opt_structs(cfg, oc, fake, p_structs)
        opt = distribute(o_structs,
                         S.opt_shardings(cfg, mesh, o_structs, p_specs), mesh)
        b_structs = S.batch_structs(cfg, b, s, train=True, fake=fake)
        bat = distribute(b_structs, S.batch_shardings(mesh, b_structs), mesh)
        return functools.partial(train_step, cfg=cfg, oc=oc), (params, opt,
                                                                 bat)
    if kind == "prefill":
        b_structs = S.batch_structs(cfg, b, s, train=False, fake=fake)
        bat = distribute(b_structs, S.batch_shardings(mesh, b_structs), mesh)
        return functools.partial(prefill, cfg=cfg), (params, bat)
    # decode: one new token against a seq_len cache
    c_structs = S.cache_structs(cfg, b, s, fake)
    caches = distribute(c_structs, S.cache_shardings(mesh, c_structs), mesh)
    with fake:
        t_struct = S._token_struct(cfg, b, 1)
    tok = distribute({"t": t_struct}, S.batch_shardings(mesh, {"t": t_struct}),
                     mesh)["t"]
    return functools.partial(decode_step, pos=s - 1, cfg=cfg), (params,
                                                                 caches, tok)


def model_flops(cfg: ModelConfig, shape_name: str) -> float:
    info = C.INPUT_SHAPES[shape_name]
    n = cfg.param_count(active_only=cfg.n_experts > 0)
    if info["kind"] == "train":
        return 6.0 * n * info["global_batch"] * info["seq_len"]
    if info["kind"] == "prefill":
        return 2.0 * n * info["global_batch"] * info["seq_len"]
    return 2.0 * n * info["global_batch"]          # decode: 1 token/seq


def trace_on_mesh(cfg: ModelConfig, shape_name: str, mesh, *,
                  quantized: bool = False, batch=None, seq=None):
    """(analysis of the step traced on ``mesh``, build s, trace s). A CPU
    mesh (the fake world's) traces under the ``ref`` backend, as an
    unpinned session on the CPU runs."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.api.backends import bind_for, use_backend

    fake = FakeTensorMode()
    # repro: allow-wallclock -- build / trace timing is a measured interval
    t0 = time.perf_counter()
    with set_mesh(mesh), fake, use_backend(bind_for(None, mesh.device_type)):
        fn, args = build_lowerable(cfg, shape_name, mesh, quantized, fake,
                                   batch, seq)
        t1 = time.perf_counter()  # repro: allow-wallclock -- interval vs t0
        res = analyze_step(fn, *args)
        t2 = time.perf_counter()  # repro: allow-wallclock -- interval vs t1
    res.pop("outputs")
    return res, t1 - t0, t2 - t1


def run_one(arch: str, shape_name: str, mesh_name: str, tag: str = "",
            cfg_override=None, mesh=None, batch=None,
            seq=None) -> Dict[str, Any]:
    """The record of one (arch, shape, mesh): JAX's ``run_one`` keys.
    ``lower_s`` is the time to build and distribute the stand-ins,
    ``compile_s`` the step's trace; ``memory`` holds the per-device
    argument, output and peak live bytes against the card's HBM. ``mesh``
    (default: the production mesh over a fake world), ``batch`` and
    ``seq`` (default: the shape's) may be given."""
    mesh = mesh or make_production_mesh(multi_pod=mesh_name == "multi")
    n_dev = mesh.size()
    cfg = cfg_override or C.get_config(arch)
    var = VARIANTS.get(tag, {})
    if var.get("cfg"):
        cfg = cfg.with_overrides(**var["cfg"])
    if var.get("accum_mult"):
        cfg = cfg.with_overrides(
            grad_accum=max(cfg.grad_accum, 1) * var["accum_mult"])
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
        "n_devices": n_dev, "card": CARD,
        "params": cfg.param_count(),
        "active_params": cfg.param_count(active_only=cfg.n_experts > 0),
    }
    res, build_s, trace_s = trace_on_mesh(cfg, shape_name, mesh,
                                          quantized=bool(var.get("quant")),
                                          batch=batch, seq=seq)
    coll = {"bytes_by_op": res["collective_by_op"],
            "counts": res["collective_counts"],
            "total_bytes": res["collective_bytes"]}
    flops_dev, bytes_dev = res["flops"], res["bytes"]
    mf = model_flops(S.config_for_shape(cfg, shape_name), shape_name)
    terms = {
        "compute_s": flops_dev / PEAK_FLOPS_BF16,
        "memory_s": bytes_dev / HBM_BW,
        "collective_s": res["collective_bytes"] / NVLINK_BW,
    }
    rec.update({
        "lower_s": round(build_s, 2),
        "compile_s": round(trace_s, 2),
        "flops_per_device": flops_dev,
        "bytes_per_device": bytes_dev,
        # XLA's once-through cost analysis has no eager counterpart: the
        # trace counts every op as it runs
        "xla_cost_flops_once": flops_dev,
        "xla_cost_bytes_once": bytes_dev,
        "collectives": coll,
        "memory": {
            "argument_bytes": res["argument_bytes"],
            "output_bytes": res["output_bytes"],
            "temp_bytes": res["peak_bytes"] - res["argument_bytes"],
            "alias_bytes": 0,
            "peak_est_bytes": res["peak_bytes"],
            "hbm_per_chip": hbm_per_chip(),
        },
        "roofline": {
            **terms,
            "dominant": max(terms, key=terms.get),
            "model_flops_total": mf,
            "useful_flops_ratio": mf / max(flops_dev * n_dev, 1.0),
        },
    })
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", nargs="+", default=["all"])
    ap.add_argument("--shape", nargs="+", default=["train_4k"])
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    archs = C.all_arch_ids() if args.arch == ["all"] else args.arch
    shapes = list(C.INPUT_SHAPES) if args.shape == ["all"] else args.shape
    os.makedirs(args.out, exist_ok=True)
    mesh = make_production_mesh(multi_pod=args.mesh == "multi")

    failures = []
    for arch in archs:
        for shape in shapes:
            stem = f"{arch}__{shape}__{args.mesh}"
            if args.tag:
                stem += f"__{args.tag}"
            path = os.path.join(args.out, stem + ".json")
            if os.path.exists(path) and not args.force:
                print(f"SKIP {stem} (exists)", flush=True)
                continue
            print(f"RUN  {stem} ...", flush=True)
            try:
                rec = run_one(arch, shape, args.mesh, tag=args.tag,
                              mesh=mesh)
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                r, m = rec["roofline"], rec["memory"]
                print(f"OK   {stem} trace={rec['compile_s']}s "
                      f"flops/dev={rec['flops_per_device']:.3e} "
                      f"bytes/dev={rec['bytes_per_device']:.3e} "
                      f"args={m['argument_bytes'] / 1e9:.2f}GB "
                      f"peak={m['peak_est_bytes'] / 1e9:.2f}GB "
                      f"coll/dev={rec['collectives']['total_bytes'] / 1e9:.3f}"
                      f"GB dominant={r['dominant']}", flush=True)
            except Exception as e:  # noqa: BLE001 -- the batch goes on
                failures.append(stem)
                err = {"arch": arch, "shape": shape, "mesh": args.mesh,
                       "error": repr(e),
                       "traceback": traceback.format_exc()[-4000:]}
                with open(os.path.join(args.out, stem + ".FAILED.json"),
                          "w") as f:
                    json.dump(err, f, indent=1)
                print(f"FAIL {stem}: {e!r}", flush=True)
    print(f"done; {len(failures)} failures: {failures}", flush=True)
    return failures


if __name__ == "__main__":
    main()
