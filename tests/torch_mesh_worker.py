"""Runs the port's sharded training paths on a (data 2, model 2) gloo mesh
of four CPU processes, for ``tests/test_torch_mesh_train.py``.

    python tests/torch_mesh_worker.py DIR PORT

Reads DIR/cases.json (the train cases), DIR/<case>__params.npz (JAX-layout
params, keys "/"-joined), DIR/<case>__batch.npz and DIR/moe.npz (one MoE
layer's leaves, the input x and the capacity factors), and writes from rank
0 DIR/<case>__<fp32|int8>__port.npz (the metrics, the params after one
``train_step`` and, with int8 moments, their codes) and DIR/moe__port.npz.
"""
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _nested(flat):
    """{"a/b/c": x} -> {"a": {"b": {"c": x}}} (JAX param trees are
    dicts)."""
    out = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


def run(rank, work, port):
    sys.path.insert(0, os.path.join(ROOT, "src"))
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    from repro_torch import configs as C
    from repro_torch.bridge import grads_to_jax, params_from_jax, to_numpy
    from repro_torch.launch import specs as S
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.models.moe import moe_ffn
    from repro_torch.training import OptimizerConfig, adamw_init, train_step

    mesh = make_test_mesh(2, 2)
    with open(os.path.join(work, "cases.json")) as f:
        cases = json.load(f)
    for name, case in cases.items():
        cfg = C.smoke_config(case["arch"]).with_overrides(**case["over"])
        params = params_from_jax(_nested(dict(np.load(os.path.join(
            work, f"{name}__params.npz")))), cfg, "cpu")
        batch = {k: torch.as_tensor(v) for k, v in np.load(os.path.join(
            work, f"{name}__batch.npz")).items()}
        for int8 in (False, True):
            oc = OptimizerConfig(lr=case["lr"], warmup_steps=1,
                                 int8_state=int8)
            state = adamw_init(params, oc)
            with sh.set_mesh(mesh):
                p_specs = S.param_shardings(cfg, mesh, params)
                pd = sh.distribute(params, p_specs, mesh)
                od = sh.distribute(state, S.opt_shardings(cfg, mesh, state,
                                                          p_specs), mesh)
                bd = sh.distribute(batch, S.batch_shardings(mesh, batch),
                                   mesh)
                new_p, new_s, metrics = train_step(pd, od, bd, cfg, oc)
                new_p, new_s, metrics = (sh.full_tree(t) for t in
                                         (new_p, new_s, metrics))
            if rank:
                continue
            out = {f"metric/{k}": to_numpy(v) for k, v in metrics.items()}
            out.update({f"param/{k}": v
                        for k, v in _flat(grads_to_jax(new_p)).items()})
            if int8:
                for mom in ("m", "v"):
                    out.update({f"{mom}/{k}": v for k, v in _flat(
                        grads_to_jax(_codes(new_s["mu"], mom))).items()})
            tag = "int8" if int8 else "fp32"
            np.savez(os.path.join(work, f"{name}__{tag}__port.npz"), **out)

    moe = dict(np.load(os.path.join(work, "moe.npz")))
    cfg = C.smoke_config("kimi-k2-1t-a32b").with_overrides(
        dtype="float32", opt_moe_shardmap=True)
    out = {}
    for cf in moe.pop("capacity_factors"):
        ccfg = cfg.with_overrides(capacity_factor=float(cf))
        x = torch.as_tensor(moe["x"])
        p = {k: torch.as_tensor(v) for k, v in moe.items() if k != "x"}
        with sh.set_mesh(mesh):
            specs = {k: sh._param_rule(f"layers/0/moe/{k}", tuple(v.shape),
                                       mesh, ccfg) for k, v in p.items()}
            pd = sh.distribute(p, specs, mesh)
            xd = sh.shard_tensor(x, sh.data_spec(tuple(x.shape), mesh), mesh)
            y, aux = moe_ffn(pd, xd, ccfg)
            y, aux = y.full_tensor(), sh.full_tree(aux)
        out[f"{cf}/out"] = y.numpy()
        out.update({f"{cf}/{k}": v.numpy() for k, v in aux.items()})
    if rank == 0:
        np.savez(os.path.join(work, "moe__port.npz"), **out)
    dist.destroy_process_group()


def _codes(mu, mom):
    """The int8 codes of moment ``mom`` of an int8 AdamW state's ``mu``."""
    def pick(node):
        if isinstance(node, dict) and "m" in node and "v" in node:
            return node[mom]["q"]
        if isinstance(node, dict):
            return {k: pick(v) for k, v in node.items()}
        return [pick(v) for v in node]

    return pick(mu)


if __name__ == "__main__":
    mp.spawn(run, args=(sys.argv[1], int(sys.argv[2])), nprocs=4)
