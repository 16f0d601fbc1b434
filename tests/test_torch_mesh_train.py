"""The port's sharded training on a (data 2, model 2) gloo mesh of four CPU
processes (``tests/torch_mesh_worker.py``) against the JAX package:

- ``train_step`` on DTensor params, moments and batches, laid out by the
  GSPMD rules with ``constrain`` live, for the phi3-mini, kimi-k2 (FSDP,
  the GSPMD dispatch) and mamba2 smoke configs at f32 with
  ``grad_accum=2`` (as ``tests/test_dryrun.py`` picks them), against JAX's
  unsharded ``train_step`` on the same weights and batch, with fp32 and
  with int8 moments (JAX's int8 codes: its ``_q8`` of its fp32-moment
  step's moments, which is what an int8-moment step from a fresh state
  stores);
- ``moe_ffn_sharded`` (the expert-parallel dispatch) against JAX's own
  ``moe_ffn_sharded`` run on four forced host devices in a subprocess,
  with a capacity that drops assignments and one that does not.

Tolerances (f32): loss and metrics rtol 1e-5; params after the step
within 1e-6 of each leaf's max plus 5e-2 * lr (AdamW's first step is
g / (|g| + eps), which a reduction order moves by up to 2 lr where |g| is
near eps); int8 codes off by at most 1; the MoE output and aux rtol 1e-5,
atol 1e-6.
"""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.data import lm_stream as j_lm_stream  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models.moe import init_moe_params as j_init_moe  # noqa: E402
from repro.training import OptimizerConfig as JOC  # noqa: E402
from repro.training import adamw_init as j_adamw_init  # noqa: E402
from repro.training.optimizer import _q8 as j_q8  # noqa: E402
from repro.training.train_step import train_step as j_train_step  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-3
#: the train cases: arch, overrides (both packages' smoke configs)
CASES = {
    "phi3": ("phi3-mini-3.8b", {}),
    "kimi_fsdp": ("kimi-k2-1t-a32b", {"fsdp": True}),
    "mamba2": ("mamba2-780m", {}),
}
#: capacity factors of the MoE check: one that drops assignments, one that
#: keeps all (T * k * cf / E >= T)
CAPACITY = (0.5, 4.0)

JAX_MOE = r"""
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from repro import configs as C
from repro.launch.mesh import make_test_mesh
from repro.models.moe import moe_ffn_sharded
work = sys.argv[1]
moe = dict(np.load(os.path.join(work, "moe.npz")))
cfs = moe.pop("capacity_factors")
x = moe.pop("x")
cfg = C.smoke_config("kimi-k2-1t-a32b").with_overrides(
    dtype="float32", opt_moe_shardmap=True)
mesh = make_test_mesh(data=2, model=2)
out = {}
for cf in cfs:
    ccfg = cfg.with_overrides(capacity_factor=float(cf))
    with jax.set_mesh(mesh):
        y, aux = jax.jit(lambda p, x: moe_ffn_sharded(p, x, ccfg, mesh))(
            moe, x)
    out[f"{cf}/out"] = np.asarray(y)
    out.update({f"{cf}/{k}": np.asarray(v) for k, v in aux.items()})
np.savez(os.path.join(work, "moe__jax.npz"), **out)
"""


def _nested(flat):
    """{"a/b": x} -> {"a": {"b": x}} (JAX param trees are dicts)."""
    out = {}
    for key, v in flat.items():
        node = out
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _want(new_p, new_s, metrics):
    """A JAX fp32-moment step's results under the keys the worker writes,
    with the int8 codes JAX's ``_q8`` gives its new moments (the codes an
    int8-moment step from a fresh state stores: zero codes dequantize to
    exactly 0, so that step's moments, params and metrics are the
    fp32-moment step's)."""
    out = {f"metric/{k}": np.asarray(v) for k, v in metrics.items()}
    out.update({f"param/{k}": v for k, v in _flat(new_p).items()})
    for mom in ("m", "v"):
        out.update({f"{mom}/{k[:-len(f'/{mom}')]}": np.asarray(
            j_q8(jnp.asarray(v))["q"])
            for k, v in _flat(new_s["mu"]).items() if k.endswith(f"/{mom}")})
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(cmd, env):
    return subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Writes the inputs, starts the gloo worker and the JAX sharded-MoE
    subprocess (four host devices), computes JAX's unsharded steps
    meanwhile, and returns
    {case: {"fp32" | "int8": (jax, port)}} and the MoE results."""
    work = str(tmp_path_factory.mktemp("mesh"))
    cases, jax_steps = {}, {}
    for name, (arch, over) in CASES.items():
        cfg = j_configs.smoke_config(arch).with_overrides(
            dtype="float32", grad_accum=2, **over)
        params = j_init(jax.random.PRNGKey(0), cfg)
        batch = next(j_lm_stream(cfg, 8, 16, seed=3))
        np.savez(os.path.join(work, f"{name}__params.npz"), **_flat(params))
        np.savez(os.path.join(work, f"{name}__batch.npz"), **_flat(batch))
        cases[name] = {"arch": arch, "lr": LR,
                       "over": dict(dtype="float32", grad_accum=2, **over)}
        jax_steps[name] = (cfg, params, batch)
    with open(os.path.join(work, "cases.json"), "w") as f:
        json.dump(cases, f)
    mcfg = j_configs.smoke_config("kimi-k2-1t-a32b").with_overrides(
        dtype="float32")
    moe = _flat(j_init_moe(jax.random.PRNGKey(1), mcfg))
    moe["x"] = np.asarray(jax.random.normal(jax.random.PRNGKey(2),
                                            (4, 16, mcfg.d_model)))
    np.savez(os.path.join(work, "moe.npz"), capacity_factors=np.array(
        CAPACITY), **moe)

    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    worker = _run([sys.executable, "tests/torch_mesh_worker.py", work,
                   str(_free_port())], env)
    jax_sub = _run([sys.executable, "-c", JAX_MOE, work], env)
    try:
        out = {}
        for name, (cfg, params, batch) in jax_steps.items():
            oc = JOC(lr=LR, warmup_steps=1)
            step = jax.jit(lambda p, o, b: j_train_step(p, o, b, cfg, oc))
            want = _want(*step(params, j_adamw_init(params, oc), batch))
            out[name] = {"fp32": want, "int8": want}
        w_out, w_err = worker.communicate(timeout=600)
        j_out, j_err = jax_sub.communicate(timeout=600)
    finally:
        for p in (worker, jax_sub):
            if p.poll() is None:
                p.kill()
                p.wait()
    assert worker.returncode == 0, w_err[-4000:]
    assert jax_sub.returncode == 0, j_err[-4000:]
    for name in out:
        for tag in out[name]:
            port = dict(np.load(os.path.join(work,
                                             f"{name}__{tag}__port.npz")))
            out[name][tag] = (out[name][tag], port)
    moe_res = (dict(np.load(os.path.join(work, "moe__jax.npz"))),
               dict(np.load(os.path.join(work, "moe__port.npz"))))
    return out, moe_res


@pytest.mark.parametrize("tag", ["fp32", "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_train_step_loss_and_metrics_match_jax(runs, case, tag):
    want, got = runs[0][case][tag]
    for key in (k for k in want if k.startswith("metric/")):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-7,
                                   err_msg=f"{case} {tag} {key}")


@pytest.mark.parametrize("tag", ["fp32", "int8"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_train_step_params_match_jax(runs, case, tag):
    want, got = runs[0][case][tag]
    keys = [k for k in want if k.startswith("param/")]
    assert sorted(keys) == sorted(k for k in got if k.startswith("param/"))
    for key in keys:
        w, g = want[key].astype(np.float64), got[key].astype(np.float64)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-6 * np.abs(w).max() + 5e-2 * LR,
                                   err_msg=f"{case} {tag} {key}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_train_step_int8_codes_within_one(runs, case):
    """The int8 moments' codes against JAX's: at most 1 apart; the share
    that differs is printed (``-s``) and must stay under 1%."""
    want, got = runs[0][case]["int8"]
    keys = [k for k in want if k.startswith(("m/", "v/"))]
    assert keys and sorted(keys) == sorted(k for k in got
                                           if k.startswith(("m/", "v/")))
    n = differ = 0
    for key in keys:
        d = np.abs(got[key].astype(np.int32) - want[key].astype(np.int32))
        assert d.max() <= 1, f"{case} {key}: codes {d.max()} apart"
        n += d.size
        differ += int((d > 0).sum())
    print(f"{case}: {differ} of {n} int8 moment codes differ by 1 "
          f"({differ / n:.2e})")
    assert differ / n < 1e-2


@pytest.mark.parametrize("cf", CAPACITY)
def test_moe_ffn_sharded_matches_jax_sharded_dispatch(runs, cf):
    jax_res, port = runs[1]
    for key in (k for k in jax_res if k.startswith(f"{cf}/")):
        np.testing.assert_allclose(port[key], jax_res[key], rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    dropped = float(jax_res[f"{cf}/fraction_dropped"])
    assert (dropped > 0) == (cf == min(CAPACITY)), dropped
