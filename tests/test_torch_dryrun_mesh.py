"""The port's dry-run (``repro_torch.launch.dryrun``, ``step_analysis``)
on fake worlds in this process, and its production launcher in a
subprocess:

- the (2, 2, 2) fake-world records of the phi3-mini, kimi-k2 and mamba2
  smoke train steps (``grad_accum=2``, as ``tests/test_dryrun.py`` runs
  JAX's) count flops, and phi3-mini's data-parallel grads all-reduce;
- a hand-built step with one all-gather, one all-reduce and one
  reduce-scatter gives their exact bytes, as ``test_collective_parser``
  holds JAX's parser;
- at a world of 1 the stablelm smoke train step's matmul flops equal
  ``analyze_hlo``'s of JAX's compiled step within 2% (they agree
  exactly);
- ``run_one`` returns every key of JAX's record;
- ``python -m repro_torch.launch.train --arch stablelm-1.6b --production``
  exits 0 here, prints both JSON blocks and never imports jax.

The records and the launcher run in two subprocesses started together
(one fake world a process).
"""
import contextlib
import functools
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.launch import specs as j_specs  # noqa: E402
from repro.launch.hlo_analysis import analyze_hlo  # noqa: E402
from repro.training.optimizer import OptimizerConfig as JOC  # noqa: E402
from repro.training.train_step import train_step as j_train_step  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import init_fake_world, make_test_mesh  # noqa: E402
from repro_torch.launch.step_analysis import analyze_step  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["phi3-mini-3.8b", "kimi-k2-1t-a32b", "mamba2-780m"]


@contextlib.contextmanager
def fake_world(n):
    assert not dist.is_initialized()
    init_fake_world(n)
    try:
        yield
    finally:
        dist.destroy_process_group()


MINI = r"""
import json, sys
from repro_torch import configs as C
from repro_torch.launch.dryrun import run_one
from repro_torch.launch.mesh import init_fake_world, make_test_mesh
init_fake_world(8)
mesh = make_test_mesh(data=2, model=2, pod=2)
for arch in sys.argv[1:]:
    cfg = C.smoke_config(arch).with_overrides(grad_accum=2)
    rec = run_one(arch, "train_4k", "multi", mesh=mesh, batch=8, seq=32,
                  cfg_override=cfg)
    print(f"RECORD_JSON {arch}:" + json.dumps(rec))
"""

PRODUCTION = r"""
import runpy, sys
sys.argv = ["train", "--arch", "stablelm-1.6b", "--production"]
runpy.run_module("repro_torch.launch.train", run_name="__main__")
print("JAX_IMPORTED", "jax" in sys.modules)
"""


@pytest.fixture(scope="module")
def subprocesses():
    """The (2, 2, 2) records of the three smoke configs (batch 8 x 32) in
    one process and the production launcher in another, started at the
    first test of this file (the tests in this process run meanwhile)
    and read, on first use, as {name: ((stdout, stderr), returncode)}."""
    env = dict(os.environ, PYTHONPATH="src")
    procs = {name: subprocess.Popen([sys.executable, "-c", *args], cwd=REPO,
                                    env=env, text=True,
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE)
             for name, args in (("mini", (MINI, *ARCHS)),
                                ("production", (PRODUCTION,)))}
    done = {}

    def result(name):
        if name not in done:
            done[name] = (procs[name].communicate(timeout=600),
                          procs[name].returncode)
        return done[name]

    yield result
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait()


@pytest.fixture(autouse=True, scope="module")
def _start_subprocesses(subprocesses):
    """Starts the subprocesses before the first test runs."""


def _record(subprocesses, arch):
    (stdout, stderr), rc = subprocesses("mini")
    assert rc == 0, stderr[-3000:]
    line = [ln for ln in stdout.splitlines()
            if ln.startswith(f"RECORD_JSON {arch}:")][0]
    return json.loads(line.split(":", 1)[1])


def test_collective_bytes_of_a_hand_built_step():
    """One all-gather of [4, 16] f32 over "data" (out [8, 16]), one
    all-reduce of a [4, 8] partial over "model", one reduce-scatter of an
    [8, 8] partial over "data" (out [4, 8]): output bytes, per device."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch._subclasses.fake_tensor import FakeTensorMode

    with fake_world(8):
        mesh = make_test_mesh(data=2, model=2, pod=2)
        fake = FakeTensorMode()
        fake.__enter__()
        rep = [Replicate()] * 3
        x = DTensor.from_local(torch.zeros(4, 16), mesh,
                               [Replicate(), Shard(0), Replicate()])
        y = DTensor.from_local(torch.zeros(4, 8), mesh,
                               [Replicate(), Replicate(), Partial()])
        z = DTensor.from_local(torch.zeros(8, 8), mesh,
                               [Replicate(), Partial(), Replicate()])

        def step(x, y, z):
            return (x.redistribute(mesh, rep), y.redistribute(mesh, rep),
                    z.redistribute(mesh, [Replicate(), Shard(0),
                                          Replicate()]))

        try:
            st = analyze_step(step, x, y, z)
        finally:
            fake.__exit__(None, None, None)
    assert st["collective_counts"] == {
        "all-gather": 1, "all-reduce": 1, "reduce-scatter": 1,
        "all-to-all": 0, "collective-permute": 0}
    assert st["collective_by_op"]["all-gather"] == 8 * 16 * 4
    assert st["collective_by_op"]["all-reduce"] == 4 * 8 * 4
    assert st["collective_by_op"]["reduce-scatter"] == 4 * 8 * 4
    assert st["collective_bytes"] == sum(st["collective_by_op"].values())
    assert st["flops"] == 0


def test_world_of_one_flops_match_jax_analyze_hlo():
    """The stablelm smoke train step (batch 8 x 32): the port's matmul
    flops at a world of 1 against ``analyze_hlo`` of JAX's compiled
    step, within 2%."""
    jcfg = j_configs.smoke_config("stablelm-1.6b")
    oc = JOC()
    fn = functools.partial(j_train_step, cfg=jcfg, oc=oc)
    compiled = jax.jit(fn).lower(
        j_specs.param_structs(jcfg), j_specs.opt_structs(jcfg, oc),
        j_specs.batch_structs(jcfg, 8, 32, train=True)).compile()
    want = analyze_hlo(compiled.as_text())["flops"]
    with fake_world(1):
        mesh = make_test_mesh(data=1, model=1)
        got, _, _ = dryrun.trace_on_mesh(
            t_configs.smoke_config("stablelm-1.6b"), "train_4k", mesh,
            batch=8, seq=32)
    assert want > 0
    assert abs(got["flops"] - want) <= 0.02 * want, (got["flops"], want)
    assert got["collective_bytes"] == 0


def test_a_mesh_the_world_does_not_fill_raises():
    with fake_world(4):
        with pytest.raises(RuntimeError, match="needs a world of 8"):
            make_test_mesh(data=2, model=2, pod=2)


@pytest.mark.parametrize("arch", ARCHS)
def test_mini_multipod_dryrun_counts_flops(subprocesses, arch):
    r = _record(subprocesses, arch)
    assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0
    m = r["memory"]
    assert m["peak_est_bytes"] > m["argument_bytes"] > 0


def test_mini_multipod_dryrun_data_parallel_grads_all_reduce(subprocesses):
    c = _record(subprocesses, "phi3-mini-3.8b")["collectives"]
    assert c["total_bytes"] > 0 and c["bytes_by_op"]["all-reduce"] > 0


def test_run_one_returns_every_key_of_jax_record(subprocesses):
    rec = _record(subprocesses, "phi3-mini-3.8b")
    assert set(rec) >= {
        "arch", "shape", "mesh", "tag", "n_devices", "params",
        "active_params", "lower_s", "compile_s", "flops_per_device",
        "bytes_per_device", "xla_cost_flops_once", "xla_cost_bytes_once",
        "collectives", "memory", "roofline"}
    assert set(rec["collectives"]) == {"bytes_by_op", "counts",
                                       "total_bytes"}
    assert set(rec["memory"]) == {
        "argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
        "peak_est_bytes", "hbm_per_chip"}
    assert set(rec["roofline"]) == {
        "compute_s", "memory_s", "collective_s", "dominant",
        "model_flops_total", "useful_flops_ratio"}
    assert rec["n_devices"] == 8


def test_production_launcher_runs_without_jax(subprocesses):
    (out, err), rc = subprocesses("production")
    assert rc == 0, err[-3000:]
    assert "JAX_IMPORTED False" in out
    dec = json.JSONDecoder()
    blocks, i = [], out.find("{")
    while i >= 0:
        obj, end = dec.raw_decode(out, i)
        blocks.append(obj)
        i = out.find("{", end)
    roofline, memory = blocks
    assert roofline["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert roofline["compute_s"] > 0 and memory["argument_bytes"] > 0
    assert memory["hbm_per_chip"] > 0
