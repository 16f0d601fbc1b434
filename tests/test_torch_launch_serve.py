"""The port's serving launcher (``repro_torch.launch.serve``, the twin of
``repro.launch.serve``) on the CPU, ad hoc and on a checkpoint the JAX
package wrote: every request served, each one's tokens equal to
``InferenceSession.generate`` on its payload (and, on the JAX checkpoint,
to the JAX session's); and a smoke run of each example twin this port
adds (``examples/*_torch.py``) at its smallest flags."""
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.serving import InferenceSession as JSession  # noqa: E402
from repro.training import save_checkpoint as j_save  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.core.quant import QuantConfig, quantize_tree  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving import InferenceSession  # noqa: E402
from repro_torch.training import load_checkpoint  # noqa: E402

EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir, "examples")
ARCH = "stablelm-1.6b"
NEW = 4


@pytest.mark.parametrize("quant", ["none", "dynamic_int8"])
@pytest.mark.parametrize("source", ["smoke", "jax_checkpoint"])
def test_serve_launcher_tokens_equal_generate(tmp_path, source, quant):
    argv = ["--arch", ARCH, "--requests", "5", "--max-batch", "2",
            "--new-tokens", str(NEW), "--quant", quant, "--seed", "3",
            "--device", "cpu"]
    jparams = None
    if source == "jax_checkpoint":
        jcfg = j_configs.smoke_config(ARCH).with_overrides(dtype="float32")
        jparams = j_init(jax.random.PRNGKey(1), jcfg)
        j_save(str(tmp_path / "ckpt"), jparams, jcfg)
        argv += ["--checkpoint", str(tmp_path / "ckpt")]
        params, cfg, _ = load_checkpoint(str(tmp_path / "ckpt"), "cpu")
    else:
        cfg = t_configs.smoke_config(ARCH).with_overrides(dtype="float32")
        params = init_params(cfg, seed=3, device="cpu")
    reqs = serve.main(argv)
    assert len(reqs) == 5 and all(r.done for r in reqs)
    if quant != "none":
        params, _ = quantize_tree(params, QuantConfig(mode=quant,
                                                      min_size=1024))
    session = InferenceSession(params, cfg, device="cpu")
    for r in reqs:
        assert r.result.shape == (1, NEW)
        assert torch.equal(r.result, session.generate(r.payload, NEW))
    if jparams is not None and quant == "none":
        want = JSession(jparams, jcfg).generate(
            {"tokens": jnp.asarray(np.concatenate(
                [r.payload["tokens"].numpy() for r in reqs]))}, NEW)
        np.testing.assert_array_equal(
            torch.cat([r.result for r in reqs]).numpy(), np.asarray(want))


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name,argv", [
    ("fleet_sim_torch", ["--fast", "--devices", "24"]),
    ("quantized_serving_torch", ["--scale", "64", "--iters", "2", "--seq",
                                 "32"]),
    ("continuous_batching_torch", []),
    ("paged_serving_torch", ["--fast"]),
])
def test_example_twin_runs_on_the_cpu(name, argv):
    """Each example's ``main`` completes its own self-asserts on the CPU."""
    out = _example(name).main(argv + ["--device", "cpu"])
    assert out


def test_fleet_sim_example_log_equals_the_jax_example(tmp_path):
    """The two examples' scenario (their own ``publish`` and ``simulate``,
    24 devices, the ``--fast`` horizon) gives byte-identical event logs:
    only artifact sizes enter the log, and the port's equal JAX's on the
    same config. The 1000-device digest is the examples' own output."""
    from repro.api import ArtifactRegistry as JRegistry
    from repro.fleet.vqi import vqi_config as j_vqi_config
    from repro_torch.api import ArtifactRegistry

    jex, tex = _example("fleet_sim"), _example("fleet_sim_torch")
    jcfg = j_vqi_config(d_model=64)
    jex.publish(JRegistry(str(tmp_path / "jax")), jcfg,
                j_init(jax.random.PRNGKey(0), jcfg))
    tcfg = tex.vqi_config(d_model=64)
    tex.publish(ArtifactRegistry(str(tmp_path / "port")), tcfg,
                init_params(tcfg, seed=0, device="cpu"), "cpu")
    want = jex.simulate(JRegistry(str(tmp_path / "jax")), 24, 0, 800.0)
    got = tex.simulate(ArtifactRegistry(str(tmp_path / "port")), 24, 0,
                       800.0, "cpu")
    assert got.event_log_json() == want.event_log_json()
    assert got.metrics() == want.metrics()
