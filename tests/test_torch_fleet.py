"""The port's fleet layer: twins of the JAX package's agent, gate,
orchestrator and deployment tests, the smoke-size VQI lifecycle run by
both packages from one set of JAX-initialised params and JAX-made batches
(same rollout outcomes, audit events, active versions, telemetry counts
and inspection predictions), the telemetry hub against the JAX hub, and
distribution tests of the port's VQI batches."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from scipy import stats  # noqa: E402

from repro.api import ArtifactRegistry as JRegistry  # noqa: E402
from repro.api import ModelArtifact as JArtifact  # noqa: E402
from repro.data import VQITask as JTask  # noqa: E402
from repro.data import vqi_batch as j_vqi_batch  # noqa: E402
from repro.data import vqi_eval_accuracy as j_eval_accuracy  # noqa: E402
from repro.fleet import vqi as j_vqi  # noqa: E402
from repro.fleet.telemetry import InferenceRecord as JRecord  # noqa: E402
from repro.fleet.telemetry import TelemetryHub as JHub  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.api import (ArtifactRegistry, Deployment,  # noqa: E402
                             DeviceProfile, EdgeAgent, InferenceRecord,
                             InstallError, ModelArtifact, TelemetryHub,
                             VariantSpec)
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.core.quant import QuantConfig, quantize_tree  # noqa: E402
from repro_torch.data import (CENTROID_SEED, IGNORE, VQITask,  # noqa: E402
                              vqi_batch, vqi_eval_accuracy, vqi_stream)
from repro_torch.fleet import (FleetOrchestrator, FleetSimulator,  # noqa: E402
                               HealthGate)
from repro_torch.fleet import vqi as t_vqi  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving import RequestQueue  # noqa: E402

SPECS = [VariantSpec.fp32(), VariantSpec.dynamic_int8(),
         VariantSpec.static_int8(calib_batches=2)]
ALWAYS_OK = {"accuracy": 1.0, "mean_latency_ms": 1.0}


@pytest.fixture
def setup(tmp_path):
    cfg = t_configs.smoke_config("stablelm-1.6b").with_overrides(
        dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    registry = ArtifactRegistry(str(tmp_path / "registry"))
    return cfg, params, registry


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                   (2, 24)))}


def _calib(cfg, n=2):
    return [_batch(cfg, 100 + i) for i in range(n)]


def _bumped(node):
    """Every float leaf times 1.01 (the JAX tests' v2)."""
    if isinstance(node, dict):
        return {k: _bumped(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_bumped(v) for v in node]
    return node * 1.01 if node.is_floating_point() else node


# --------------------------------------------------------------------- #
# Twins of the JAX package's fleet tests
# --------------------------------------------------------------------- #
def test_device_profile_admission(setup):
    cfg, params, registry = setup
    fp = registry.publish("m", "v1", params, cfg, "fp32")
    tiny = DeviceProfile("tiny", memory_bytes=1000,
                         allowed_variants=("static_int8",))
    agent = EdgeAgent("dev-0", registry, tiny, device="cpu")
    with pytest.raises(InstallError, match="variant"):
        agent.install(fp)
    small = DeviceProfile("small", memory_bytes=1000)
    with pytest.raises(InstallError, match="exceeds"):
        EdgeAgent("dev-1", registry, small, device="cpu").install(fp)


def test_install_activate_rollback(setup):
    cfg, params, registry = setup
    v1 = registry.publish("m", "v1", params, cfg, "fp32")
    v2 = registry.publish("m", "v2", _bumped(params), cfg, "fp32")
    agent = EdgeAgent("dev-0", registry, DeviceProfile(memory_bytes=10**10),
                      device="cpu")
    agent.activate(v1)
    batch = _batch(cfg)
    out1 = agent.infer(batch)
    agent.activate(v2)
    assert agent.active.version == "v2"
    assert not torch.equal(agent.infer(batch), out1)
    prev = agent.rollback()
    assert prev.version == "v1" and agent.active.version == "v1"
    assert torch.equal(agent.infer(batch), out1), \
        "rollback must restore v1 behaviour"
    assert [e["kind"] for e in agent.events] == [
        "installed", "activated", "installed", "activated", "rollback",
        "activated"]
    assert agent.session.device.type == "cpu"
    health = agent.health()
    assert health["calls"] == 1 and health["active"] == "m:v1:fp32"


def test_health_gate():
    gate = HealthGate(max_accuracy_drop=0.02, max_latency_ratio=1.5)
    base = {"accuracy": 0.95, "mean_latency_ms": 100.0}
    assert gate.ok(base, {"accuracy": 0.94, "mean_latency_ms": 120.0})
    assert not gate.ok(base, {"accuracy": 0.80, "mean_latency_ms": 100.0})
    assert not gate.ok(base, {"accuracy": 0.95, "mean_latency_ms": 500.0})
    assert "p99" in HealthGate(max_p99_ratio=2.0).reason(
        {"p99_latency_ms": 10.0}, {"p99_latency_ms": 30.0})


def test_orchestrator_variant_policy(setup):
    cfg, params, registry = setup
    registry.publish("m", "v1", params, cfg, "fp32")
    qp, _ = quantize_tree(params, QuantConfig("static_int8", min_size=1024))
    registry.publish("m", "v1", qp, cfg, "static_int8")
    orch = FleetOrchestrator(registry)
    orch.register_device(EdgeAgent("big", registry,
                                   DeviceProfile("std", 8 * 1024**3),
                                   device="cpu"))
    orch.register_device(EdgeAgent(
        "small", registry,
        DeviceProfile("pi4", 4 * 1024**3,
                      allowed_variants=("static_int8", "dynamic_int8")),
        device="cpu"))
    report = orch.rollout("m", "v1", validate=lambda a: ALWAYS_OK)
    assert report.succeeded
    st = orch.status()
    assert st["big"]["active"].endswith(":fp32")
    assert st["small"]["active"].endswith(":static_int8")


def test_lifecycle_through_the_artifact_api(setup):
    cfg, params, registry = setup
    v1 = registry.publish_variants(
        ModelArtifact.create("m", "v1", params, cfg), [VariantSpec.fp32()])
    v2 = registry.publish_variants(
        ModelArtifact.create("m", "v2", _bumped(params), cfg),
        [VariantSpec.fp32()])
    agent = EdgeAgent("dev-0", registry, DeviceProfile(memory_bytes=10**10),
                      device="cpu")
    agent.activate(v1["fp32"].ref)
    assert agent.artifact.key == "m:v1:fp32"
    batch = _batch(cfg)
    out1 = agent.infer(batch)
    agent.activate(v2["fp32"].ref)
    assert agent.artifact.version == "v2"
    prev = agent.rollback()
    assert prev.version == "v1" and agent.artifact.version == "v1"
    assert torch.equal(agent.infer(batch), out1)
    assert "rollback" in [e["kind"] for e in agent.events]


def test_admission_rejection_on_a_constrained_profile(setup):
    cfg, params, registry = setup
    published = registry.publish_variants(
        ModelArtifact.create("m", "v1", params, cfg), SPECS,
        calib_data=_calib(cfg))
    pi4 = DeviceProfile("edge-pi4-4gb", 4 * 1024**3,
                        allowed_variants=("static_int8", "dynamic_int8"))
    agent = EdgeAgent("dev-pi", registry, pi4, device="cpu")
    with pytest.raises(InstallError, match="variant fp32 not allowed"):
        agent.install(published["fp32"].ref)
    assert [e["kind"] for e in agent.events] == ["install_rejected"]
    agent.activate(published["static_int8"].ref)
    assert agent.artifact.variant == "static_int8"


def test_deployment_facade(setup):
    cfg, params, registry = setup
    dep = Deployment(registry, model="m")
    dep.add_device("big", DeviceProfile("std", 8 * 1024**3), device="cpu")
    dep.add_device("small",
                   DeviceProfile("pi4", 4 * 1024**3,
                                 allowed_variants=("static_int8",
                                                   "dynamic_int8")),
                   device="cpu")
    dep.publish(ModelArtifact.create("m", "v1", params, cfg), SPECS,
                calib_data=_calib(cfg))
    report = dep.rollout(validate=lambda a: ALWAYS_OK)
    assert report.succeeded and report.version == "v1"
    st = dep.status()
    assert st["big"]["active"].endswith(":fp32")
    assert st["small"]["active"].endswith(":static_int8")
    assert dep.active_versions() == {"big": "v1", "small": "v1"}
    assert dep.rollback() == []          # nothing older to go back to
    with pytest.raises(ValueError, match="manages 'm'"):
        dep.publish(ModelArtifact.create("other", "v1", params, cfg), SPECS)
    with pytest.raises(KeyError, match="no draft variant"):
        dep.spec_config()                # no variant was published draft_of
    sim = dep.simulator()
    assert isinstance(sim, FleetSimulator) and sim.dep is dep
    assert sim.registry is registry and sim.hub is dep.telemetry
    with pytest.raises(ValueError, match="telemetry/variant_policy"):
        Deployment(registry, "m", fleet=dep.fleet, telemetry=TelemetryHub())


# --------------------------------------------------------------------- #
# The telemetry hub against the JAX hub
# --------------------------------------------------------------------- #
def test_telemetry_hub_matches_jax():
    rng = np.random.default_rng(9)
    hubs = (TelemetryHub(0.6, window=50, retrain_capacity=10),
            JHub(0.6, window=50, retrain_capacity=10))
    snaps = [hubs[0].snapshot("m:v1:fp32"), hubs[1].snapshot("m:v1:fp32")]
    for i in range(120):
        kw = dict(device_id=f"d{i % 3}",
                  model_key=("m:v1:fp32", "m:v1:static_int8")[i % 2],
                  latency_ms=float(rng.gamma(2.0, 3.0)),
                  asset_id=f"a{i % 7}",
                  prediction={"asset_type": "power_line",
                              "condition": "good"},
                  confidence=float(rng.uniform()),
                  correct=bool(rng.uniform() < 0.8), t=float(i))
        hubs[0].push(InferenceRecord(**kw))
        hubs[1].push(JRecord(**kw))
    assert hubs[0].summary() == hubs[1].summary()
    assert hubs[0].device_metrics() == hubs[1].device_metrics()
    for key in ("m:v1:fp32", "m:v1:static_int8", "absent"):
        assert hubs[0].model_metrics(key) == hubs[1].model_metrics(key)
    assert hubs[0].metrics_since("m:v1:fp32", snaps[0]) == \
        hubs[1].metrics_since("m:v1:fp32", snaps[1])
    assert hubs[0].asset_conditions == hubs[1].asset_conditions
    assert hubs[0].retraining_ready(10) and hubs[0].evicted_records == 70


# --------------------------------------------------------------------- #
# The VQI lifecycle in both packages
# --------------------------------------------------------------------- #
def _to_torch(b):
    return {k: (torch.from_numpy(np.array(v)) if hasattr(v, "shape") else v)
            for k, v in b.items()}


def _run_lifecycle(pkg, root, v1, v2, calib, captures, probe):
    """Publish v1, roll it out to one standard and one Pi-4-class device,
    inspect ``captures``, publish v2 and roll it out. ``validate`` reports
    the share of ``probe`` images whose (asset, condition) equals the v1
    fp32 model's (random weights cannot classify) and no latency, so the
    gate's decision depends on the model alone."""
    Registry, Artifact, vqi, to_pkg, cfg = pkg
    registry = Registry(root)
    registry.publish_variants(Artifact.create("vqi", "v1", v1, cfg),
                              vqi.vqi_variant_specs(2), calib_data=calib)
    fleet = vqi.make_fleet(registry, 1, 1, **pkg_kw(pkg))
    ref_session = registry.get("vqi", "v1", "fp32",
                               **pkg_kw(pkg)).session(**pkg_kw(pkg))
    want = _predictions(ref_session.logits(to_pkg(probe)), cfg)

    def validate(agent):
        if agent.session is None:
            return {}
        got = _predictions(agent.infer(to_pkg(probe)), cfg)
        return {"accuracy": float(np.mean([g == w for g, w in
                                           zip(got, want)]))}

    reports = [fleet.rollout("vqi", "v1", validate=validate)]
    preds = []
    for did in sorted(fleet.devices):
        pipe = vqi.inspection_pipeline(fleet.devices[did], cfg,
                                       fleet.telemetry)
        for cap in captures:
            preds.append((did, pipe(to_pkg(cap))))
    registry.publish_variants(Artifact.create("vqi", "v2", v2, cfg),
                              vqi.vqi_variant_specs(2), calib_data=calib)
    reports.append(fleet.rollout("vqi", "v2", validate=validate))
    hub = fleet.telemetry
    return {
        "outcomes": [(r.version, r.succeeded, r.deployed, r.rolled_back)
                     for r in reports],
        "audit": [e["kind"] for e in fleet.audit],
        "events": {d: [e["kind"] for e in a.events]
                   for d, a in fleet.devices.items()},
        "active": {d: a.active.key for d, a in fleet.devices.items()},
        "telemetry": (hub.summary()["total_records"],
                      hub.summary()["assets"], hub.model_keys(),
                      [hub.model_metrics(k)["calls"]
                       for k in hub.model_keys()]),
        "predictions": preds,
        "canary": [sorted(r.canary_metrics) for r in reports],
    }


def pkg_kw(pkg):
    return {"device": "cpu"} if pkg[2] is t_vqi else {}


def _predictions(logits, cfg):
    lay = JTask().vocab_layout(cfg)
    off = cfg.n_frontend_tokens
    lg = np.asarray(logits.numpy() if isinstance(logits, torch.Tensor)
                    else logits)
    a = lg[:, off, lay["asset0"]:lay["asset0"] + 4].argmax(-1)
    c = lg[:, off + 1, lay["cond0"]:lay["cond0"] + 3].argmax(-1)
    return list(zip(a.tolist(), c.tolist()))


def test_vqi_lifecycle_matches_jax(tmp_path):
    jcfg = j_vqi.vqi_config(d_model=64)
    tcfg = t_vqi.vqi_config(d_model=64)
    assert tcfg == t_configs.smoke_config("phi-3-vision-4.2b").with_overrides(
        d_model=64, dtype="float32", n_frontend_tokens=8)
    v1 = j_init(jax.random.PRNGKey(0), jcfg)
    v2 = jax.tree.map(
        lambda x: x + jax.random.normal(jax.random.PRNGKey(3), x.shape,
                                        x.dtype)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, v1)
    task = JTask()

    def batch(seed, n):
        b = j_vqi_batch(jax.random.PRNGKey(seed), jcfg, task, n)
        return {k: b[k] for k in ("tokens", "frontend_embeds", "asset",
                                  "cond")}

    calib = [batch(40 + i, 4) for i in range(2)]
    probe = {k: v for k, v in batch(50, 16).items()
             if k in ("tokens", "frontend_embeds")}
    captures = []
    for i in range(2):
        cap = batch(60 + i, 3)
        cap["asset_ids"] = [f"tower-{i}-{j}" for j in range(3)]
        captures.append(cap)

    jax_run = _run_lifecycle(
        (JRegistry, JArtifact, j_vqi, lambda b: b, jcfg),
        str(tmp_path / "jax"), v1, v2, calib, captures, probe)
    bridge = lambda p: params_from_jax(jax.tree.map(np.asarray, p), tcfg,  # noqa: E731
                                       "cpu")
    port_run = _run_lifecycle(
        (ArtifactRegistry, ModelArtifact, t_vqi, _to_torch, tcfg),
        str(tmp_path / "port"), bridge(v1), bridge(v2),
        [_to_torch(c) for c in calib], captures, probe)

    assert port_run == jax_run
    # what the lifecycle must show, in both packages
    (_, ok1, deployed, _), (_, ok2, _, rolled) = port_run["outcomes"]
    assert ok1 and deployed == ["edge-std-0", "edge-pi4-0"]
    assert not ok2 and rolled == ["edge-std-0"]
    assert port_run["active"] == {"edge-std-0": "vqi:v1:fp32",
                                  "edge-pi4-0": "vqi:v1:static_int8"}
    assert port_run["telemetry"][0] == 12


# --------------------------------------------------------------------- #
# The port's VQI batches: layout and distributions
# --------------------------------------------------------------------- #
def test_vqi_batch_layout_matches_jax():
    cfg = t_vqi.vqi_config(d_model=64)
    task = VQITask()
    assert task.vocab_layout(cfg) == JTask().vocab_layout(cfg)
    got = vqi_batch(torch.Generator().manual_seed(0), cfg, task, 5, "cpu")
    want = j_vqi_batch(jax.random.PRNGKey(0), cfg, JTask(), 5)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
    assert got["frontend_embeds"].dtype == torch.float32
    assert got["tokens"].dtype == torch.int64
    lay = task.vocab_layout(cfg)
    assert (got["tokens"][:, 0] == lay["bos"]).all()
    assert torch.equal(got["tokens"][:, 1], lay["asset0"] + got["asset"])
    assert torch.equal(got["tokens"][:, 2], lay["cond0"] + got["cond"])
    assert torch.equal(got["labels"][:, :2], got["tokens"][:, 1:])
    assert (got["labels"][:, 2] == IGNORE).all()
    # a teacher-forced accuracy of the true class tokens is 1
    logits = torch.zeros((5, cfg.n_frontend_tokens + 3, cfg.vocab_size))
    logits[torch.arange(5), cfg.n_frontend_tokens,
           got["tokens"][:, 1]] = 1.0
    logits[torch.arange(5), cfg.n_frontend_tokens + 1,
           got["tokens"][:, 2]] = 1.0
    assert vqi_eval_accuracy(logits, got, cfg, task) == (1.0, 1.0)
    assert j_eval_accuracy(jnp.asarray(logits.numpy()),
                           {k: jnp.asarray(v.numpy()) for k, v in
                            got.items()}, cfg, JTask()) == (1.0, 1.0)


def test_vqi_batch_distributions():
    cfg = t_vqi.vqi_config(d_model=64)
    task = VQITask()
    b = vqi_batch(torch.Generator().manual_seed(5), cfg, task, 6000, "cpu")
    # class labels uniform (chi-square, p > 0.001)
    for labels, k in ((b["asset"], task.n_assets),
                      (b["cond"], task.n_conditions)):
        counts = torch.bincount(labels, minlength=k).numpy()
        assert stats.chisquare(counts).pvalue > 1e-3, counts
    # patches: the class centroid plus N(0, noise^2) noise
    gen = torch.Generator().manual_seed(CENTROID_SEED)
    centroids = torch.randn((task.n_assets, task.n_conditions,
                             cfg.frontend_dim), generator=gen) * 2.0
    resid = b["frontend_embeds"] - centroids[b["asset"], b["cond"]][:, None]
    assert abs(float(resid.mean())) < 0.01
    assert abs(float(resid.std()) - task.noise) < 0.01
    assert stats.normaltest(resid.flatten()[:20000].numpy()).pvalue > 1e-3
    assert abs(float(centroids.std()) - 2.0) < 0.2
    # the centroids belong to the dataset: any seed, any stream
    other = next(vqi_stream(cfg, 2000, seed=11, device="cpu"))
    resid2 = other["frontend_embeds"] - \
        centroids[other["asset"], other["cond"]][:, None]
    assert abs(float(resid2.std()) - task.noise) < 0.02
    again = vqi_batch(torch.Generator().manual_seed(5), cfg, task, 6000,
                      "cpu")
    assert all(torch.equal(again[k], b[k]) for k in b)


def test_inspection_queue_pushes_one_record_per_capture(tmp_path,
                                                        monkeypatch):
    cfg = t_vqi.vqi_config(d_model=64)
    params = init_params(cfg, seed=1, device="cpu")
    registry = ArtifactRegistry(str(tmp_path))
    registry.publish("vqi", "v1", params, cfg)
    fleet = t_vqi.make_fleet(registry, 1, 0, device="cpu")
    agent = fleet.devices["edge-std-0"]
    agent.activate(registry.ref("vqi", "v1"))
    pipe = t_vqi.inspection_pipeline(agent, cfg, fleet.telemetry)

    def stack(raws):
        out = {k: torch.cat([r[k] for r in raws]) for k in raws[0]
               if k != "asset_ids"}
        out["asset_ids"] = [a for r in raws for a in r["asset_ids"]]
        return out

    queue = RequestQueue(pipe, max_batch=4, stack=stack,
                         unstack=lambda res, n: [[p] for p in res])
    gen = torch.Generator().manual_seed(2)
    reqs = []
    for i in range(6):
        raw = vqi_batch(gen, cfg, VQITask(), 1, "cpu")
        raw["asset_ids"] = [f"asset-{i}"]
        reqs.append(queue.submit(raw))
    queue.drain()
    assert all(r.done for r in reqs)
    assert [len(r.result) for r in reqs] == [1] * 6
    hub = fleet.telemetry
    assert hub.total_records == 6 and len(hub.asset_conditions) == 6
    assert hub.model_metrics("vqi:v1:fp32")["calls"] == 6
    assert agent.health()["calls"] == 2          # two batches of 4 and 2
    # training is ported: like every entry point, it runs on the card
    # unless asked for the CPU, and raises when there is none
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_vqi.train_vqi_model(cfg)


def test_vqi_publish_variants_shim_matches_jax(tmp_path):
    """``fleet.vqi.publish_variants`` (the JAX package's shim) publishes the
    three variants with their evaluation metrics, as the JAX shim does from
    the same params; calibration batches are each package's own draws."""
    jcfg = j_vqi.vqi_config(d_model=64)
    tcfg = t_vqi.vqi_config(d_model=64)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    j_registry = JRegistry(str(tmp_path / "jax"))
    registry = ArtifactRegistry(str(tmp_path / "port"))
    want = j_vqi.publish_variants(j_registry, "vqi", "v1", jp, jcfg,
                                  calib_batches=2)
    got = t_vqi.publish_variants(registry, "vqi", "v1", tp, tcfg,
                                 calib_batches=2, device="cpu")
    assert sorted(got) == sorted(want) == [
        "dynamic_int8", "fp32", "static_int8"]
    for variant, ref in got.items():
        assert ref == registry.ref("vqi", "v1", variant)
        assert ref.size_bytes == want[variant].size_bytes, variant
        metrics = registry.get("vqi", "v1", variant, device="cpu").metrics
        assert sorted(metrics) == sorted(
            j_registry.get("vqi", "v1", variant).metrics)
        assert 0.0 <= metrics["accuracy"] <= 1.0
    static = registry.get("vqi", "v1", "static_int8", device="cpu").params
    assert "act_scale" in static["frontend_proj"]
    assert all("act_scale" in layer["attn"]["wq"]
               for layer in static["layers"])
