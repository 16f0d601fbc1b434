"""The port's event-driven fleet simulator against the JAX package's, on
bridged weights: twins of every simulator test in ``tests/test_fleet_sim.py``
(same seed same log, gate regression rollback, mid-wave install-failure
abort, offline reconvergence, straggler resume, shared engines, windowed
telemetry), each scenario's ``event_log_json()`` byte-identical to JAX's and
its ``metrics()`` equal, and the ``EnginePool``'s per-device-class paged
engines (budgets, blocks, ``memory_report()``, streams, preemptions, prefix
hits), its tp=2 engine and its router against JAX's on the same prompts."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import api as japi  # noqa: E402
from repro import configs as j_configs  # noqa: E402
from repro.fleet import simulator as j_sim  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro_torch import api as tapi  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.fleet import simulator as t_sim  # noqa: E402
from repro_torch.serving.kvcache import kv_bytes_per_block  # noqa: E402

ARCH = "stablelm-1.6b"
KV_BLOCK = 8


class _Pkg:
    """One package's names, and the device keyword its agents and pools
    take (JAX: the default backend; the port: the CPU)."""

    def __init__(self, api, sim, registry, device_kw):
        self.api, self.sim, self.registry = api, sim, registry
        self.kw = device_kw

    def spec(self, did, **kw):
        return self.sim.DeviceSpec(
            did, self.api.DeviceProfile(memory_bytes=10**10), **self.kw,
            **kw)

    def policy(self, **kw):
        return self.api.RolloutPolicy(
            **{"gate": self.api.HealthGate(max_accuracy_drop=0.1), **kw})


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX's smoke setup (``tests/test_fleet_sim.py``) published by both
    packages from the same params: fp32 and dynamic_int8, v1 and v2."""
    jcfg = j_configs.smoke_config(ARCH).with_overrides(dtype="float32")
    tcfg = t_configs.smoke_config(ARCH).with_overrides(dtype="float32")
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    root = tmp_path_factory.mktemp("reg")
    jreg = japi.ArtifactRegistry(str(root / "jax"))
    treg = tapi.ArtifactRegistry(str(root / "port"))
    for version in ("v1", "v2"):
        jpub = jreg.publish_variants(
            japi.ModelArtifact.create("m", version, jp, jcfg),
            [japi.VariantSpec.fp32(), japi.VariantSpec.dynamic_int8()])
        tpub = treg.publish_variants(
            tapi.ModelArtifact.create("m", version, tp, tcfg),
            [tapi.VariantSpec.fp32(), tapi.VariantSpec.dynamic_int8()])
        for variant, art in tpub.items():
            assert art.sha256 == jpub[variant].sha256, variant
    return {"jax": _Pkg(japi, j_sim, jreg, {}),
            "port": _Pkg(tapi, t_sim, treg, {"device": "cpu"}),
            "jcfg": jcfg, "tcfg": tcfg, "jp": jp, "tp": tp}


# --------------------------------------------------------------------- #
# Scenarios: each runs in both packages, then checks the port's run
# --------------------------------------------------------------------- #
ALL_FAULTS = {"offline_rate_per_hour": 4.0, "install_fail_rate": 0.1,
              "slow_link_rate": 0.2, "flaky_probe_rate": 0.1}


def _sim(pkg, n=24, seed=0, faults=None, workload=None, policy=None):
    """``tests/test_fleet_sim.py``'s ``_sim``: a heterogeneous fleet of
    ``n`` devices and its three-wave policy."""
    dep = pkg.api.Deployment(pkg.registry, model="m")
    sim = dep.simulator(seed=seed, faults=faults or pkg.api.FaultPlan(),
                        workload=workload or pkg.api.WorkloadModel())
    sim.add_heterogeneous_fleet(n, inspection_interval_s=5.0, **pkg.kw)
    sim.policy = policy or pkg.policy(waves=(0.1, 0.5, 1.0), soak_s=15.0,
                                      install_stagger_s=0.2)
    return sim


def _all_faults(pkg, seed):
    sim = _sim(pkg, seed=seed, faults=pkg.api.FaultPlan(**ALL_FAULTS))
    sim.schedule_rollout("v1", sim.policy, at=10.0)
    sim.run(until=400.0)
    return sim


def _gate_regression(pkg):
    sim = _sim(pkg, workload=pkg.api.WorkloadModel(
        version_error_rate={"v2": 0.6}))
    sim.schedule_rollout("v1", sim.policy, at=10.0)
    sim.schedule_rollout("v2", sim.policy, at=300.0)
    sim.run(until=700.0)
    return sim


def _check_gate_regression(sim):
    v1, v2 = sim.rollouts
    assert v1.status == "complete"
    assert v2.status == "aborted"
    assert "health gate" in v2.reason
    assert v2.mttr_s is not None and v2.mttr_s > 0
    kinds = [e["kind"] for e in sim.events]
    assert "gate_failed" in kinds and "rollout_rolled_back" in kinds
    for agent in sim.dep.devices.values():
        assert agent.active is not None and agent.active.version == "v1"


def _midwave_install_failure(pkg):
    sim = _sim(pkg)
    sim.schedule_rollout("v1", sim.policy, at=10.0)
    sim.run(until=250.0)
    assert sim.rollouts[0].status == "complete"
    # devices 3..11 land in wave 1 of the (0.1, 0.5, 1.0) partition
    dids = list(sim.dep.devices)
    sim.faults = pkg.api.FaultPlan(install_fail_devices=frozenset(dids[3:12]))
    policy = pkg.policy(waves=(0.1, 0.5, 1.0), soak_s=15.0,
                        install_stagger_s=0.2, max_wave_failure_fraction=0.2)
    sim.schedule_rollout("v2", policy, at=260.0)
    sim.run(until=700.0)
    return sim


def _check_midwave_install_failure(sim):
    v2 = sim.rollouts[1]
    assert v2.status == "aborted"
    assert "installs failed" in v2.reason
    for agent in sim.dep.devices.values():
        assert agent.active is not None and agent.active.version == "v1"
    kinds = [e["kind"] for e in sim.events]
    assert "install_failed" in kinds and "rollout_aborted" in kinds


def _offline_reconverge(pkg):
    dep = pkg.api.Deployment(pkg.registry, model="m")
    sim = dep.simulator(seed=1, faults=pkg.api.FaultPlan(
        offline_windows={"dev-1": ((20.0, 300.0),)}))
    for i in range(6):
        sim.add_device(pkg.spec(f"dev-{i}", inspection_interval_s=5.0))
    sim.schedule_rollout("v1", pkg.policy(waves=(0.2, 1.0), soak_s=15.0),
                         at=50.0)
    sim.run(until=250.0)
    ro = sim.rollouts[0]
    assert ro.status == "complete"
    assert "dev-1" in ro.pending                  # straggler, still offline
    assert sim.dep.devices["dev-1"].active is None
    assert "install_deferred" in [e["kind"] for e in sim.events]
    sim.run(until=500.0)                          # device back at t=300
    return sim


def _check_offline_reconverge(sim):
    ro = sim.rollouts[0]
    assert "device_reconverged" in [e["kind"] for e in sim.events]
    assert sim.dep.devices["dev-1"].active.version == "v1"
    assert not ro.pending
    assert ro.convergence_s > 250.0


def _straggler_resume(pkg):
    """A device offline through rollout A re-converges on reconnect even
    when rollout B is already scheduled."""
    dep = pkg.api.Deployment(pkg.registry, model="m")
    sim = dep.simulator(seed=3, faults=pkg.api.FaultPlan(
        offline_windows={"dev-2": ((20.0, 300.0),)}))
    for i in range(5):
        sim.add_device(pkg.spec(f"dev-{i}", inspection_interval_s=5.0))
    policy = pkg.policy(waves=(0.2, 1.0), soak_s=15.0)
    sim.schedule_rollout("v1", policy, at=50.0)       # dev-2 misses this
    sim.schedule_rollout("v2", policy, at=600.0)      # queued up front
    sim.run(until=500.0)                              # dev-2 back at t=300
    assert sim.rollouts[0].status == "complete"
    assert sim.dep.devices["dev-2"].active.version == "v1"
    assert "device_reconverged" in [e["kind"] for e in sim.events]
    sim.run(until=1200.0)
    return sim


def _check_straggler_resume(sim):
    assert sim.rollouts[1].status == "complete"
    assert sim.dep.devices["dev-2"].active.version == "v2"


def _windowed_telemetry(pkg):
    hub = pkg.api.TelemetryHub(window=200)
    dep = pkg.api.Deployment(pkg.registry, model="m", telemetry=hub)
    sim = dep.simulator(seed=2)
    sim.add_heterogeneous_fleet(12, inspection_interval_s=2.0, **pkg.kw)
    sim.schedule_rollout("v1", pkg.api.RolloutPolicy(waves=(1.0,),
                                                     gated_waves=0), at=1.0)
    sim.run(until=500.0)
    return sim


def _check_windowed_telemetry(sim):
    ts = sim.metrics()["telemetry"]
    assert ts["retained_records"] == 200
    assert ts["evicted_records"] == ts["total_records"] - 200
    assert ts["total_records"] > 1000


def _check_canary_abort(sim):
    """Seed 7: a canary exhausts its install retries; the rollout aborts
    and the other canary's rollback finds nothing to roll back to."""
    ro = sim.rollouts[0]
    assert ro.status == "aborted" and "installs failed" in ro.reason
    kinds = [e["kind"] for e in sim.events]
    assert {"device_offline", "install_failed", "rollback_failed",
            "rollout_rolled_back"} <= set(kinds)


def _check_faults_absorbed(sim):
    """Seed 8: offline churn, a deferred install that resumes, flaky
    probes and slow links, and the rollout still completes."""
    assert sim.rollouts[0].status == "complete"
    kinds = [e["kind"] for e in sim.events]
    assert {"device_offline", "install_deferred", "device_reconverged",
            "probe_flaky", "install_failed"} <= set(kinds)
    assert any(e.get("slow_link") for e in sim.events)


SCENARIOS = {
    "all_faults_seed7": (lambda pkg: _all_faults(pkg, 7),
                         _check_canary_abort),
    "all_faults_seed8": (lambda pkg: _all_faults(pkg, 8),
                         _check_faults_absorbed),
    "gate_regression": (_gate_regression, _check_gate_regression),
    "midwave_install_failure": (_midwave_install_failure,
                                _check_midwave_install_failure),
    "offline_reconverge": (_offline_reconverge, _check_offline_reconverge),
    "straggler_resume": (_straggler_resume, _check_straggler_resume),
    "windowed_telemetry": (_windowed_telemetry, _check_windowed_telemetry),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_sim_scenario_matches_jax(setup, name):
    """The port's run passes the JAX test's checks, and its event log is
    byte-identical to JAX's, its ``metrics()`` equal."""
    run, check = SCENARIOS[name]
    got = run(setup["port"])
    check(got)
    want = run(setup["jax"])
    assert got.event_log_json() == want.event_log_json()
    assert got.metrics() == want.metrics()
    assert all(a.session is None or a.session.device.type == "cpu"
               for a in got.dep.devices.values())


def test_simulator_same_seed_identical_event_log(setup):
    pkg = setup["port"]

    def go(seed):
        return _all_faults(pkg, seed).event_log_json()

    assert go(7) == go(7)
    assert go(7) != go(8)


def test_sim_devices_share_device_pinned_engines(setup):
    """One fetch and one session for the whole fleet; the shared session's
    logits equal JAX's ``ModelArtifact.session().logits`` on the same
    batch."""
    pkg = setup["port"]
    dep = tapi.Deployment(pkg.registry, model="m")
    sim = dep.simulator(seed=0)
    for i in range(4):
        sim.add_device(pkg.spec(f"dev-{i}"))
    sim.schedule_rollout("v1", tapi.RolloutPolicy(waves=(1.0,),
                                                  gated_waves=0), at=1.0)
    sim.run(until=60.0)
    agents = list(sim.dep.devices.values())
    assert all(a.active is not None for a in agents)
    assert sim.pool.fetches == 1
    assert len({id(a.session) for a in agents}) == 1
    assert all(a.health()["stats_scope"] == "fleet-shared" for a in agents)
    tokens = np.random.default_rng(0).integers(
        0, setup["tcfg"].vocab_size, (2, 24))
    out = agents[0].infer({"tokens": torch.as_tensor(tokens)})
    want = japi.ModelArtifact.create("m", "v1", setup["jp"], setup["jcfg"]) \
        .session(backend="ref").logits({"tokens": jnp.asarray(tokens)})
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    assert list(sim.pool.stats()) == ["m:v1:fp32@cpu"]


def test_sim_real_inferences_land_in_the_pool_session(setup):
    """``real_every``: every n-th inspection runs a real forward through
    the shared session (its calls are counted, the event log is not
    touched)."""
    pkg = setup["port"]
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int64)}

    def run(real_every):
        dep = tapi.Deployment(pkg.registry, model="m")
        sim = dep.simulator(seed=0, real_every=real_every,
                            real_batch=lambda agent: batch)
        for i in range(3):
            sim.add_device(pkg.spec(f"dev-{i}", inspection_interval_s=5.0))
        sim.schedule_rollout("v1", tapi.RolloutPolicy(waves=(1.0,),
                                                      gated_waves=0), at=1.0)
        sim.run(until=100.0)
        return sim

    real, plain = run(4), run(0)
    assert real.event_log_json() == plain.event_log_json()
    calls = sum(s.calls for s in real.pool.stats().values())
    assert calls == real.inspections // 4 > 0
    assert all(a.error_count == 0 for a in real.dep.devices.values())


# --------------------------------------------------------------------- #
# The EnginePool's per-device-class engines against JAX's
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def classes(setup, tmp_path_factory):
    """``fleet_bench``'s KV-pressure setup in both packages: the three
    variants of v2 (static calibrated on one JAX batch), the RAM fraction
    that gives the lite class ~5 blocks, 12 prompts of a shared 8-token
    prefix plus 4 tokens each. The port reads the JAX-published registry
    (the static variant's activation scales are JAX's)."""
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    root = str(tmp_path_factory.mktemp("classes"))
    calib = [{"tokens": jax.random.randint(jax.random.PRNGKey(123), (2, 16),
                                           0, jcfg.vocab_size)}]
    japi.ArtifactRegistry(root).publish_variants(
        japi.ModelArtifact.create("vqi", "v2", setup["jp"], jcfg),
        [japi.VariantSpec.fp32(), japi.VariantSpec.dynamic_int8(),
         japi.VariantSpec.static_int8(calib_batches=1)], calib_data=calib)
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, jcfg.vocab_size, (1, 8))
    prompts = [np.concatenate([prefix, rng.integers(0, jcfg.vocab_size,
                                                    (1, 4))], axis=1)
               for _ in range(12)]
    lite = min(p.memory_bytes for _, p, _, _ in t_sim.DEVICE_CLASSES)
    frac = 5.0 * kv_bytes_per_block(tcfg, KV_BLOCK) / lite
    return {"jreg": japi.ArtifactRegistry(root),
            "treg": tapi.ArtifactRegistry(root), "prompts": prompts,
            "frac": frac}


def _serve(engine, prompts, jax_side):
    conv = jnp.asarray if jax_side else torch.as_tensor
    reqs = [engine.submit(conv(p), max_new_tokens=8) for p in prompts]
    engine.run()
    assert all(r.done for r in reqs)
    m = engine.metrics(reqs)
    return ([list(r.out_tokens) for r in reqs],
            {key: m[key] for key in ("completed", "preempted",
                                     "prefix_hit_rate", "kv_blocks_peak")})


def _device_free(report):
    """``memory_report()`` with each key's device / backend field dropped."""
    return {key.split("@", 1)[0] + "/" + key.split("/", 1)[1]: val
            for key, val in report.items()}


def test_engine_pool_class_engines_match_jax(setup, classes):
    """Per class: the KV budget, the engine's usable blocks and bytes per
    block, its streams, preemptions and prefix hits, and the pool's
    ``memory_report()``, all equal to JAX's; the lite class has fewer
    blocks than the standard class and preempts at least as often."""
    jpool = j_sim.EnginePool(classes["jreg"])
    tpool = t_sim.EnginePool(classes["treg"])
    frac, prompts = classes["frac"], classes["prompts"]
    seen = {}
    for cls, profile, _, _ in t_sim.DEVICE_CLASSES:
        variant = t_sim.profile_variant_policy(
            type("Agent", (), {"profile": profile}))
        jprofile = dict((c, p) for c, p, _, _ in j_sim.DEVICE_CLASSES)[cls]
        assert variant == j_sim.profile_variant_policy(
            type("Agent", (), {"profile": jprofile}))
        assert tpool.kv_budget_bytes(profile, frac) == \
            jpool.kv_budget_bytes(jprofile, frac)
        jeng = jpool.serving_engine(classes["jreg"].ref("vqi", "v2", variant),
                                    profile=jprofile, kv_fraction=frac,
                                    n_slots=2, max_len=32,
                                    block_size=KV_BLOCK)
        teng = tpool.serving_engine(classes["treg"].ref("vqi", "v2", variant),
                                    "cpu", profile, kv_fraction=frac,
                                    n_slots=2, max_len=32,
                                    block_size=KV_BLOCK)
        assert teng.kv.alloc.usable_blocks == jeng.kv.alloc.usable_blocks
        assert teng.kv.bytes_per_block == jeng.kv.bytes_per_block
        got, want = _serve(teng, prompts, False), _serve(jeng, prompts, True)
        assert got == want, cls
        seen[cls] = (teng.kv.alloc.usable_blocks, got[1]["preempted"])
    assert seen["lite"][0] < seen["std"][0]
    assert seen["lite"][1] >= seen["std"][1]
    assert tpool.fetches == jpool.fetches == 3
    report = tpool.memory_report()
    assert all("@cpu/" in key for key in report)
    assert _device_free(report) == _device_free(jpool.memory_report())


def test_engine_pool_tp2_engine_matches_jax_tp1(setup, classes):
    """A tp=2 class engine (both shards on the CPU) serves JAX's tp=1
    streams (JAX's own tp=2 engine cannot run on this jax) with half the
    per-shard bytes of a block, and its own ``memory_report()`` row."""
    jpool = j_sim.EnginePool(classes["jreg"])
    tpool = t_sim.EnginePool(classes["treg"])
    std = t_sim.DEVICE_CLASSES[0][1]
    jstd = j_sim.DEVICE_CLASSES[0][1]
    kw = {"kv_fraction": classes["frac"], "n_slots": 2, "max_len": 32,
          "block_size": KV_BLOCK}
    ref = classes["treg"].ref("vqi", "v2", "fp32")
    one = tpool.serving_engine(ref, "cpu", std, **kw)
    two = tpool.serving_engine(ref, "cpu", std, tp=2, **kw)
    assert two is tpool.serving_engine(ref, "cpu", std, tp=2, **kw)
    jeng = jpool.serving_engine(classes["jreg"].ref("vqi", "v2", "fp32"),
                                profile=jstd, **kw)
    want = _serve(jeng, classes["prompts"], True)
    assert _serve(two, classes["prompts"], False)[0] == want[0]
    rows = {row["tp"]: row for row in tpool.memory_report().values()}
    assert rows[2]["bytes_per_block_per_shard"] * 2 == \
        rows[1]["bytes_per_block_per_shard"] == one.kv.bytes_per_block
    assert rows[2]["budget_bytes"] == rows[1]["budget_bytes"]


def test_engine_pool_router_matches_jax(setup, classes):
    """The pi4 class's router (1 prefill + 2 decode workers on one pool
    sized from its budget) serves the JAX router's streams on the same
    prompts, recomputes no prompt token on its decode workers, and reports
    the same ``memory_report()`` row."""
    jpool = j_sim.EnginePool(classes["jreg"])
    tpool = t_sim.EnginePool(classes["treg"])
    pi4 = t_sim.DEVICE_CLASSES[1][1]
    jpi4 = j_sim.DEVICE_CLASSES[1][1]
    kw = {"kv_fraction": 4 * classes["frac"], "max_len": 32,
          "block_size": KV_BLOCK}
    jr = jpool.request_router(classes["jreg"].ref("vqi", "v2", "static_int8"),
                              profile=jpi4, **kw)
    tr = tpool.request_router(classes["treg"].ref("vqi", "v2", "static_int8"),
                              "cpu", pi4, **kw)
    assert tr is tpool.request_router(
        classes["treg"].ref("vqi", "v2", "static_int8"), "cpu", pi4, **kw)
    streams = []
    for router, conv in ((tr, torch.as_tensor), (jr, jnp.asarray)):
        for p in classes["prompts"]:
            router.submit(conv(p), max_new_tokens=8)
        router.run()
        assert all(r.state == "done" for r in router.requests)
        streams.append([list(r.out_tokens) for r in router.requests])
    assert streams[0] == streams[1]
    assert tr.metrics() == jr.metrics()
    assert tr.metrics()["decode_prompt_tokens_recomputed"] == 0
    assert _device_free(tpool.memory_report()) == \
        _device_free(jpool.memory_report())
