"""A deterministic, event-driven 1000-device staged rollout on the PyTorch
port (the twin of ``examples/fleet_sim.py``).

The paper operates a handful of physical devices; this example runs the
same MLOps lifecycle (publish fp32 / static-int8 / dynamic-int8 variants,
stage a canary -> waves -> fleet-wide rollout, absorb injected failures)
across 1000 heterogeneous virtual devices on the shared virtual clock:

* variants are selected per device profile (standard -> fp32, Pi-4-class ->
  static_int8, lite-class -> dynamic_int8), all lifecycle ops flowing
  through the ``repro_torch.api`` ``Deployment`` + registry;
* failure injection: random offline windows (offline devices re-converge on
  reconnect), a wave of failing installs (retried, budgeted), slow links,
  flaky health probes;
* every device serves inspections through a *shared* pool of device-pinned
  engines (one real session per artifact serves the whole fleet);
* the whole simulation runs twice and must produce **byte-identical event
  logs**, the determinism contract the fleet tests pin.

    PYTHONPATH=src python examples/fleet_sim_torch.py [--devices 1000]
        [--fast] [--device cpu]

Runs on the card by default; ``--device cpu`` runs the plain PyTorch path.
The weights are the port's own seeded draw: only the artifacts' sizes enter
the event log, and they equal the JAX example's, so with the same flags the
digest equals the JAX example's.
"""
import argparse
import hashlib
import tempfile
import time

import torch

from repro_torch.api import (ArtifactRegistry, Deployment, FaultPlan,
                             HealthGate, ModelArtifact, RolloutPolicy,
                             VariantSpec, WorkloadModel)
from repro_torch.data import vqi_batch
from repro_torch.device import resolve_device
from repro_torch.fleet.vqi import TASK, vqi_calib_batches, vqi_config
from repro_torch.models import init_params

SPECS = [VariantSpec.fp32(), VariantSpec.dynamic_int8(),
         VariantSpec.static_int8(calib_batches=2)]
POLICY = RolloutPolicy(waves=(0.02, 0.1, 0.3, 1.0), soak_s=25.0,
                       install_stagger_s=0.05, gate_min_calls=40,
                       max_install_retries=3,
                       gate=HealthGate(max_accuracy_drop=0.08,
                                       max_latency_ratio=1.6))
#: one injected failure wave: ~15% of installs fail and are retried, plus
#: offline churn, slow links and flaky probes
FAULTS = FaultPlan(offline_rate_per_hour=1.5, mean_offline_s=90.0,
                   install_fail_rate=0.15, slow_link_rate=0.08,
                   slow_link_factor=6.0, flaky_probe_rate=0.05)


def publish(registry: ArtifactRegistry, cfg, params, device) -> None:
    dep = Deployment(registry, model="vqi")
    calib = vqi_calib_batches(cfg, 2, batch=8, device=device)
    for version in ("v1", "v2"):
        published = dep.publish(
            ModelArtifact.create("vqi", version, params, cfg),
            SPECS, calib_data=calib)
        sizes = " ".join(f"{v}={a.size_bytes/1e6:.2f}MB"
                         for v, a in published.items())
        print(f"  published {version}: {sizes}")


def simulate(registry: ArtifactRegistry, n_devices: int, seed: int,
             horizon: float, device):
    dep = Deployment(registry, model="vqi")
    sim = dep.simulator(seed=seed, faults=FAULTS, workload=WorkloadModel())
    sim.add_heterogeneous_fleet(n_devices, inspection_interval_s=20.0,
                                device=device)
    sim.schedule_rollout("v1", POLICY, at=10.0)
    sim.schedule_rollout("v2", POLICY, at=horizon * 0.45)
    sim.run(until=horizon)
    return sim


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=1000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fast", action="store_true",
                    help="shorter virtual horizon (CI smoke)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    horizon = 800.0 if args.fast else 1000.0
    cfg = vqi_config(d_model=64)
    params = init_params(cfg, seed=0, device=dev)

    with tempfile.TemporaryDirectory() as root:
        registry = ArtifactRegistry(root)
        print("== 1. publishing artifacts (fp32 / static / dynamic int8) ==")
        publish(registry, cfg, params, dev)

        print(f"== 2. simulating {args.devices}-device staged rollout, "
              f"twice (seed={args.seed}) ==")
        t0 = time.perf_counter()
        sim = simulate(registry, args.devices, args.seed, horizon, dev)
        wall1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        sim2 = simulate(registry, args.devices, args.seed, horizon, dev)
        wall2 = time.perf_counter() - t0

        log1, log2 = sim.event_log_json(), sim2.event_log_json()
        assert log1 == log2, "same seed must produce byte-identical event logs"
        digest = hashlib.sha256(log1.encode()).hexdigest()[:16]
        print(f"  run 1: {wall1:.1f}s wall, run 2: {wall2:.1f}s wall "
              f"({sim.clock.now():.0f} virtual seconds each)")
        print(f"  event logs byte-identical: sha256[:16]={digest} "
              f"({len(sim.events)} events)")

        m = sim.metrics()
        print("== 3. rollout report ==")
        for ro in m["rollouts"]:
            print(f"  v{ro['version'][-1]}: {ro['status']} "
                  f"waves={ro['waves']} installs={ro['installs']} "
                  f"retries={ro['retries']} failed={ro['failed']} "
                  f"stragglers={ro['stragglers']} "
                  f"convergence={ro['convergence_s'] and round(ro['convergence_s'], 1)}s")
        for ro in sim.rollouts:
            assert ro.status == "complete", ro.summary()

        print(f"== 4. fleet telemetry (windowed, {m['inspections']} "
              f"inspections) ==")
        for variant, vm in sim.variant_metrics("v2").items():
            print(f"  {variant:13s} calls={vm['calls']:6d} "
                  f"p50={vm['p50_latency_ms']:6.1f}ms "
                  f"p99={vm['p99_latency_ms']:6.1f}ms "
                  f"err={vm['error_rate']:.3f}")
        ts = m["telemetry"]
        print(f"  window: retained={ts['retained_records']} "
              f"evicted={ts['evicted_records']} "
              f"retrain_buffer={ts['retrain_buffered']} "
              f"(evicted {ts['evicted_retrain']})")

        # per-profile variant selection (the paper's heterogeneity story)
        by_class = {}
        for agent in sim.dep.devices.values():
            if agent.active is not None:
                by_class.setdefault(agent.profile.name, set()).add(
                    agent.active.variant)
        print("== 5. variant by device class ==")
        for cls, variants in sorted(by_class.items()):
            print(f"  {cls:16s} -> {sorted(variants)}")
        assert by_class.get("edge-pi4-4gb", set()) <= {"static_int8"}
        assert by_class.get("edge-lite-2gb", set()) <= {"dynamic_int8"}
        assert by_class.get("edge-standard", set()) <= {"fp32"}

        print("== 6. real inference through the shared engine pool ==")
        gen = torch.Generator().manual_seed(7)
        batch = {k: v for k, v in vqi_batch(gen, cfg, TASK, 2, dev).items()
                 if k in ("tokens", "frontend_embeds")}
        shown = set()
        for agent in sim.dep.devices.values():
            if agent.active and agent.active.variant not in shown:
                shown.add(agent.active.variant)
                t0 = time.perf_counter()
                agent.infer(batch)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                ms = (time.perf_counter() - t0) * 1e3
                print(f"  {agent.device_id}: {agent.active.key} "
                      f"logits in {ms:.1f}ms (device-pinned, shared)")
        print(f"  engine pool: {sim.pool.fetches} artifact fetches, "
              f"{len(sim.pool._sessions)} shared sessions for "
              f"{args.devices} devices")
    print("fleet_sim demo complete.")
    return digest, sim.metrics()


if __name__ == "__main__":
    main()
