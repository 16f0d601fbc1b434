"""End-to-end EdgeMLOps VQI demo on the PyTorch port: the paper's Figures
1/4/5 as one script, driven through the ``repro_torch.api`` control plane.

1.  Train the VQI model (vision-stub frontend + LM backbone) on the
    synthetic TTPLA-like task.
2.  Publish v1 as a ``ModelArtifact`` with fp32 + static-int8 (calibrated)
    + dynamic-int8 ``VariantSpec``s.
3.  Deploy to a heterogeneous fleet (standard + Pi-4-class devices; the
    constrained devices admit only int8 variants) through a ``Deployment``
    whose health gate tests VQI task accuracy.
4.  Field inspections push asset-condition updates through telemetry;
    low-confidence or wrong captures go to the retrain buffer.
5.  Publish a bad v2 (a simulated training regression): the canary health
    gate catches it and every device rolls back to v1.
6.  Retrain from the telemetry buffer, publish v3 and roll it out.

    PYTHONPATH=src python examples/vqi_fleet_torch.py [--device cpu]

Every device pins the kernel backend of ``--device`` (``cuda`` on the card,
``ref``, the plain path, on the CPU), and the publishes calibrate under it.
"""
import argparse
import tempfile

import torch

from repro_torch.api import (ArtifactRegistry, Deployment, DeviceProfile,
                             ModelArtifact, VariantSpec, use_backend)
from repro_torch.data import VQITask, vqi_batch
from repro_torch.device import resolve_device
from repro_torch.fleet.vqi import (evaluate, inspection_pipeline,
                                   retrain_from_telemetry, train_vqi_model,
                                   vqi_calib_batches, vqi_config)
from repro_torch.serving import RequestQueue
from repro_torch.tree import map_with_path

SPECS = [VariantSpec.fp32(), VariantSpec.dynamic_int8(),
         VariantSpec.static_int8(calib_batches=4)]
# field captures are noisier than the training data, so some come back
# low-confidence or wrong and feed the retrain buffer
FIELD = VQITask(noise=8.0)


def backend_for(device):
    """The kernel backend every device of the demo pins."""
    return "cuda" if device.type == "cuda" else "ref"


def make_deployment(registry, device, n_standard=2, n_constrained=2):
    dep = Deployment(registry, model="vqi")
    for i in range(n_standard):
        dep.add_device(f"edge-std-{i}",
                       DeviceProfile("edge-standard", 8 * 1024**3),
                       backend=backend_for(device), device=device)
    for i in range(n_constrained):
        dep.add_device(
            f"edge-pi4-{i}",
            DeviceProfile("edge-pi4-4gb", 4 * 1024**3,
                          allowed_variants=("static_int8", "dynamic_int8")),
            backend=backend_for(device), device=device)
    return dep


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    dev = resolve_device(ap.parse_args().device)
    cfg = vqi_config()

    def accuracy(agent):
        # the gate's metric: VQI task accuracy of the active model
        if agent.session is None:
            return {}
        return {"accuracy": evaluate(agent.session.params, cfg, 2,
                                     device=dev)["accuracy"]}

    def publish(dep, version, params):
        with use_backend(backend_for(dev)):
            return dep.publish(
                ModelArtifact.create("vqi", version, params, cfg), SPECS,
                calib_data=vqi_calib_batches(cfg, 4, device=dev),
                evaluate=lambda p, c: evaluate(p, c, 2, device=dev))

    print(f"== 1. training VQI model (synthetic TTPLA task) on {dev} ==")
    params, _ = train_vqi_model(cfg, steps=150, log_fn=lambda s: None,
                                device=dev)
    metrics = evaluate(params, cfg, device=dev)
    print(f"trained: asset_acc={metrics['asset_acc']:.3f} "
          f"cond_acc={metrics['cond_acc']:.3f}")
    assert metrics["asset_acc"] > 0.9, "VQI model failed to learn"

    with tempfile.TemporaryDirectory() as root:
        dep = make_deployment(ArtifactRegistry(root), dev)
        print("== 2. publishing v1 (fp32 / static / dynamic int8) ==")
        published = publish(dep, "v1", params)
        for variant, art in published.items():
            print(f"  {variant:13s} {art.size_bytes / 1e6:6.2f} MB "
                  f"cond_acc={art.metrics['cond_acc']:.3f}")
        ratio = (published["fp32"].size_bytes
                 / published["static_int8"].size_bytes)
        print(f"  size reduction fp32 -> int8: {ratio:.2f}x")

        print("== 3. staged rollout, gated on VQI accuracy ==")
        report = dep.staged_rollout("v1", validate=accuracy)
        assert report.succeeded, report.reason
        for did, h in dep.status().items():
            print(f"  {did}: active={h['active']}")
            if "pi4" in did:
                assert "int8" in h["active"], f"{did} got a non-int8 model"

        print("== 4. field inspections -> asset condition updates ==")
        hub = dep.telemetry
        gen = torch.Generator().manual_seed(42)
        for round_i in range(2):
            for did, agent in dep.devices.items():
                raw = dict(vqi_batch(gen, cfg, FIELD, 8, dev))
                raw["asset_ids"] = [f"asset-{round_i}-{did}-{j}"
                                    for j in range(8)]
                q = RequestQueue(inspection_pipeline(agent, cfg, hub),
                                 max_batch=8, stack=lambda ps: ps[0],
                                 unstack=lambda res, n: [res])
                q.submit(raw)
                q.drain()
        print(f"  {len(hub.asset_conditions)} asset-condition records; "
              f"{len(hub.retrain_buffer)} captures in the retrain buffer")

        print("== 5. bad v2 release -> health gate -> auto-rollback ==")
        noise = torch.Generator(device=dev).manual_seed(1)
        bad = map_with_path(lambda _, t: t + 0.8 * torch.randn(
            t.shape, generator=noise, device=dev, dtype=t.dtype), params)
        publish(dep, "v2", bad)
        report2 = dep.staged_rollout("v2", validate=accuracy)
        print(f"  rollout v2: success={report2.succeeded}; "
              f"{report2.reason[:100]}")
        assert not report2.succeeded, "the gate should reject the bad model"
        for did, h in dep.status().items():
            assert ":v1:" in h["active"], f"{did} is not back on v1"
        print("  all devices back on v1: auto-rollback verified")

        print("== 6. feedback loop: retrain from telemetry -> v3 ==")
        v3, info = retrain_from_telemetry(hub, params, cfg,
                                          log_fn=lambda s: None, device=dev)
        assert info["replayed_samples"] > 0, "no capture came back"
        print(f"  replayed {info['replayed_samples']} captures; "
              f"final loss {info['final_loss']:.4f}")
        publish(dep, "v3", v3)
        report3 = dep.staged_rollout("v3", validate=accuracy)
        assert report3.succeeded, report3.reason
        for did, h in dep.status().items():
            assert ":v3:" in h["active"], f"{did} is not on v3"
        print("  v3 rolled out to every device")
    print("VQI fleet demo complete.")


if __name__ == "__main__":
    main()
