"""The VQI use case end to end (the paper's sections 2 and 5), the port of
``repro.fleet.vqi``: train a VQI model (phi-3-vision reduced), publish
fp32 / static-int8 / dynamic-int8 artifacts, deploy them to a
heterogeneous fleet, run inspections that push asset-condition updates
through telemetry, and retrain from the captures the fleet sends back.
The paper's Figure 5 as executable code.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List

import torch

from repro_torch import configs as C
from repro_torch.api.artifact import ModelArtifact
from repro_torch.api.registry import ArtifactRegistry
from repro_torch.api.variants import VariantSpec
from repro_torch.data.pipeline import (ASSET_TYPES, CONDITIONS, VQITask,
                                       vqi_batch, vqi_eval_accuracy,
                                       vqi_stream)
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fleet.agent import DeviceProfile, EdgeAgent
from repro_torch.fleet.orchestrator import FleetOrchestrator
from repro_torch.fleet.telemetry import InferenceRecord, TelemetryHub
from repro_torch.models import forward
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import Pipeline
from repro_torch.training.loop import fit
from repro_torch.training.optimizer import OptimizerConfig

TASK = VQITask()


def vqi_config(d_model: int = 128) -> ModelConfig:
    """The VQI model family: phi-3-vision reduced (vision stub + LM head)."""
    return C.smoke_config("phi-3-vision-4.2b").with_overrides(
        d_model=d_model, dtype="float32", n_frontend_tokens=8)


def train_vqi_model(cfg: ModelConfig, steps: int = 150, batch: int = 32,
                    log_fn=print, device: DeviceLike = None):
    """(params, history) of ``steps`` AdamW steps on fresh VQI batches, from
    ``init_params(cfg, 0, device)``."""
    oc = OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=steps,
                         weight_decay=0.01)
    stream = vqi_stream(cfg, batch, device=device)
    return fit(cfg, oc, stream, steps, log_fn=log_fn, device=device)


def evaluate(params, cfg: ModelConfig, n_batches: int = 4, batch: int = 64,
             seed: int = 999, device: DeviceLike = None) -> Dict[str, float]:
    """Teacher-forced accuracy on fresh VQI batches and the mean wall time
    of one forward (the device synchronised before the clock stops). On
    the CPU the forwards run under the ``ref`` backend, as an unpinned
    session's do."""
    from repro_torch.api.backends import bind_for, use_backend

    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    batches = [vqi_batch(gen, cfg, TASK, batch, dev)
               for _ in range(n_batches)]
    accs, cond_accs = [], []
    # repro: allow-wallclock -- mean_latency_ms reports real eval wall time
    t0 = time.perf_counter()
    with torch.no_grad(), use_backend(bind_for(None, dev)):
        for b in batches:
            logits = forward(params, b, cfg)[0]
            a, c = vqi_eval_accuracy(logits, b, cfg, TASK)    # host copy
            accs.append(a)
            cond_accs.append(c)
    # repro: allow-wallclock -- interval vs t0 above (eval latency)
    dt = (time.perf_counter() - t0) * 1e3 / n_batches
    return {"asset_acc": sum(accs) / len(accs),
            "cond_acc": sum(cond_accs) / len(cond_accs),
            "accuracy": sum(cond_accs) / len(cond_accs),
            "mean_latency_ms": dt}


def vqi_calib_batches(cfg: ModelConfig, n: int = 4, batch: int = 32,
                      seed: int = 7, device: DeviceLike = None
                      ) -> List[Dict[str, Any]]:
    """Representative VQI batches for static-int8 calibration."""
    gen = torch.Generator().manual_seed(seed)
    return [vqi_batch(gen, cfg, TASK, batch, device) for _ in range(n)]


def vqi_variant_specs(calib_batches: int = 4) -> List[VariantSpec]:
    """fp32 + dynamic_int8 + static_int8 (calibrated): the paper's three
    bars."""
    return [VariantSpec.fp32(),
            VariantSpec.dynamic_int8(),
            VariantSpec.static_int8(calib_batches=calib_batches)]


def publish_variants(registry: ArtifactRegistry, name: str, version: str,
                     params, cfg: ModelConfig, calib_batches: int = 4,
                     device: DeviceLike = None) -> Dict[str, Any]:
    """The JAX package's shim over ``registry.publish_variants`` (returns
    {variant: ArtifactRef}); calibration and evaluation run on ``device``,
    which holds ``params``."""
    model = ModelArtifact.create(name, version, params, cfg)
    published = registry.publish_variants(
        model, vqi_variant_specs(calib_batches),
        calib_data=vqi_calib_batches(cfg, calib_batches, device=device),
        evaluate=lambda p, c: evaluate(p, c, 2, device=device))
    return {variant: art.ref for variant, art in published.items()}


# ------------------------------------------------------------------ #
# Fleet inspection pipeline
# ------------------------------------------------------------------ #
def inspection_pipeline(agent: EdgeAgent, cfg: ModelConfig,
                        hub: TelemetryHub):
    """pre: pack the captured patch embeddings; infer: on the device; post:
    decode the class tokens and push one asset-condition update per image.
    ``post`` takes the argmax and confidence of the whole batch on the
    device and makes one host copy of them."""
    lay = TASK.vocab_layout(cfg)

    def pre(raw):
        return {"tokens": raw["tokens"],
                "frontend_embeds": raw["frontend_embeds"]}

    def infer(batch):
        # repro: allow-wallclock -- on-device latency telemetry is real
        t0 = time.perf_counter()
        logits = agent.infer(batch)          # synchronised by the session
        # repro: allow-wallclock -- time (interval vs t0 above)
        infer.latency_ms = (time.perf_counter() - t0) * 1e3
        return logits

    def post(logits, raw):
        off = cfg.n_frontend_tokens
        a_log = logits[:, off, lay["asset0"]: lay["asset0"] + TASK.n_assets]
        c_log = logits[:, off + 1,
                       lay["cond0"]: lay["cond0"] + TASK.n_conditions]
        a_prob = torch.softmax(a_log.float(), -1)
        c_prob = torch.softmax(c_log.float(), -1)
        a_p, a_i = a_prob.max(-1)
        c_p, c_i = c_prob.max(-1)
        cols = [a_i.float(), c_i.float(), torch.minimum(a_p, c_p)]
        if "asset" in raw:               # ground truth rides the same copy
            cols += [raw["asset"].to(a_p.device).float(),
                     raw["cond"].to(a_p.device).float()]
        rows = torch.stack(cols, 1).tolist()
        n = len(raw["asset_ids"])
        out = []
        for i, asset_id in enumerate(raw["asset_ids"]):
            a, c, conf = int(rows[i][0]), int(rows[i][1]), rows[i][2]
            pred = {"asset_type": ASSET_TYPES[a], "condition": CONDITIONS[c]}
            correct = None if len(rows[i]) == 3 else (
                (a, c) == (int(rows[i][3]), int(rows[i][4])))
            sample = None
            if conf < hub.threshold or correct is False:
                # feedback loop: ship the raw capture back for retraining
                sample = {"frontend_embeds": raw["frontend_embeds"][i],
                          "tokens": raw["tokens"][i],
                          "labels": raw["labels"][i]
                          if "labels" in raw else None}
            hub.push(InferenceRecord(
                device_id=agent.device_id, model_key=agent.active.key,
                latency_ms=infer.latency_ms / n, asset_id=asset_id,
                prediction=pred, confidence=conf, correct=correct,
                sample=sample))
            out.append(pred)
        return out

    return Pipeline(pre, infer, post)


def make_fleet(registry: ArtifactRegistry, n_standard: int = 2,
               n_constrained: int = 2,
               device: DeviceLike = None) -> FleetOrchestrator:
    """Heterogeneous fleet: standard devices (fp32-capable) and Pi-4-class
    constrained devices that admit only int8 variants, every agent's
    session on ``device``."""
    hub = TelemetryHub()
    orch = FleetOrchestrator(registry, telemetry=hub)
    for i in range(n_standard):
        orch.register_device(EdgeAgent(
            f"edge-std-{i}", registry,
            DeviceProfile("edge-standard", 8 * 1024**3), device=device))
    for i in range(n_constrained):
        orch.register_device(EdgeAgent(
            f"edge-pi4-{i}", registry,
            DeviceProfile("edge-pi4-4gb", 4 * 1024**3,
                          allowed_variants=("static_int8", "dynamic_int8")),
            device=device))
    return orch


# ------------------------------------------------------------------ #
# Closed MLOps loop: telemetry buffer -> retrain -> publish -> rollout
# (the paper's Fig. 4 right-to-left feedback arrow, as executable code)
# ------------------------------------------------------------------ #
def retrain_from_telemetry(hub: TelemetryHub, params, cfg: ModelConfig,
                           steps: int = 60, batch: int = 32,
                           mix_fraction: float = 0.25, log_fn=print,
                           seed: int = 99, device: DeviceLike = None):
    """Fine-tune ``params`` (on ``device``) on fresh VQI batches mixed with
    the hub's labelled retrain captures: ``int(batch * mix_fraction)`` rows
    of every batch are replaced by captures drawn uniformly from the
    buffer (with replacement, from the stream's generator)."""
    dev = resolve_device(device)
    buffered = [r.sample for r in hub.retrain_buffer
                if r.sample and r.sample.get("labels") is not None]
    oc = OptimizerConfig(lr=5e-4, warmup_steps=5, total_steps=steps,
                         weight_decay=0.01)

    def stream():
        gen = torch.Generator().manual_seed(seed)
        n_mix = int(batch * mix_fraction) if buffered else 0
        while True:
            b = vqi_batch(gen, cfg, TASK, batch, dev)
            b = {k: b[k] for k in ("tokens", "labels", "frontend_embeds")}
            if n_mix:
                idx = torch.randint(0, len(buffered), (n_mix,),
                                    generator=gen).tolist()
                for k in b:
                    rows = torch.stack([buffered[i][k].to(dev) for i in idx])
                    b[k] = torch.cat([rows.to(b[k].dtype), b[k][n_mix:]])
            yield b

    new_params, history = fit(cfg, oc, stream(), steps, params=params,
                              log_fn=log_fn, device=dev)
    return new_params, {"replayed_samples": len(buffered),
                        "final_loss": history[-1]["loss"]}
