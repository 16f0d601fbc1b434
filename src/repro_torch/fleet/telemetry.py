"""Telemetry hub and feedback loop (the paper's right-to-left arrow): the
port of ``repro.fleet.telemetry``, pure Python.

Devices push inference records; the hub aggregates per-device and
per-model metrics, keeps the asset-condition table (the "asset management
system" of the VQI use case) and collects low-confidence or misclassified
samples as the retraining buffer. It is bounded and windowed: ``records``
is a rolling window (evictions are counted), metrics come from rolling
aggregates updated on every push (counts, latency sums and log-binned
latency histograms for p50/p90/p99) and cover the full stream, and the
retraining buffer is capped with its evictions counted. Timestamps come
from ``repro_torch.clock``.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional

from repro_torch import clock as _clock


@dataclasses.dataclass
class InferenceRecord:
    device_id: str
    model_key: str
    latency_ms: float
    asset_id: Optional[str] = None
    prediction: Optional[Dict[str, Any]] = None
    confidence: float = 1.0
    correct: Optional[bool] = None
    sample: Optional[Dict[str, Any]] = None   # raw inputs for the retrain loop
    t: float = dataclasses.field(default_factory=_clock.now)


class LatencyHistogram:
    """Log-binned latency histogram: O(1) add, O(bins) quantiles, fixed
    memory — the windowed replacement for keeping every latency sample."""

    LO_MS = 0.01
    RATIO = 1.2
    N_BINS = 96                        # covers ~0.01ms .. ~400s

    __slots__ = ("counts", "total", "sum_ms", "max_ms")

    def __init__(self):
        self.counts = [0] * self.N_BINS
        self.total = 0
        self.sum_ms = 0.0
        self.max_ms = 0.0

    def add(self, ms: float) -> None:
        b = 0
        edge = self.LO_MS
        while ms > edge and b < self.N_BINS - 1:
            edge *= self.RATIO
            b += 1
        self.counts[b] += 1
        self.total += 1
        self.sum_ms += ms
        if ms > self.max_ms:
            self.max_ms = ms

    def quantile(self, q: float) -> float:
        """Upper edge of the bin holding the q-quantile (0 if empty)."""
        if self.total == 0:
            return 0.0
        target = max(1, int(q * self.total + 0.999999))
        seen = 0
        edge = self.LO_MS
        for c in self.counts:
            seen += c
            if seen >= target:
                return min(edge, self.max_ms)
            edge *= self.RATIO
        return self.max_ms

    @property
    def mean(self) -> float:
        return self.sum_ms / self.total if self.total else 0.0


def _model_agg() -> Dict[str, Any]:
    return {"calls": 0, "hist": LatencyHistogram(),
            "judged": 0, "correct": 0, "errors": 0}


class TelemetryHub:
    def __init__(self, retrain_confidence_threshold: float = 0.6,
                 window: int = 10_000, retrain_capacity: int = 2_000):
        self.records: deque = deque(maxlen=window)
        self.window = window
        self.asset_conditions: Dict[str, Dict[str, Any]] = {}
        self.retrain_buffer: deque = deque(maxlen=retrain_capacity)
        self.retrain_capacity = retrain_capacity
        self.threshold = retrain_confidence_threshold
        # rolling aggregates over the FULL stream (survive window eviction)
        self.total_records = 0
        self.evicted_records = 0
        self.evicted_retrain = 0
        self._by_model: Dict[str, Dict[str, Any]] = {}
        self._by_device: Dict[str, Dict[str, float]] = {}

    def push(self, rec: InferenceRecord) -> None:
        if len(self.records) == self.window:
            self.evicted_records += 1
        self.records.append(rec)
        self.total_records += 1

        agg = self._by_model.get(rec.model_key)
        if agg is None:
            agg = self._by_model[rec.model_key] = _model_agg()
        agg["calls"] += 1
        agg["hist"].add(rec.latency_ms)
        if rec.correct is not None:
            agg["judged"] += 1
            if rec.correct:
                agg["correct"] += 1
            else:
                agg["errors"] += 1
        dev = self._by_device.get(rec.device_id)
        if dev is None:
            dev = self._by_device[rec.device_id] = {"calls": 0, "lat_sum": 0.0}
        dev["calls"] += 1
        dev["lat_sum"] += rec.latency_ms

        if rec.asset_id and rec.prediction:
            self.asset_conditions[rec.asset_id] = {
                "condition": rec.prediction.get("condition"),
                "asset_type": rec.prediction.get("asset_type"),
                "updated_by": rec.device_id,
                "model": rec.model_key,
                "t": rec.t,
            }
        if rec.confidence < self.threshold or rec.correct is False:
            if len(self.retrain_buffer) == self.retrain_capacity:
                self.evicted_retrain += 1
            self.retrain_buffer.append(rec)

    # ------------------------------------------------------------- #
    def model_metrics(self, model_key: str) -> Dict[str, float]:
        """Full-stream metrics for one artifact key (from the rolling
        aggregates, so eviction never skews them)."""
        return self.metrics_since(model_key, None)

    def snapshot(self, model_key: str) -> Dict[str, Any]:
        """Raw counter snapshot for ``metrics_since`` — lets a rollout gate
        evaluate only the records pushed after a point in time (histogram
        counts are additive, so deltas are exact)."""
        agg = self._by_model.get(model_key)
        if agg is None:
            return {"calls": 0, "counts": None, "sum_ms": 0.0,
                    "judged": 0, "correct": 0, "errors": 0}
        hist: LatencyHistogram = agg["hist"]
        return {"calls": agg["calls"], "counts": list(hist.counts),
                "sum_ms": hist.sum_ms, "judged": agg["judged"],
                "correct": agg["correct"], "errors": agg["errors"]}

    def metrics_since(self, model_key: str,
                      since: Optional[Dict[str, Any]]) -> Dict[str, float]:
        """Metrics for the records pushed after the ``snapshot`` ``since``
        (None: the full stream). Same schema as ``model_metrics``."""
        agg = self._by_model.get(model_key)
        if agg is None:
            return {"calls": 0}
        base = since or {"calls": 0, "counts": None, "sum_ms": 0.0,
                         "judged": 0, "correct": 0, "errors": 0}
        calls = agg["calls"] - base["calls"]
        if calls <= 0:
            return {"calls": 0}
        cur: LatencyHistogram = agg["hist"]
        hist = LatencyHistogram()
        if base["counts"] is None:
            hist.counts = list(cur.counts)
        else:
            hist.counts = [c - b for c, b in zip(cur.counts, base["counts"])]
        hist.total = calls
        hist.sum_ms = cur.sum_ms - base["sum_ms"]
        hist.max_ms = cur.max_ms          # upper bound for the delta window
        judged = agg["judged"] - base["judged"]
        correct = agg["correct"] - base["correct"]
        errors = agg["errors"] - base["errors"]
        return {
            "calls": calls,
            "mean_latency_ms": hist.mean,
            "p50_latency_ms": hist.quantile(0.50),
            "p90_latency_ms": hist.quantile(0.90),
            "p99_latency_ms": hist.quantile(0.99),
            "accuracy": (correct / judged) if judged else None,
            "error_rate": (errors / judged) if judged else 0.0,
        }

    def device_metrics(self) -> Dict[str, Dict[str, float]]:
        return {d: {"calls": int(a["calls"]),
                    "mean_latency_ms": a["lat_sum"] / max(a["calls"], 1)}
                for d, a in self._by_device.items()}

    def model_keys(self) -> List[str]:
        return sorted(self._by_model)

    def retraining_ready(self, min_samples: int) -> bool:
        return len(self.retrain_buffer) >= min_samples

    def summary(self) -> Dict[str, Any]:
        """Bookkeeping for the full stream: totals, window occupancy, and
        explicit eviction counts (what the caps dropped)."""
        return {
            "total_records": self.total_records,
            "retained_records": len(self.records),
            "window": self.window,
            "evicted_records": self.evicted_records,
            "retrain_buffered": len(self.retrain_buffer),
            "retrain_capacity": self.retrain_capacity,
            "evicted_retrain": self.evicted_retrain,
            "models": self.model_keys(),
            "devices": len(self._by_device),
            "assets": len(self.asset_conditions),
        }
