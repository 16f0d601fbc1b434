#!/usr/bin/env python3
"""Per-phase seconds of ``chip_smoke.py`` runs, side by side.

    python3 scripts/smoke_phases.py change.log parent.log [...]

Each log is a run's standard output: one JSON line per phase result, each
stamped ``t_s`` (the script's elapsed seconds when it was printed). A
phase's seconds are the stamps' increments summed over its lines, so
every second of a run lands in the phase whose line ends it. Also prints
each run's e2e decode-step host ms per variant, the ``backends`` phase's
per-pin decode steps and registry cost when the run has them, and the
total (the last stamp)."""
from __future__ import annotations

import json
import sys
from typing import Dict, List, Tuple


def read(path: str) -> List[dict]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line.startswith("{") and '"phase"' in line:
                out.append(json.loads(line))
    return out


def phase_seconds(lines: List[dict]) -> Tuple[Dict[str, float], float]:
    by, last = {}, 0.0
    for rec in lines:
        by[rec["phase"]] = by.get(rec["phase"], 0.0) + rec["t_s"] - last
        last = rec["t_s"]
    return by, last


def main(paths: List[str]) -> None:
    runs = [read(p) for p in paths]
    secs = [phase_seconds(r) for r in runs]
    order = list(dict.fromkeys(p for by, _ in secs for p in by))
    print("phase".ljust(24) + "".join(p[-28:].rjust(30) for p in paths))
    for phase in order:
        print(phase.ljust(24) + "".join(
            f"{by.get(phase, 0.0):30.1f}" for by, _ in secs))
    print("total".ljust(24) + "".join(f"{t:30.1f}" for _, t in secs))
    for path, lines in zip(paths, runs):
        print(f"\n{path}")
        for rec in lines:
            if rec["phase"] == "e2e":
                print(f"  e2e {rec['variant']}: decode step "
                      f"{rec['decode_step_ms']} ms host")
            if rec["phase"] == "backends":
                for pin, d in rec["decode"].items():
                    t = d["decode_trace"]
                    print(f"  backends pin {pin}: host ms a step "
                          f"{d['rounds_ms']} (least {d['host_ms_per_step']})"
                          f", {d['launches_per_step']} launches, busy "
                          f"{t.get('device_busy_ms_per_step')} ms, idle "
                          f"{t.get('device_idle_share')}")
                print(f"  registry us a call {rec['registry_us_per_call']}, "
                      f"entry {rec['direct_us_per_call']}, "
                      f"{rec['registry_ms_per_step']} ms a step")
                print(f"  logits max |cuda - ref| {rec['max_abs_err']} vs "
                      f"bound {rec['bound']}; streams equal "
                      f"{rec['streams_equal']} of {rec['of']}")
            if rec["phase"] == "backends_engines":
                print(f"  engines {json.dumps(rec['tp_engines'])}")
                print(f"  spec: {rec['spec_serve_ms']} ms, draft tokens "
                      f"{rec['spec_draft_tokens']}, acceptance "
                      f"{rec['acceptance_rate']}")


if __name__ == "__main__":
    main(sys.argv[1:])
