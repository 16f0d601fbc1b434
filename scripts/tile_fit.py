#!/usr/bin/env python3
"""The H100 profile of ``repro_torch.kernels.autotune`` against a measured
tile sweep, and the grid search that set its constants.

    python3 scripts/tile_fit.py RUN.log [RUN2.log ...] [--fit]

Each log is the standard output of a ``chip_smoke.py`` run (or of a script
that calls its ``tiles_phase``): one ``tiles`` JSON line per (kernel,
shape), with every instantiated tile's two graph-replay times. For each
line this prints the profile's winner (the ``cuda`` key's sweep), the
64 x 64 tile and the fastest tile with their mean ms, the winner's regret
against the fastest and whether it loses to 64 x 64 by more than the
line's same-call noise (the mean |first - second| reading over its tiles).
Only the tiles the bodies instantiate now count. ``--fit`` draws 3000
profiles from a fixed seed (the free constants: the units a launch holds;
tile, throughput and launch costs against an mma cost of 1; the alignment
discount) and keeps the one with the fewest losses (a
switch away from 64 x 64 must also gain MARGIN in every row), then the
least summed regret, and prints it; the same logs give the same profile.
Nothing is timed here. Imports no JAX.
"""
from __future__ import annotations

import json
import os
import random
import sys
from dataclasses import replace
from typing import Dict, List, Tuple

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))

from repro_torch.kernels import autotune as at  # noqa: E402

def read(paths: List[str]) -> List[dict]:
    rows = []
    for path in paths:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line.startswith("{") and '"phase": "tiles"' in line:
                    rows.append(json.loads(line))
    return rows


def measured(row: dict) -> Tuple[Dict[Tuple[int, int], float], float]:
    """({tile: mean ms} over the tiles the body instantiates now, the
    line's relative same-call noise)."""
    ms, noise = {}, []
    have = at.tiles(row["body"], row["width_class"])
    for key, reads in row["ms"].items():
        bq, bk = map(int, key.split("x"))
        if (bq, bk) not in have:
            continue
        ms[(bq, bk)] = sum(reads) / len(reads)
        noise.append(abs(reads[0] - reads[-1]) / ms[(bq, bk)])
    return ms, sum(noise) / len(noise)


def precision(row: dict) -> str:
    return at.precision_label(row["kernel"], row["dtype"] == "bfloat16")


def winner(row: dict, profile: at.Profile) -> Tuple[int, int]:
    return at.sweep("cuda", row["kernel"], row["hd"], precision(row),
                    row["S"], profile)


#: a winner other than 64 x 64 must beat it by this share in every row of
#: its key, or it counts as a loss: a narrower gain may turn into a loss in
#: another run (two runs' readings of one shape differ by up to a few %)
MARGIN = 0.03


def score(rows: List[dict], profile: at.Profile) -> Tuple[int, float]:
    """(losses to 64 x 64: beyond the line's noise, or a switch that gains
    less than MARGIN; summed regret)."""
    losses, regret = 0, 0.0
    for row in rows:
        ms, noise = measured(row)
        w = winner(row, profile)
        d = tuple(row["default"])
        if ms[w] - ms[d] > noise * ms[d] or (
                w != d and ms[w] > (1.0 - MARGIN) * ms[d]):
            losses += 1
        regret += ms[w] / min(ms.values()) - 1.0
    return losses, regret


def report(rows: List[dict], profile: at.Profile) -> None:
    print(f"profile {profile}")
    for row in rows:
        ms, noise = measured(row)
        w, d = winner(row, profile), tuple(row["default"])
        f = min(ms, key=ms.get)
        lose = ms[w] - ms[d] > noise * ms[d]
        print(f"{row['kernel']:16s} B{row['B']} S{row['S']} Hq{row['Hq']} "
              f"Hkv{row['Hkv']} hd{row['hd']} {row['dtype']:8s} "
              f"winner {w[0]}x{w[1]} {ms[w]:.4f}  64x64 {ms[d]:.4f}  "
              f"fastest {f[0]}x{f[1]} {ms[f]:.4f}  regret "
              f"{ms[w] / ms[f] - 1:+.3f}  noise {noise:.3f}"
              f"{'  LOSES' if lose else ''}")
    losses, regret = score(rows, profile)
    print(f"losses {losses} of {len(rows)}, summed regret {regret:.4f}")


def fit(rows: List[dict], seed: int = 5, draws: int = 3000) -> at.Profile:
    """The best of ``draws`` profiles drawn from ``seed`` (log-uniform
    costs, some terms off), starting from one that keeps 64 x 64 almost
    everywhere. Costs are compared, not added across units, so scaling all
    of them leaves the picks alone: the mma cost is fixed at 1."""
    rng = random.Random(seed)
    best = replace(at.H100, tile_cost=1e9, mma_cost=1.0)
    best_score = score(rows, best)

    def lg(lo, hi):
        return 2.0 ** rng.uniform(lo, hi)

    for _ in range(draws):
        p = replace(at.H100, mma_cost=1.0, tile_cost=lg(0, 24),
                    throughput_cost=rng.choice((0.0, lg(-8, 4))),
                    launch_cost=rng.choice((0.0, lg(0, 22))),
                    units=rng.choice((8, 16, 32, 64, 128, 256, 512)),
                    align_discount=rng.choice((1.0, 0.95, 0.9)))
        s = score(rows, p)
        if s < best_score:
            best, best_score = p, s
    return best


def main(argv: List[str]) -> int:
    paths = [a for a in argv if not a.startswith("--")]
    rows = read(paths)
    if not rows:
        print("tile_fit: no tiles lines", file=sys.stderr)
        return 2
    # flash_mla's one tile has nothing to choose
    rows = [r for r in rows
            if len(at.tiles(r["body"], r["width_class"])) > 1]
    report(rows, at.H100)
    if "--fit" in argv:
        print()
        report(rows, fit(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
