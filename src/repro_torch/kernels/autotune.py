"""Deterministic tile picker for the flash prefill kernels: the port of
``repro/kernels/autotune.py``.

Timing at run time is banned here as in the JAX package (DET00x): the sweep
scores every candidate ``(block_q, block_k)`` with an *analytic* cost model,
so the same inputs always give the same winner, byte for byte, and a
winner is a recorded artifact, not something rediscovered per deploy.

Winners are cached in-process per Backend registry key

    backend|kernel|hd<head_dim>|<precision>|s<pow2 seq bucket>

and can be saved to / preloaded from a JSON table (``save_table`` /
``load_table``, or the ``REPRO_AUTOTUNE_CACHE`` environment variable) in
JAX's canonical form, so either package reads the other's table.
Precedence, highest first:

    REPRO_TILE_BQ / REPRO_TILE_BK   environment pin (both dims, all kernels)
    pin(...)                        in-code pin for one cache key
    cached winner                   from the table
    sweep                           the analytic model over the candidates

Units. JAX's ``block_q`` counts query *positions* (a Pallas tile holds
``block_q * G`` rows of a GQA group). The port's ``block_q`` counts
group-flattened query *rows* (``r = s * G + g``), the CUDA bodies' own
unit: one block holds ``block_q`` rows whatever G is. ``block_k`` counts
keys in both. The key has no G, as JAX's has none.

Two profiles hold the model's constants:

- ``TPU``: JAX's constants and candidates unchanged (a VMEM budget with a
  penalty past it, 128-lane alignment, a launch cost per grid step). Only
  the tests use it, to hold this model to JAX's bit for bit.
- ``H100``: what ``tile_config`` uses. Its candidates are exactly the
  tiles the CUDA bodies instantiate (``csrc/flash_prefill.cu``
  ``tc::TileSet``, per body and width class; a test reads them there).
  Its budget is the body's own dynamic shared memory at the tile
  (``smem_bytes``, mirrored from the source) against the 232,448 bytes a
  block may use: a candidate over it is excluded, since its launch would
  fail. Its alignment term is at the mma tile (multiples of 64; the fit
  left its discount at 1), and its launch cost is per block (a row tile of
  one (batch, kv head)).

The H100 model: a launch costs the longest of (1) its last row block, a
launch cost and a walk over every key tile, each a fixed cost plus its mma
work a warp; (2) all its blocks spread over the SMs at the blocks an SM
holds (bounded by the tile's shared memory, its threads, and 16 warps at
the bodies' >= 128 registers a thread); (3) its tensor work, masked
diagonal included, over the SMs; for a fixed count of (batch, kv head)
units, since the key has neither. Its constants were set once from two
runs of ``chip_smoke.py``'s ``tiles`` sweep on an NVIDIA H100 80GB HBM3 at
a 700.00 W power limit (``nvidia-smi --query-gpu=name,power.limit``;
``scripts/tile_fit.py``; PERF.md, PR 32, gives every candidate's time).
With them it picks 64 x 32 at S <= 32, at hd 128 from S 512 (52 KB of
shared memory against 64 x 64's 87 KB: twice the blocks an SM) and for
f32 from S 512 (256 at hd 128), ``flash_mla``'s one tile at MLA's width,
and 64 x 64 elsewhere.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

# JAX's candidates: the TPU profile's
CANDIDATE_BQ = (16, 32, 64, 128, 256)
CANDIDATE_BK = (16, 32, 64, 128, 256)

#: the shared memory a block may use on the H100, and an SM's (each block
#: reserves 1 KB of it), bytes; the threads an SM holds; its SMs
SMEM_LIMIT = 232448
SMEM_SM = 233472
THREADS_SM = 2048
SMS = 132
#: warps an SM holds at 128 registers a thread, the fewest any tile of the
#: bodies keeps (ptxas -v: 126-255)
WARPS_SM_BY_REGS = 65536 // (128 * 32)

_WINNERS: Dict[str, Tuple[int, int]] = {}
_PINS: Dict[str, Tuple[int, int]] = {}
_LOADED_ENV_CACHE = False


@dataclass(frozen=True)
class Profile:
    """One card's cost-model constants (arbitrary units: only the ordering
    of candidates matters, and it must stay deterministic)."""

    name: str
    launch_cost: float        # TPU: per grid step; H100: per block
    budget: int               # bytes of tile state / shared memory
    penalty: Optional[float]  # cost multiplier past the budget; None: excluded
    align: int                # tiles whose both dims are multiples stream best
    align_discount: float
    # H100 only. A block's latency per tile pair: a fixed part (barriers,
    # waits) and per (key, head column) and mma pass of a warp's 16 rows
    # (the block's warps run side by side). The SM's tensor throughput: per
    # (row, key, head column) and pass of the computed tiles, masked ones
    # included. The (batch, kv head) units a launch is taken to hold (the
    # key has neither batch nor heads).
    tile_cost: float = 0.0
    mma_cost: float = 0.0
    throughput_cost: float = 0.0
    units: int = 1

TPU = Profile(name="tpu", launch_cost=4096.0, budget=1 << 20, penalty=4.0,
              align=128, align_discount=0.9)

#: ``python3 scripts/tile_fit.py RUN1.log RUN2.log --fit`` over the tile
#: sweeps of two runs on an NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md,
#: PR 32): no loss to 64 x 64, and every switch away from it at least 3%
#: faster in every row of its key.
H100 = Profile(name="h100", launch_cost=984.2073042256409, budget=SMEM_LIMIT,
               penalty=None, align=64, align_discount=1.0,
               tile_cost=2093332.1708698384, mma_cost=1.0,
               throughput_cost=0.6965180820216691, units=128)

# ------------------------------------------------------------------ #
# The CUDA bodies' tiles and shared memory (csrc/flash_prefill.cu)
# ------------------------------------------------------------------ #
_FOUR = ((64, 32), (64, 64), (128, 32), (128, 64))
#: (tile family, width class) -> the (block_q, block_k) pairs instantiated:
#: ``tc::TileSet`` of the source (TC_BF16 "tc", TC_F32 "tc_f32", QTC "qtc"
#: for both q dtypes, Q4TC "q4tc" for both, MLA "tc_mla"). 64 x 128 spills
#: everywhere and 128 x 128 in three bodies (PERF.md, PR 32).
TILES: Mapping[Tuple[str, int], Tuple[Tuple[int, int], ...]] = {
    **{(family, w): _FOUR for family in ("tc", "tc_f32", "qtc", "q4tc")
       for w in (64, 96, 128)},
    ("tc", 192): ((64, 64),), ("tc_f32", 192): ((64, 64),),
    ("tc_mla", 192): ((128, 128),),
}
#: the tile of every tensor-core body before tiles were chosen at run time
#: (what ``block_q=None, block_k=None`` launches); flash_mla's one tile
DEFAULT_TILE = (64, 64)
MLA_TILE = (128, 128)
#: the quantized bodies' f32-q twins share their bf16-q twins' tiles
_FAMILY = {"tc": "tc", "tc_f32": "tc_f32", "tc_mla": "tc_mla", "qtc": "qtc",
           "qtc_f32": "qtc", "q4tc": "q4tc", "q4tc_f32": "q4tc"}
_GROUP = 32                 # int4 scale group (kv_int4.cuh)
_MLA_SMEM = 1024 + 128 * 3 * 128 + 2 * (128 * 3 * 128 + 128 * 2 * 128) + 64


def width(hd: int, dv: Optional[int] = None) -> int:
    """The width class a (hd, dv) launches in: MLA's 192 above hd 128, else
    the wider of the two rounded up to 64, 96 or 128 (the source's
    ``dispatch`` and ``by_width``)."""
    if hd > 128:
        return 192
    w = max(hd, dv if dv is not None else hd)
    return 64 if w <= 64 else 96 if w <= 96 else 128


def tiles(body: str, w: int) -> Tuple[Tuple[int, int], ...]:
    """The (block_q, block_k) pairs ``body`` (``flash_prefill.BODY`` /
    ``QBODY`` / ``Q4BODY`` values, ``MLA_BODY``) instantiates at width
    class ``w``; empty where it has none."""
    return TILES.get((_FAMILY[body], w), ())


def smem_bytes(body: str, hd: int, dv: int, bq: int, bk: int) -> int:
    """Dynamic shared memory of ``body`` at (hd, dv) and tile (bq, bk): the
    source's ``smem_bytes`` / ``qtc_smem_bytes`` / ``q4tc_smem_bytes`` (the
    larger of the staged tiles and the f32 epilogue over them), or
    ``flash_mla``'s fixed ring."""
    if body == "tc_mla":
        return _MLA_SMEM
    f32_q = body.endswith("_f32")
    if body.startswith("q4tc"):
        q = 0 if f32_q else 2 * bq * (hd + 8)
        tile = (q + 2 * bk * (hd + 8 + dv + 8) + 4 * bk * (hd + dv) // _GROUP
                + 2 * bk * (hd + dv) // 2)
        return max(tile, 4 * bq * (dv + 8))
    hdp, dvp = -(-hd // 16) * 16, -(-dv // 16) * 16
    q = 0 if f32_q else 2 * bq * (hdp + 8)
    if body.startswith("qtc"):
        tile = (q + 2 * bk * (hdp + 8 + dvp + 8) + 4 * 6 * bk
                + 2 * bk * (hdp + dvp))
    else:
        esz = 4 if f32_q else 2
        vs = dvp + 4 if f32_q else dvp + 8
        tile = q + esz * 2 * bk * (hdp + 8 + vs)
    return max(tile, 4 * bq * (dvp + 8))


def precision_label(kernel: str, q_bf16: bool) -> str:
    """A launch's precision in its key: ``flash_prefill``'s is q's dtype,
    "bf16" or "fp32" (its two bodies' tiles differ; JAX always says
    "fp32"), the quantized prefills' their K / V's, "int8" / "int4"."""
    if kernel == "flash_prefill":
        return "bf16" if q_bf16 else "fp32"
    return {"flash_qprefill": "int8", "flash_q4prefill": "int4"}[kernel]


def h100_body(kernel: str, precision: str, head_dim: int) -> str:
    """The body an H100 key's launches take: ``flash_prefill`` at "bf16"
    the tensor-core body (``flash_mla`` above hd 128), at "fp32" its
    two-term split; the int8 / int4 prefills their bodies (the f32-q twin
    shares the tiles)."""
    if kernel == "flash_prefill":
        if precision == "bf16":
            return "tc_mla" if head_dim > 128 else "tc"
        return "tc_f32"
    if kernel == "flash_qprefill":
        return "qtc"
    if kernel == "flash_q4prefill":
        return "q4tc"
    raise ValueError(f"no CUDA body for kernel {kernel!r}")


# ------------------------------------------------------------------ #
# The model
# ------------------------------------------------------------------ #
def pow2_bucket(n: int, floor: int = 16) -> int:
    """Next power-of-two >= n (a local copy, so the kernel layer stays
    below serving)."""
    b = floor
    while b < n:
        b <<= 1
    return b


def cache_key(backend: str, kernel: str, head_dim: int, precision: str,
              seq_len: int) -> str:
    return "|".join((backend, kernel, f"hd{head_dim}", precision,
                     f"s{pow2_bucket(seq_len)}"))


def _causal_pairs(s: int, bq: int, bk: int) -> int:
    """Tile pairs the kernel actually computes (diagonal included)."""
    nq, nk = -(-s // bq), -(-s // bk)
    return sum(min(nk - 1, (qi * bq + bq - 1) // bk) + 1 for qi in range(nq))


# mma passes per tile pair: the score product plus the value product over
# p split hi + lo (two), f32 operands split in two terms (three each way)
_PASSES = {"fp32": 6.0, "bf16": 3.0, "int8": 3.0, "int4": 3.0}


def _cost(s: int, bq: int, bk: int, head_dim: int, precision: str,
          profile: Profile = TPU, body: Optional[str] = None) -> float:
    """The analytic cost of one (bq, bk) at a bucket of s. ``TPU``: JAX's
    model, operation for operation. ``H100``: computed tile pairs times
    their mma passes, the K / V bytes they stream and a fixed cost each,
    plus a launch cost per block; ``body``'s shared memory over the budget
    makes it infinite (excluded)."""
    nq, nk = -(-s // bq), -(-s // bk)
    pairs = _causal_pairs(s, bq, bk)
    if profile.penalty is not None:
        # int8: 1 byte/elem; int4: packed nibbles, 0.5 byte/elem (per-group
        # scales are amortized over the group and ignored here); else f32
        kv_bytes = {"int8": 1.0, "int4": 0.5}.get(precision, 4.0)
        # two dots per tile pair (scores + accumulate) at f32 throughput
        compute = pairs * (2.0 * bq * bk * head_dim * 2.0)
        traffic = pairs * (bq * head_dim * 4 + 2 * bk * head_dim * kv_bytes)
        launch = nq * nk * profile.launch_cost
        cost = compute + traffic + launch
        tile_state = 4 * (bq * head_dim * 3 + 2 * bk * head_dim)
        if tile_state > profile.budget:
            cost *= profile.penalty
    else:
        if body is not None and smem_bytes(body, head_dim, head_dim, bq,
                                           bk) > profile.budget:
            return float("inf")
        passes = _PASSES[precision]
        latency = profile.tile_cost + bk * head_dim * passes * profile.mma_cost
        smem = smem_bytes(body, head_dim, head_dim, bq, bk) if body else 0
        # blocks an SM holds: by shared memory, by threads, and by registers
        # (every body keeps at least ~128 a thread: 16 warps an SM)
        resident = max(1, min(SMEM_SM // (smem + 1024),
                              THREADS_SM // (2 * bq),
                              WARPS_SM_BY_REGS // (bq // 16)))
        # the longest of: the last row block's launch and walk over every key
        # tile, the launch's blocks spread over the SMs' resident blocks, and
        # its tensor work over the SMs
        units = profile.units
        block = profile.launch_cost
        cost = max(block + nk * latency,
                   units * (nq * block + pairs * latency) / (SMS * resident),
                   units * pairs * bq * bk * head_dim * passes
                   * profile.throughput_cost / SMS)
    if bq % profile.align == 0 and bk % profile.align == 0:
        cost *= profile.align_discount
    return cost


def sweep(backend: str, kernel: str, head_dim: int, precision: str,
          seq_len: int, profile: Profile = H100) -> Tuple[int, int]:
    """Score every candidate pair; deterministic tie-break on the candidate
    tuple itself (sorted iteration order, strict improvement required).
    ``TPU``: JAX's candidates, clipped to the bucket as JAX's kernels clip
    their blocks. ``H100``: the instantiated tiles of the key's body and
    width class, unclipped (a CUDA block masks the rows and keys past S)."""
    s = pow2_bucket(seq_len)
    best: Optional[Tuple[int, int]] = None
    best_cost = float("inf")
    if profile.penalty is not None:
        for bq in CANDIDATE_BQ:
            for bk in CANDIDATE_BK:
                if bq > s and bq != CANDIDATE_BQ[0]:
                    continue
                if bk > s and bk != CANDIDATE_BK[0]:
                    continue
                c = _cost(s, min(bq, s), min(bk, s), head_dim, precision,
                          profile)
                if c < best_cost:
                    best, best_cost = (bq, bk), c
    else:
        body = h100_body(kernel, precision, head_dim)
        for bq, bk in sorted(tiles(body, width(head_dim))):
            c = _cost(s, bq, bk, head_dim, precision, profile, body)
            if c < best_cost:
                best, best_cost = (bq, bk), c
    if best is None:
        raise ValueError(f"no candidate tile fits {kernel} at hd {head_dim} "
                         f"{precision} on {profile.name}")
    return best


def pin(backend: str, kernel: str, head_dim: int, precision: str,
        seq_len: int, block_q: int, block_k: int) -> None:
    """In-code escape hatch: pin one cache key to explicit tile shapes."""
    _PINS[cache_key(backend, kernel, head_dim, precision, seq_len)] = (
        int(block_q), int(block_k))


def tile_config(backend: str, kernel: str, head_dim: int, precision: str,
                seq_len: int) -> Tuple[int, int]:
    """Resolve ``(block_q, block_k)`` for one kernel launch (see the module
    docstring for precedence). The pair is returned as resolved: a pin the
    body does not instantiate raises at the launch, never rounded."""
    env_bq = os.environ.get("REPRO_TILE_BQ")
    env_bk = os.environ.get("REPRO_TILE_BK")
    if env_bq and env_bk:
        return int(env_bq), int(env_bk)
    _maybe_load_env_cache()
    key = cache_key(backend, kernel, head_dim, precision, seq_len)
    if key in _PINS:
        return _PINS[key]
    if key not in _WINNERS:
        _WINNERS[key] = sweep(backend, kernel, head_dim, precision, seq_len)
    return _WINNERS[key]


def winner_table() -> Dict[str, Tuple[int, int]]:
    """Snapshot of every winner resolved so far (sweeps, loads — not pins)."""
    return dict(_WINNERS)


def serialize_table() -> str:
    """Canonical byte-identical form: sorted keys, fixed separators."""
    table = {k: list(v) for k, v in sorted(_WINNERS.items())}
    return json.dumps({"schema_version": 1, "winners": table},
                      indent=2, sort_keys=True) + "\n"


def save_table(path: str) -> None:
    with open(path, "w") as fh:
        fh.write(serialize_table())


def load_table(path: str) -> int:
    """Preload winners from a persisted table; returns entries loaded.
    Loaded entries win over re-sweeping."""
    with open(path) as fh:
        data = json.load(fh)
    winners = data.get("winners", {})
    for key, pair in winners.items():
        _WINNERS[key] = (int(pair[0]), int(pair[1]))
    return len(winners)


def reset() -> None:
    """Test hook: drop winners, pins, and the env-cache latch."""
    global _LOADED_ENV_CACHE
    _WINNERS.clear()
    _PINS.clear()
    _LOADED_ENV_CACHE = False


def _maybe_load_env_cache() -> None:
    global _LOADED_ENV_CACHE
    if _LOADED_ENV_CACHE:
        return
    _LOADED_ENV_CACHE = True
    path = os.environ.get("REPRO_AUTOTUNE_CACHE")
    if path and os.path.exists(path):
        load_table(path)
