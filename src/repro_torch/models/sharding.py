"""Tensor-parallel state and the shard group: the port of the serving half
of ``repro.models.sharding`` (``TPState``, ``tp_region``, ``tp_param_spec``,
``tp_cache_spec``).

The JAX package runs one process over a device mesh and ``shard_map``s each
serving entry point. The port keeps one process too, and runs each shard's
body on its own worker thread of a ``ShardGroup``: inside the body the model
runs on a *local* config (heads, kv heads and ``d_ff`` divided by tp), and
the ``wo``-site combine in ``layers.row_combine`` reads the thread's
``TPState`` to gather or reduce across the group. Outside a region the state
is None and every combine is a plain ``linear``.

A spec here is the one dim of a leaf that shards over the group, or None
(replicated): the port's form of the JAX ``PartitionSpec``, whose only
mesh axis under serving TP is "model". A dim that tp does not divide is
dropped, as ``checked_spec`` drops it.

The GSPMD training rules (``param_specs``, ``data_spec``, ``cache_spec``,
``constrain``, FSDP under a mesh) and the ``shard_map`` MoE dispatch are
not here: nothing on the serving path reaches them (ROADMAP Queue 1 item
10's remainder).
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Any, Callable, List, Optional, Sequence

import torch

from repro_torch.models.config import ModelConfig

#: seconds a shard waits for its peers at a combine before the group gives
#: up; a shard that raises breaks the wait at once
BARRIER_TIMEOUT_S = 120.0


@dataclasses.dataclass(frozen=True)
class TPState:
    tp: int                 # shard count
    combine: str            # "exact" (all_gather) | "psum" (row-parallel)
    rank: int = 0           # this shard's index in the group
    group: Optional["ShardGroup"] = None   # the combines' group


_TP_STATE: contextvars.ContextVar[Optional[TPState]] = contextvars.ContextVar(
    "repro_torch_tp_state", default=None)


def tp_state() -> Optional[TPState]:
    """The active ``TPState`` (inside a shard's body) or None."""
    return _TP_STATE.get()


def _check_combine(combine: str) -> None:
    if combine not in ("exact", "psum"):
        raise ValueError(f"unknown TP combine mode {combine!r} "
                         "(expected 'exact' or 'psum')")


@contextlib.contextmanager
def tp_region(tp: int, combine: str = "exact", rank: int = 0,
              group: Optional["ShardGroup"] = None):
    """Scope marking a shard's body as tensor-parallel."""
    _check_combine(combine)
    token = _TP_STATE.set(TPState(tp, combine, rank, group))
    try:
        yield
    finally:
        _TP_STATE.reset(token)


# --------------------------------------------------------------------- #
# Which dim of a param / cache leaf shards
# --------------------------------------------------------------------- #
#: attention / MLP input-side projections: column-parallel (the last dim
#: is a head or ff concat, contiguous chunks = per-shard head groups).
#: ``wi`` is only safe because the engine permutes its fused gate|up
#: columns first (``serving.sharded.permute_wi_for_tp``)
_TP_COL_RE = re.compile(r"(wq|wk|wv|w_uq|w_ukv|wi)$")
#: output-side projections: row-parallel in "psum" mode, replicated in
#: "exact" mode (the gathered activations need the full weight)
_TP_ROW_RE = re.compile(r"(wo)$")


def _checked(shape, dim: int, tp: int) -> Optional[int]:
    return dim if 0 <= dim < len(shape) and shape[dim] % tp == 0 else None


def tp_param_spec(path: str, shape, tp: int,
                  combine: str = "exact") -> Optional[int]:
    """The dim of param leaf ``path`` (``layers/3/attn/wq``) that shards
    under serving TP, or None. Only head / ff-parallel dims shard;
    embeddings, norms, MLA down-projections and the residual stream stay
    replicated, so each shard's model code sees full-width activations."""
    nd = len(shape)
    if _TP_COL_RE.search(path) and "moe" not in path:
        return _checked(shape, nd - 1, tp)
    if _TP_ROW_RE.search(path) and "moe" not in path and combine != "exact":
        return _checked(shape, nd - 2, tp)
    return None


def tp_cache_spec(cfg: ModelConfig, shape, tp: int) -> Optional[int]:
    """The dim of one KV-cache / pool leaf that shards under serving TP, or
    None. GQA leaves (dense ``[B, S, Hkv, ...]`` and paged ``[N, bs, Hkv,
    ...]`` payloads and their int8 / int4 scale rows) carry the kv-head
    axis at dim 2: shard it. MLA caches (``c_kv`` / ``k_rope``) are
    head-free latents shared by every head shard: replicate."""
    if cfg.attention != "mla" and len(shape) >= 3 \
            and shape[2] == cfg.n_kv_heads:
        return _checked(shape, 2, tp)
    return None


def shard_slice(t: torch.Tensor, dim: Optional[int], rank: int, tp: int,
                device) -> torch.Tensor:
    """Shard ``rank``'s part of ``t`` on ``device``: the rank-th contiguous
    chunk of ``dim`` (made contiguous), or ``t`` itself when ``dim`` is None
    (the same tensor, not a copy, when it already lies on ``device``)."""
    if dim is not None:
        n = t.shape[dim] // tp
        t = t.narrow(dim, rank * n, n).contiguous()
    return t.to(device)


# --------------------------------------------------------------------- #
# The shard group
# --------------------------------------------------------------------- #
class ShardGroup:
    """``tp`` shards, each with a device and a persistent worker thread.

    ``run(body)`` calls ``body(rank)`` on every shard's thread, under
    ``tp_region`` and the caller's grad / inference mode, on the shard's
    device (its default stream), and returns the results in rank order.
    Inside, ``all_gather`` and ``all_reduce`` exchange tensors: each shard
    posts its tensor and reads its peers', moved to its own device with
    ``.to(device)`` (a peer copy across cards).

    The shards take turns, in rank order, passing a baton at each combine:
    a shard runs until its combine, posts, hands the baton to the next rank
    and sleeps until the baton comes back round, when every peer has
    posted. So one shard thread runs at a time: the interpreter lock never
    ping-pongs between shard threads at every op (each torch op releases
    it), and on one card the shards' kernels queue on its default stream in
    baton order. Across cards the devices still overlap: launches are
    asynchronous. Posts alternate between two buffers: a shard cannot post
    twice ahead before every peer has read.

    A shard that raises aborts the group, so its peers stop waiting; a
    shard that does not pass the baton on within ``timeout`` seconds lets
    its peer's wait time out, and a shard that returns before a combine its
    peers reached breaks it. ``run`` then raises the first shard's own
    error (in rank order; a ``BrokenBarrierError`` only if no shard raised
    anything else)."""

    def __init__(self, devices: Sequence, combine: str = "exact",
                 timeout: float = BARRIER_TIMEOUT_S):
        _check_combine(combine)        # at construction, not the first run
        self.devices = [torch.device(d) for d in devices]
        self.tp = len(self.devices)
        self.combine = combine
        self.timeout = timeout
        self._workers = [ThreadPoolExecutor(1, f"tp-shard-{r}")
                         for r in range(self.tp)]
        self._start_run()

    def _start_run(self) -> None:
        """Fresh batons (rank 0 holds the first turn), posts and counts."""
        self._batons = [threading.Semaphore(0) for _ in range(self.tp)]
        self._batons[0].release()
        self._aborted = False
        self._posts = [[None] * self.tp, [None] * self.tp]
        self._combines = [0] * self.tp

    # ------------------------------------------------------------- #
    def _abort(self) -> None:
        self._aborted = True
        for baton in self._batons:
            baton.release()

    def _pass(self, rank: int) -> None:
        self._batons[(rank + 1) % self.tp].release()

    def _wait_turn(self, rank: int) -> None:
        if not self._batons[rank].acquire(timeout=self.timeout):
            self._abort()
            raise threading.BrokenBarrierError(
                f"shard {rank} waited {self.timeout} s for its turn")
        if self._aborted:
            raise threading.BrokenBarrierError(
                f"shard {rank}: a peer shard failed")

    def _exchange(self, x: torch.Tensor, rank: int) -> List[torch.Tensor]:
        n = self._combines[rank]
        buf = self._posts[n & 1]
        buf[rank] = x
        self._combines[rank] = n + 1
        self._pass(rank)
        self._wait_turn(rank)
        if min(self._combines) <= n:
            self._abort()
            raise threading.BrokenBarrierError(
                f"shard {rank}: a peer shard returned before combine {n}")
        return list(buf)

    def all_gather(self, x: torch.Tensor, rank: int,
                   dim: int = -1) -> torch.Tensor:
        """The shards' ``x`` concatenated along ``dim`` in rank order."""
        dev = self.devices[rank]
        return torch.cat([t.to(dev) for t in self._exchange(x, rank)],
                         dim=dim)

    def all_reduce(self, x: torch.Tensor, rank: int) -> torch.Tensor:
        """The shards' ``x`` summed in rank order: every rank adds the same
        operands in the same order and gets the same bits."""
        dev = self.devices[rank]
        parts = self._exchange(x, rank)
        out = parts[0].to(dev)
        for t in parts[1:]:
            out = out + t.to(dev)
        return out

    # ------------------------------------------------------------- #
    def _shard(self, rank: int, body, grad: bool, inference: bool):
        dev = self.devices[rank]
        try:
            self._wait_turn(rank)
            with contextlib.ExitStack() as stack:
                if dev.type == "cuda":
                    stack.enter_context(torch.cuda.device(dev))
                stack.enter_context(torch.inference_mode(inference))
                stack.enter_context(torch.set_grad_enabled(grad))
                stack.enter_context(tp_region(self.tp, self.combine, rank,
                                              self))
                out = body(rank)
        except BaseException:
            self._abort()                # peers stop waiting for this shard
            raise
        self._pass(rank)                 # the peers finish their turns
        return out

    def run(self, body: Callable[[int], Any]) -> List[Any]:
        """``[body(0), ..., body(tp - 1)]``, each on its shard's thread."""
        grad = torch.is_grad_enabled()
        inference = torch.is_inference_mode_enabled()
        futures = [w.submit(self._shard, r, body, grad, inference)
                   for r, w in enumerate(self._workers)]
        results, errors = [], []
        for f in futures:
            try:
                results.append(f.result(timeout=2 * self.timeout))
            except FutureTimeout:
                self._abort()
                errors.append(TimeoutError(
                    f"a shard ran past {2 * self.timeout} s"))
            except BaseException as e:   # the first is re-raised below
                errors.append(e)
        # drop the last combine's tensors; a run that failed leaves no
        # state to the next
        self._start_run()
        if errors:
            own = [e for e in errors
                   if not isinstance(e, threading.BrokenBarrierError)]
            raise (own or errors)[0]
        return results

    def close(self) -> None:
        for w in self._workers:
            w.shutdown(wait=True)
