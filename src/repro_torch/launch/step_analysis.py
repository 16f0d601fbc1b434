"""What a step costs each device: the counterpart of
``repro.launch.hlo_analysis``.

``analyze_step(fn, *args)`` runs ``fn`` once under a dispatch mode that
sees the *local* ops, the ones DTensor runs on each rank's shard (a mode
steps aside for DTensor arguments, so DTensor's own dispatch runs and its
local ops come back through the mode). On fake tensors (``launch/specs.py``)
nothing is computed and nothing is allocated. It returns ``analyze_hlo``'s
keys, per device:

    flops            matrix products only (mm, addmm, bmm, baddbmm: the
                     MFU convention, as ``analyze_hlo`` counts dots), by
                     ``torch.utils.flop_counter``'s formulas
    bytes            operand and output bytes of every local op that is
                     not a view or an allocation: the traffic of the eager
                     port, which fuses nothing
    collective_bytes output bytes of each collective (all-gather,
                     all-reduce, reduce-scatter, all-to-all), as JAX's
                     ``_LINE_RE`` counts them; ``collective_by_op`` and
                     ``collective_counts`` split them by kind

and the memory of the run: ``argument_bytes`` (the local shards of the
arguments, each tensor once), ``output_bytes`` (of the results), ``peak_bytes`` (the
arguments plus the most bytes of storages the step's ops held alive at
once: temporaries, activations saved for the backward, results).

DTensor derives each op's global output shape by running the op on fake
global tensors first; those runs are not the device's work, and the mode
skips everything inside ``ShardingPropagator``'s tensor-meta propagation.
"""
from __future__ import annotations

import threading
import weakref
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.tree import leaves_with_path

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
#: functional-collective op names -> JAX's collective kinds
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
#: ops that move no bytes of their own
_FREE = ("empty", "empty_strided", "empty_like", "wait_tensor", "device",
         "detach", "lift_fresh")


def _matmul_ops():
    aten = torch.ops.aten
    return {aten.mm, aten.addmm, aten.bmm, aten.baddbmm}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard, or ``t``."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def tree_bytes(tree) -> int:
    """Bytes of the local shards of the tensor leaves of ``tree``, each
    tensor once (leaves that are one tensor, as a fresh AdamW state's m and
    v are, count once)."""
    seen, total = set(), 0
    for _, t in leaves_with_path(tree):
        if not isinstance(t, torch.Tensor):
            continue
        t = local_tensor(t)
        key = (id(t.untyped_storage()), t.storage_offset(), t.numel())
        if key not in seen:
            seen.add(key)
            total += _nbytes(t)
    return total


class _Propagation:
    """Marks, per thread, that DTensor's tensor-meta propagation is
    running (the global-shape fake runs the mode must not count)."""

    def __init__(self):
        self.local = threading.local()

    def active(self) -> bool:
        return getattr(self.local, "depth", 0) > 0

    def wrap(self, fn):
        def run(*args, **kwargs):
            self.local.depth = getattr(self.local, "depth", 0) + 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.local.depth -= 1
        return run


class StepCounter(TorchDispatchMode):
    """Counts the local ops of a run (see the module's docstring)."""

    def __init__(self, arguments=()):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.by_op = {c: 0.0 for c in COLLECTIVES}
        self.counts = {c: 0.0 for c in COLLECTIVES}
        self.args = tree_bytes(arguments)
        self.live = 0
        self.peak = 0
        # the arguments' storages stay alive: views of them add nothing
        self._pinned = [local_tensor(t).untyped_storage()
                        for _, t in leaves_with_path(arguments)
                        if isinstance(t, torch.Tensor)]
        self._seen: set = {id(st) for st in self._pinned}
        self._matmuls = _matmul_ops()
        self._prop = _Propagation()
        self._patched = None

    # -- DTensor's propagation ------------------------------------------- #
    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        name = ("_propagate_tensor_meta_non_cached"
                if hasattr(ShardingPropagator,
                           "_propagate_tensor_meta_non_cached")
                else "_propagate_tensor_meta")
        orig = getattr(ShardingPropagator, name)
        self._patched = (ShardingPropagator, name, orig)
        setattr(ShardingPropagator, name, self._prop.wrap(orig))
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            cls, name, orig = self._patched
            setattr(cls, name, orig)

    # -- memory ------------------------------------------------------------ #
    def _free(self, key: int, nbytes: int) -> None:
        self._seen.discard(key)
        self.live -= nbytes

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = id(st)
            if key in self._seen:
                continue
            n = st.nbytes()
            self._seen.add(key)
            self.live += n
            weakref.finalize(st, self._free, key, n)
        self.peak = max(self.peak, self.live)

    # -- dispatch ---------------------------------------------------------- #
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor runs its local ops
        out = func(*args, **kwargs)
        if self._prop.active():
            return out
        packet = func._overloadpacket
        name = packet.__name__
        kind = _COLLECTIVE_OPS.get(name)
        if kind is not None:
            nb = sum(_nbytes(t) for t in _tensors(out))
            self.by_op[kind] += nb
            self.counts[kind] += 1
        elif packet in self._matmuls:
            from torch.utils.flop_counter import flop_registry

            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if kind is None and not func.is_view and name not in _FREE:
            self.bytes += sum(_nbytes(t) for t in _tensors(args)) \
                + sum(_nbytes(t) for t in _tensors(kwargs)) \
                + sum(_nbytes(t) for t in _tensors(out))
        self._track(out)
        return out

    def result(self, outputs=None) -> Dict[str, Any]:
        total = sum(self.by_op.values())
        return {
            "flops": float(self.flops),
            "bytes": float(self.bytes),
            "collective_bytes": float(total),
            "collective_by_op": dict(self.by_op),
            "collective_counts": dict(self.counts),
            "argument_bytes": int(self.args),
            "output_bytes": int(tree_bytes(outputs)) if outputs is not None
            else 0,
            "peak_bytes": int(self.args + self.peak),
        }


def analyze_step(fn, *args, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once under a ``StepCounter`` and return
    its counts per device (the module's docstring), with the run's
    ``outputs``."""
    counter = StepCounter(arguments=(args, kwargs))
    with counter:
        out = fn(*args, **kwargs)
    res = counter.result(out)
    res["outputs"] = out
    return res
