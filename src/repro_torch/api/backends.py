"""Pluggable kernel-backend registry: the port of ``repro.api.backends``.

A ``Backend`` implements the compute primitives the model layers dispatch
to through ``kernels/ops.py``: ``qmatmul_static`` / ``qmatmul_dynamic`` /
``quantize_weights`` / ``qdecode``, the paged decode trio, the flash
prefill trio, and the port's two int8 linears over the K-major packed
weight (``qmatmul_static_packed`` / ``qmatmul_dynamic_packed``, which
``models/layers.py`` calls for every packed leaf). Four backends ship
built-in:

    ref       the plain PyTorch versions (``kernels/ref.py``) on whatever
              device the tensors are on: on the card, the plain path by
              request
    cuda      the hand-written Hopper kernels (``csrc/*.cu``); a tensor
              that is not on a CUDA device is refused, never computed;
              the flash prefills launch the tile ``kernels/autotune.py``
              resolves for each call
    ref-tp    tensor-parallel twin of ref
    cuda-tp   tensor-parallel twin of cuda

Backend choice is scoped, not global: ``use_backend("ref")`` binds a
backend for the dynamic extent of a block (a ``contextvars.ContextVar``, as
``repro_torch.clock`` scopes clocks), and ``InferenceSession(...,
backend=)``, ``ContinuousBatchingEngine(..., backend=)``,
``SpecConfig(draft_backend=)`` and the fleet's agents and ``EnginePool``
bind one per call of their entry points, so one process can serve the
same artifact through the kernels on one session and the plain path on
another. The process default is ``cuda`` on a host with a CUDA device and
``ref`` without one; an unpinned session or engine on the CPU binds
``ref`` (``bind_for``).

The JAX package's ``pallas-*`` names have no counterpart: the CUDA kernels
have no interpret mode, so its ``REPRO_FORCE_KERNELS`` toggle, which picks
``pallas-interpret`` as the default, is not ported either.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, List, Optional, Tuple, Union

import torch

from repro_torch.device import DeviceLike
from repro_torch.kernels import autotune as _at
from repro_torch.kernels import dynquant as _dyn
from repro_torch.kernels import flash_prefill as _fp
from repro_torch.kernels import paged_attn as _pa
from repro_torch.kernels import qdecode as _qd
from repro_torch.kernels import qmatmul as _qmm
from repro_torch.kernels import quantize as _quant
from repro_torch.kernels import ref as _ref


class Backend:
    """Protocol/base for kernel backends. Subclass and ``register_backend``
    to plug in a new implementation."""

    name: str = "abstract"
    #: device types whose tensors the primitives take (None: any)
    device_types: Optional[Tuple[str, ...]] = None

    def qmatmul_static(self, x, w_int8, w_scale, act_scale, *,
                       out_dtype=torch.float32):
        raise NotImplementedError

    def qmatmul_dynamic(self, x, w_int8, w_scale, *, out_dtype=torch.float32):
        raise NotImplementedError

    def qmatmul_static_packed(self, x, w_packed, w_scale, act_scale, *,
                              out_dtype=torch.float32):
        raise NotImplementedError

    def qmatmul_dynamic_packed(self, x, w_packed, w_scale, *,
                               out_dtype=torch.float32):
        raise NotImplementedError

    def quantize_weights(self, w):
        raise NotImplementedError

    def qdecode(self, q, k_i8, k_s, v_i8, v_s, bias):
        raise NotImplementedError

    def paged_decode(self, q, k_pool, v_pool, tables, pos):
        raise NotImplementedError

    def paged_qdecode(self, q, k_pool, k_scale, v_pool, v_scale, tables, pos):
        raise NotImplementedError

    def paged_q4decode(self, q, k_pool, k_scale, v_pool, v_scale, tables,
                       pos):
        raise NotImplementedError

    def flash_prefill(self, q, k, v):
        raise NotImplementedError

    def flash_qprefill(self, q, k_i8, k_s, v_i8, v_s):
        raise NotImplementedError

    def flash_q4prefill(self, q, k_i4, k_s, v_i4, v_s):
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"<Backend {self.name}>"


class RefBackend(Backend):
    """The plain PyTorch versions of ``kernels/ref.py``, the same semantics
    as the kernels, on the tensors' own device."""

    name = "ref"

    def qmatmul_static(self, x, w_int8, w_scale, act_scale, *,
                       out_dtype=torch.float32):
        return _ref.qmatmul_static_ref(x, w_int8, w_scale, act_scale,
                                       out_dtype=out_dtype)

    def qmatmul_dynamic(self, x, w_int8, w_scale, *, out_dtype=torch.float32):
        return _ref.qmatmul_dynamic_ref(x, w_int8, w_scale,
                                        out_dtype=out_dtype)

    def qmatmul_static_packed(self, x, w_packed, w_scale, act_scale, *,
                              out_dtype=torch.float32):
        return _ref.qmatmul_static_packed_ref(x, w_packed, w_scale, act_scale,
                                              out_dtype=out_dtype)

    def qmatmul_dynamic_packed(self, x, w_packed, w_scale, *,
                               out_dtype=torch.float32):
        return _ref.qmatmul_dynamic_packed_ref(x, w_packed, w_scale,
                                               out_dtype=out_dtype)

    def quantize_weights(self, w):
        return _ref.quantize_ref(w)

    def qdecode(self, q, k_i8, k_s, v_i8, v_s, bias):
        return _ref.qdecode_ref(q, k_i8, k_s, v_i8, v_s, bias)

    def paged_decode(self, q, k_pool, v_pool, tables, pos):
        return _ref.paged_decode_ref(q, k_pool, v_pool, tables, pos)

    def paged_qdecode(self, q, k_pool, k_scale, v_pool, v_scale, tables, pos):
        return _ref.paged_qdecode_ref(q, k_pool, k_scale, v_pool, v_scale,
                                      tables, pos)

    def paged_q4decode(self, q, k_pool, k_scale, v_pool, v_scale, tables,
                       pos):
        return _ref.paged_q4decode_ref(q, k_pool, k_scale, v_pool, v_scale,
                                       tables, pos)

    def flash_prefill(self, q, k, v):
        """DTensor q / k / v (a step on a mesh) take the plain version on
        each rank's rows and heads, through the same ``local_map`` as the
        kernel (``models.sharding.attention_local``)."""
        from torch.distributed.tensor import DTensor

        if isinstance(q, DTensor):
            from repro_torch.models.sharding import attention_local

            return attention_local(_ref.flash_prefill_ref, q, k, v,
                                   "flash_prefill")
        return _ref.flash_prefill_ref(q, k, v)

    def flash_qprefill(self, q, k_i8, k_s, v_i8, v_s):
        return _ref.flash_qprefill_ref(q, k_i8, k_s, v_i8, v_s)

    def flash_q4prefill(self, q, k_i4, k_s, v_i4, v_s):
        return _ref.flash_q4prefill_ref(q, k_i4, k_s, v_i4, v_s)


def _on_card(primitive: str, t) -> None:
    """Refuse a tensor the kernels cannot take: each kernel entry computes
    the plain version for CPU tensors, which under the name ``cuda`` would
    be a hidden fallback."""
    if not t.is_cuda:
        raise ValueError(
            f"backend 'cuda': {primitive} got a tensor on {t.device}; the "
            "CUDA kernels take CUDA tensors (pin 'ref' for the plain path)")


class CudaBackend(Backend):
    """The hand-written Hopper kernels, through the kernel entries of
    ``repro_torch.kernels`` (which check their operands, build the library
    at first use and count each launch). Every method refuses a lead tensor
    that is not on a CUDA device before it dispatches. The entries have no
    interpret mode: the CPU leg of each primitive is ``RefBackend``'s."""

    name = "cuda"
    device_types = ("cuda",)

    # repro: allow-kernel-contract -- no interpret mode; CPU leg is RefBackend
    def qmatmul_static(self, x, w_int8, w_scale, act_scale, *,
                       out_dtype=torch.float32):
        _on_card("qmatmul_static", x)
        return _qmm.qmatmul_static(x, w_int8, w_scale, act_scale,
                                   out_dtype=out_dtype)

    # repro: allow-kernel-contract -- no interpret mode; CPU leg is RefBackend
    def qmatmul_dynamic(self, x, w_int8, w_scale, *, out_dtype=torch.float32):
        _on_card("qmatmul_dynamic", x)
        return _dyn.qmatmul_dynamic(x, w_int8, w_scale, out_dtype=out_dtype)

    # repro: allow-kernel-contract -- no interpret mode; CPU leg is RefBackend
    def qmatmul_static_packed(self, x, w_packed, w_scale, act_scale, *,
                              out_dtype=torch.float32):
        _on_card("qmatmul_static_packed", x)
        return _qmm.qmatmul_static_packed(x, w_packed, w_scale, act_scale,
                                          out_dtype=out_dtype)

    # repro: allow-kernel-contract -- no interpret mode; CPU leg is RefBackend
    def qmatmul_dynamic_packed(self, x, w_packed, w_scale, *,
                               out_dtype=torch.float32):
        _on_card("qmatmul_dynamic_packed", x)
        return _dyn.qmatmul_dynamic_packed(x, w_packed, w_scale,
                                           out_dtype=out_dtype)

    # repro: allow-kernel-contract -- no interpret mode; CPU leg is RefBackend
    def quantize_weights(self, w):
        _on_card("quantize_weights", w)
        return _quant.quantize_weights(w)

    # repro: allow-kernel-contract -- no interpret mode; CPU leg is RefBackend
    def qdecode(self, q, k_i8, k_s, v_i8, v_s, bias):
        _on_card("qdecode", q)
        return _qd.qdecode(q, k_i8, k_s, v_i8, v_s, bias)

    # repro: allow-kernel-contract -- no interpret mode; CPU leg is RefBackend
    def paged_decode(self, q, k_pool, v_pool, tables, pos):
        _on_card("paged_decode", q)
        return _pa.paged_decode(q, k_pool, v_pool, tables, pos)

    # repro: allow-kernel-contract -- no interpret mode; CPU leg is RefBackend
    def paged_qdecode(self, q, k_pool, k_scale, v_pool, v_scale, tables, pos):
        _on_card("paged_qdecode", q)
        return _pa.paged_qdecode(q, k_pool, k_scale, v_pool, v_scale, tables,
                                 pos)

    # repro: allow-kernel-contract -- no interpret mode; CPU leg is RefBackend
    def paged_q4decode(self, q, k_pool, k_scale, v_pool, v_scale, tables,
                       pos):
        _on_card("paged_q4decode", q)
        return _pa.paged_q4decode(q, k_pool, k_scale, v_pool, v_scale,
                                  tables, pos)

    def flash_tile(self, kernel: str, q) -> Tuple[int, int]:
        """The (block_q, block_k) this backend's ``kernel`` leg launches
        for q [B, S, Hq, hd], as JAX's Pallas legs pick theirs: the
        deterministic autotuner keyed by this backend's name, the kernel,
        hd, the precision label and S's bucket (``REPRO_TILE_*`` and pins
        first). flash_prefill's label is q's dtype, "bf16" or "fp32" (the
        two bodies' tiles differ); the quantized prefills' "int8" /
        "int4"."""
        precision = _at.precision_label(kernel, q.dtype == torch.bfloat16)
        return _at.tile_config(self.name, kernel, q.shape[-1], precision,
                               q.shape[1])

    # The flash legs launch the tile flash_tile resolves, or raise where
    # the body does not instantiate it; a DTensor step resolves it on each
    # rank's local shapes.

    # repro: allow-kernel-contract -- no interpret mode; CPU leg is RefBackend
    def flash_prefill(self, q, k, v):
        _on_card("flash_prefill", q)
        from torch.distributed.tensor import DTensor

        if isinstance(q, DTensor):
            from repro_torch.models.sharding import attention_local

            return attention_local(self.flash_prefill, q, k, v,
                                   "flash_prefill")
        bq, bk = self.flash_tile("flash_prefill", q)
        return _fp.flash_prefill(q, k, v, block_q=bq, block_k=bk)

    # repro: allow-kernel-contract -- no interpret mode; CPU leg is RefBackend
    def flash_qprefill(self, q, k_i8, k_s, v_i8, v_s):
        _on_card("flash_qprefill", q)
        bq, bk = self.flash_tile("flash_qprefill", q)
        return _fp.flash_qprefill(q, k_i8, k_s, v_i8, v_s, block_q=bq,
                                  block_k=bk)

    # repro: allow-kernel-contract -- no interpret mode; CPU leg is RefBackend
    def flash_q4prefill(self, q, k_i4, k_s, v_i4, v_s):
        _on_card("flash_q4prefill", q)
        bq, bk = self.flash_tile("flash_q4prefill", q)
        return _fp.flash_q4prefill(q, k_i4, k_s, v_i4, v_s, block_q=bq,
                                   block_k=bk)


class TPBackend(Backend):
    """Tensor-parallel twin of an inner backend (mesh-aware serving).

    The compute primitives delegate 1:1 to the inner backend: under TP the
    engine runs every model entry point on each shard of a
    ``serving.sharded.TPContext``, so a primitive already sees its shard's
    kv-head slice of q / pools / scales; the cross-shard combine lives at
    the model's wo sites (``layers.row_combine``), not here.

    Pinning a ``*-tp`` backend is the transparent opt-in:
    ``ContinuousBatchingEngine`` (and the fleet ``EnginePool``) shard the
    engine with ``default_tp`` shards unless an explicit ``tp=N`` /
    ``EngineConfig(tp=N)`` overrides it.
    """

    def __init__(self, name: str, inner: str, default_tp: int = 2):
        self.name = name
        self.inner_name = inner
        self.default_tp = default_tp

    @property
    def inner(self) -> "Backend":
        return get_backend(self.inner_name)

    @property
    def device_types(self) -> Optional[Tuple[str, ...]]:
        return self.inner.device_types

    def qmatmul_static(self, x, w_int8, w_scale, act_scale, *,
                       out_dtype=torch.float32):
        return self.inner.qmatmul_static(x, w_int8, w_scale, act_scale,
                                         out_dtype=out_dtype)

    def qmatmul_dynamic(self, x, w_int8, w_scale, *, out_dtype=torch.float32):
        return self.inner.qmatmul_dynamic(x, w_int8, w_scale,
                                          out_dtype=out_dtype)

    def qmatmul_static_packed(self, x, w_packed, w_scale, act_scale, *,
                              out_dtype=torch.float32):
        return self.inner.qmatmul_static_packed(x, w_packed, w_scale,
                                                act_scale,
                                                out_dtype=out_dtype)

    def qmatmul_dynamic_packed(self, x, w_packed, w_scale, *,
                               out_dtype=torch.float32):
        return self.inner.qmatmul_dynamic_packed(x, w_packed, w_scale,
                                                 out_dtype=out_dtype)

    def quantize_weights(self, w):
        return self.inner.quantize_weights(w)

    def qdecode(self, q, k_i8, k_s, v_i8, v_s, bias):
        return self.inner.qdecode(q, k_i8, k_s, v_i8, v_s, bias)

    def paged_decode(self, q, k_pool, v_pool, tables, pos):
        return self.inner.paged_decode(q, k_pool, v_pool, tables, pos)

    def paged_qdecode(self, q, k_pool, k_scale, v_pool, v_scale, tables, pos):
        return self.inner.paged_qdecode(q, k_pool, k_scale, v_pool, v_scale,
                                        tables, pos)

    def paged_q4decode(self, q, k_pool, k_scale, v_pool, v_scale, tables,
                       pos):
        return self.inner.paged_q4decode(q, k_pool, k_scale, v_pool, v_scale,
                                         tables, pos)

    def flash_prefill(self, q, k, v):
        return self.inner.flash_prefill(q, k, v)

    def flash_qprefill(self, q, k_i8, k_s, v_i8, v_s):
        return self.inner.flash_qprefill(q, k_i8, k_s, v_i8, v_s)

    def flash_q4prefill(self, q, k_i4, k_s, v_i4, v_s):
        return self.inner.flash_q4prefill(q, k_i4, k_s, v_i4, v_s)


# ------------------------------------------------------------------ #
# Registry
# ------------------------------------------------------------------ #
_BACKENDS: Dict[str, Backend] = {}


def register_backend(backend: Backend, name: Optional[str] = None) -> Backend:
    _BACKENDS[name or backend.name] = backend
    return backend


def available_backends() -> List[str]:
    return sorted(_BACKENDS)


def get_backend(name: Union[str, Backend]) -> Backend:
    if isinstance(name, Backend):
        return name
    try:
        return _BACKENDS[name]
    except KeyError:
        raise KeyError(
            f"unknown kernel backend {name!r}; registered backends: "
            f"{', '.join(available_backends())}") from None


register_backend(RefBackend())
register_backend(CudaBackend())
# tensor-parallel twins: same kernels, the engine shards the model around
register_backend(TPBackend("ref-tp", inner="ref"))
register_backend(TPBackend("cuda-tp", inner="cuda"))


# ------------------------------------------------------------------ #
# Default + scoped selection
# ------------------------------------------------------------------ #
_DEFAULT: List[Optional[Backend]] = [None]   # resolved lazily, cached
_ACTIVE: contextvars.ContextVar[Optional[Backend]] = contextvars.ContextVar(
    "repro_torch_active_backend", default=None)


def default_backend() -> Backend:
    """``cuda`` on a host with a CUDA device, ``ref`` without one; resolved
    once, then cached."""
    if _DEFAULT[0] is None:
        _DEFAULT[0] = get_backend("cuda" if torch.cuda.is_available()
                                  else "ref")
    return _DEFAULT[0]


def set_default_backend(name: Optional[Union[str, Backend]]) -> None:
    """Override (or with None: re-resolve) the process-wide default."""
    _DEFAULT[0] = get_backend(name) if name is not None else None


def current_backend() -> Backend:
    """The backend in scope: the innermost ``use_backend`` binding, else
    the process default. ``kernels/ops.py`` reads it on every call."""
    active = _ACTIVE.get()
    return active if active is not None else default_backend()


@contextlib.contextmanager
def use_backend(name: Optional[Union[str, Backend]]) -> Iterator[Backend]:
    """Bind a backend for the dynamic extent of the block. ``None`` is a
    no-op (keeps whatever is currently in scope)."""
    if name is None:
        yield current_backend()
        return
    token = _ACTIVE.set(get_backend(name))
    try:
        yield _ACTIVE.get()
    finally:
        _ACTIVE.reset(token)


def bind_for(backend: Optional[Union[str, Backend]],
             device: DeviceLike) -> Optional[Backend]:
    """The backend a session, engine or draft on ``device`` runs its entry
    points under: the pinned ``backend``, refused at once where it cannot
    take the device's tensors (``cuda`` on the CPU); unpinned, ``ref`` on
    the CPU and None (the backend in scope) elsewhere."""
    dev = torch.device(device) if device is not None else None
    if backend is None:
        return get_backend("ref") if dev is not None \
            and dev.type == "cpu" else None
    b = get_backend(backend)
    types = b.device_types
    if types is not None and (dev is None or dev.type not in types):
        raise ValueError(
            f"backend {b.name!r} takes {' / '.join(types)} tensors; this "
            f"session's device is {dev}")
    return b
