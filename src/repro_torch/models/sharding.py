"""Sharding: the port of ``repro.models.sharding``, both halves.

**Training: the GSPMD rules on a DTensor mesh.** A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the dim names ``("data",
"model")`` or ``("pod", "data", "model")`` (``launch/mesh.py``). A ``Spec``
has one entry per tensor dim: None, a mesh dim name, or a tuple of names
(the JAX ``PartitionSpec``); ``placements`` maps it to DTensor
``Shard`` / ``Replicate`` placements. ``_param_rule``, ``param_specs``,
``data_spec`` and ``cache_spec(s)`` are JAX's rules: batch-like dims on every
non-model axis, tensor-parallel dims and MoE expert dims on "model", and
under ``cfg.fsdp`` weight input dims on "data" as well. Every entry is
shape-checked (``checked_spec``): a dim the mesh axes do not divide stays
unsharded. The port's leaves are per layer (``layers/3/attn/wq``, where JAX
stacks ``[L, ...]``), so a port spec is JAX's with the leading stacked
entries dropped. The rules read a mesh's dim names and sizes only, so they
take a ``DeviceMesh`` or any object with ``axis_names`` and a ``shape``
mapping (JAX's ``AbstractMesh``).

``set_mesh`` is the counterpart of ``jax.set_mesh``: inside it, ``constrain``
(``with_sharding_constraint``) redistributes a DTensor to a spec, plain
tensors mixed into DTensor ops count as replicated, and ``moe_ffn`` takes a
mesh dispatch. Outside it ``constrain`` returns its input.

**Serving: tensor-parallel state and the shard group** (``TPState``,
``tp_region``, ``tp_param_spec``, ``tp_cache_spec``). The JAX package runs
one process over a device mesh and ``shard_map``s each serving entry point.
The port keeps one process too, and runs each shard's body on its own worker
thread of a ``ShardGroup``: inside the body the model runs on a *local*
config (heads, kv heads and ``d_ff`` divided by tp), and the ``wo``-site
combine in ``layers.row_combine`` reads the thread's ``TPState`` to gather
or reduce across the group. Outside a region the state is None and every
combine is a plain ``linear``. A serving spec is the one dim of a leaf that
shards over the group, or None (replicated); a dim that tp does not divide
is dropped, as ``checked_spec`` drops it.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.tree import leaves_with_path, map_with_path

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
# The GSPMD training rules
# --------------------------------------------------------------------- #
class Spec:
    """A partition spec: one entry per tensor dim, each None, a mesh dim
    name, or a tuple of names (JAX's ``PartitionSpec``). Not a tuple, so the
    tree helpers (``repro_torch.tree``) take a spec tree's specs as leaves;
    it compares equal to a ``Spec`` or a tuple of the same entries."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other):
        if isinstance(other, Spec):
            other = other.entries
        return isinstance(other, tuple) and self.entries == other

    def __hash__(self):
        return hash(self.entries)

    def __repr__(self):
        return f"Spec{self.entries!r}"


def mesh_axes(mesh) -> Dict[str, int]:
    """{dim name: size} of a ``DeviceMesh`` or of a mesh-like object with
    ``axis_names`` and a ``shape`` mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh_axes(mesh) if a in ("pod", "data"))


def _axis_size(axes_of: Dict[str, int], axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= axes_of[a]
    return n


def _fits(shape, dim: int, axes_of: Dict[str, int], axes) -> bool:
    return dim < len(shape) and shape[dim] % _axis_size(axes_of, axes) == 0


def checked_spec(shape, mesh, *entries) -> Spec:
    """A spec of ``entries``, dropping any entry whose dim the named axes do
    not divide."""
    axes_of = mesh_axes(mesh)
    return Spec(*(e if e and _fits(shape, i, axes_of, e) else None
                  for i, e in enumerate(entries)))


def _replicated(nd: int) -> Spec:
    return Spec(*([None] * nd))


def _param_rule(path: str, shape, mesh, cfg: ModelConfig) -> Spec:
    """The spec of param leaf ``path`` (JAX's rules, read on the leaf's own
    rank, so a per-layer leaf gets JAX's spec less the stacked dims)."""
    fsdp = "data" if (cfg.fsdp and "data" in mesh_axes(mesh)) else None
    nd = len(shape)

    # quantized leaves: w_int8 shards like its parent weight; scales replicate
    if path.endswith(("/w_int8", "/w_int4")):
        path = path[: -len("/w_int8")]
    elif re.search(r"/(scale|act_scale|zero)$", path):
        return _replicated(nd)

    def spec(*tail):
        """Pad with leading Nones for dims in front of the rule's tail."""
        lead = (None,) * (nd - len(tail))
        return checked_spec(shape, mesh, *lead, *tail)

    if re.search(r"(embed|extra_embeds)$", path):
        return spec("model", fsdp)                    # [V, d] vocab-parallel
    if re.search(r"(unembed|out_heads)$", path):
        return spec(fsdp, "model")                    # [d, V]
    if re.search(r"moe/(wi|wo)$", path):
        return spec("model", fsdp, None)              # [E, ., .] expert-parallel
    if re.search(r"router$", path):
        return spec(None, None)
    if re.search(r"(wq|wk|wv|w_uq|w_ukv|wi|w_in|w_x|w_gate|shared_wi"
                 r"|frontend_proj)$", path):
        return spec(fsdp, "model")                    # column-parallel [d, X]
    if re.search(r"(wo|w_out|shared_wo)$", path):
        return spec("model", fsdp)                    # row-parallel [X, d]
    if re.search(r"(w_dq|w_dkv|w_kr)$", path):
        return spec(fsdp, None)                       # low-rank down-proj
    if re.search(r"conv_w$", path):
        return spec(None, "model")                    # [W, C] channel-parallel
    if re.search(r"(A_log|D|dt_bias)$", path):
        return spec("model")                          # per-head [H]
    if re.search(r"(wa|wi_gate)$", path) and nd >= 3:
        return spec(None, None, None)                 # block-diag gates
    return _replicated(nd)                            # norms, biases, lam, ...


def param_specs(cfg: ModelConfig, params, mesh=None):
    """The spec tree of a param tree (tensors or fake tensors), on ``mesh``
    (default: the ambient mesh)."""
    mesh = _mesh_or_ambient(mesh)
    return map_with_path(
        lambda path, leaf: _param_rule(path, tuple(leaf.shape), mesh, cfg),
        params)


def data_spec(shape, mesh) -> Spec:
    """Batch-first arrays: [B, ...] -> batch on every non-model axis."""
    return checked_spec(shape, mesh, batch_axes(mesh),
                        *([None] * (len(shape) - 1)))


def cache_spec(shape, mesh, stacked: bool = False) -> Spec:
    """A cache leaf, ``[B, ...]`` per layer (``stacked``: JAX's ``[L, B,
    ...]``): batch axes to the batch dim if divisible, then "model" to the
    largest remaining dim it divides (the later one on a tie)."""
    axes_of = mesh_axes(mesh)
    b = batch_axes(mesh)
    entries: list = [None] * len(shape)
    bdim = 1 if stacked else 0
    if _fits(shape, bdim, axes_of, b):
        entries[bdim] = b
    m = _axis_size(axes_of, "model")
    cand = [(shape[i], i) for i in range(bdim + 1, len(shape))
            if shape[i] % m == 0 and shape[i] >= m]
    if cand:
        entries[max(cand)[1]] = "model"
    return Spec(*entries)


def cache_specs(mesh, caches):
    return map_with_path(lambda _, leaf: cache_spec(tuple(leaf.shape), mesh),
                         caches)


# --------------------------------------------------------------------- #
# Specs on a DeviceMesh: placements, distribution, the ambient mesh
# --------------------------------------------------------------------- #
def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements (one per mesh dim) of ``spec``: ``Shard(i)`` on
    each mesh dim that entry i names, ``Replicate`` elsewhere. A tuple entry
    must name its axes in mesh order (major first, as JAX lays them out)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    out = [Replicate() for _ in names]
    for i, e in enumerate(spec):
        if not e:
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {e!r}: axes out of mesh order "
                             f"{names}")
        for d in dims:
            if not isinstance(out[d], Replicate):
                raise ValueError(f"spec {spec}: mesh dim {names[d]!r} "
                                 "shards two tensor dims")
            out[d] = Shard(i)
    return tuple(out)


def is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def to_placements(t: torch.Tensor, mesh, pl) -> torch.Tensor:
    """``t`` redistributed to placements ``pl`` on ``mesh``; a plain tensor
    counts as replicated there (the same on every rank)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return t.redistribute(mesh, list(pl))


def reduce_partials(t: torch.Tensor) -> torch.Tensor:
    """A DTensor ``t`` with its partial dims reduced (its other placements
    kept); a plain tensor as it is."""
    if not is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    from torch.distributed.tensor import Replicate

    return t.redistribute(t.device_mesh, [
        Replicate() if p.is_partial() else p for p in t.placements])


def _sharding_dims(t, dim: int):
    return [i for i, p in enumerate(t.placements)
            if p.is_shard() and p.dim == dim]


def gather_dim(t: torch.Tensor, dim: int) -> torch.Tensor:
    """A DTensor ``t`` gathered whole along ``dim`` (its other placements
    kept); a plain tensor as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate

    dim %= t.dim()
    dims = _sharding_dims(t, dim)
    if not dims:
        return t
    return t.redistribute(t.device_mesh, [
        Replicate() if i in dims else p for i, p in enumerate(t.placements)])


def split_heads(t: torch.Tensor, n_heads: int, head_dim: int):
    """``t`` [..., H * hd] -> [..., H, hd]. Where mesh dims shard the last
    dim of a DTensor ``t`` and do not divide H (8 kv heads over a "model"
    of 16), ``t`` is first gathered over them: GSPMD shards inside the
    heads, a view DTensor cannot take."""
    if is_dtensor(t):
        n = 1
        for i in _sharding_dims(t, t.dim() - 1):
            n *= t.device_mesh.size(i)
        if n_heads % n:
            t = gather_dim(t, -1)
    return t.reshape(*t.shape[:-1], n_heads, head_dim)


def attention_local(attend, q, k, v, what: str):
    """``attend(q, k, v)`` (q [B,S,Hq,hd], k / v [B,S,Hkv,.], contiguous)
    of DTensors on each rank's rows and heads (``local_map``). q's
    placements must be its checked spec ``(batch axes, None, "model",
    None)`` and k / v's theirs, else it raises (nothing falls back to an
    unsharded call); where "model" does not divide the kv heads, k / v are
    whole over it and each rank slices the kv heads its query heads read,
    their grads summing over "model"."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    if not all(isinstance(t, DTensor) and t.device_mesh == mesh
               for t in (k, v)):
        raise ValueError(f"{what}: q, k, v must be DTensors on one mesh")
    b_ax = batch_axes(mesh)

    def want(t):
        return placements(checked_spec(tuple(t.shape), mesh, b_ax, None,
                                       "model", None), mesh)

    pq, pk, pv = want(q), want(k), want(v)
    for name, t, pl in (("q", q, pq), ("k", k, pk), ("v", v, pv)):
        if tuple(t.placements) != pl:
            raise ValueError(f"{what}: {name} placements "
                             f"{tuple(t.placements)} on {mesh}, want {pl}")
    hq, hkv = q.shape[2], k.shape[2]
    names = mesh.mesh_dim_names
    m = names.index("model") if "model" in names else None
    kv_whole = (m is not None and isinstance(pq[m], Shard)
                and isinstance(pk[m], Replicate))
    grads = [pq, pk, pv]
    if kv_whole:
        hq_l, g = hq // mesh.size(m), hq // hkv
        if hq_l % g and g % hq_l:
            raise ValueError(f"{what}: {hq_l} query heads a shard do not "
                             f"cover whole groups of {g}")
        grads = [pq] + [tuple(Partial() if i == m else p
                              for i, p in enumerate(pl)) for pl in (pk, pv)]

    def body(ql, kl, vl):
        ql, kl, vl = (contiguous_grad(t) for t in (ql, kl, vl))
        if kv_whole:
            # the kv heads this rank's query heads read
            h0 = mesh.get_local_rank(m) * hq_l
            k0, k1 = h0 // g, (h0 + hq_l - 1) // g + 1
            kl, vl = kl[:, :, k0:k1], vl[:, :, k0:k1]
        return attend(ql.contiguous(), kl.contiguous(), vl.contiguous())

    fn = local_map(body, out_placements=list(pq),
                   in_placements=(list(pq), list(pk), list(pv)),
                   in_grad_placements=tuple(list(g) for g in grads),
                   device_mesh=mesh)
    return fn(q, k, v)


def batch_local(fn, params, x: torch.Tensor, n_out: int):
    """``fn(params, x)`` on each rank's batch rows (``local_map``) for a
    DTensor ``x`` [B, ...]; ``fn`` returns a tuple of ``n_out`` batch-first
    tensors. x sits on the batch axes and is replicated over "model", every
    leaf of ``params`` is gathered whole to each rank (its grads summed over
    the batch shards), and every output is batch-first on the batch axes.
    The recurrent mixers run so: DTensor cannot propagate the strided shards
    their channel splits would take over "model"."""
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh = x.device_mesh
    rep = [Replicate()] * mesh.ndim
    x_pl = list(placements(data_spec(tuple(x.shape), mesh), mesh))
    p_grad = [Partial() if q.is_shard() else Replicate() for q in x_pl]
    paths = [path for path, _ in leaves_with_path(params)]

    def body(xl, *leaves):
        by_path = dict(zip(paths, (contiguous_grad(t) for t in leaves)))
        return tuple(fn(map_with_path(lambda path, _: by_path[path], params),
                        contiguous_grad(xl)))

    f = local_map(body, out_placements=tuple([x_pl] * n_out),
                  in_placements=(x_pl,) + (rep,) * len(paths),
                  in_grad_placements=(x_pl,) + (p_grad,) * len(paths),
                  device_mesh=mesh)
    return f(x.redistribute(mesh, x_pl),
             *(to_placements(t, mesh, rep) for _, t in leaves_with_path(params)))


def shard_tensor(t: torch.Tensor, spec: Spec, mesh):
    """The DTensor of the full tensor ``t`` (the same on every rank) laid
    out by ``spec``: each rank keeps its own chunk, no collective."""
    from torch.distributed.tensor import DTensor, Shard

    pl = placements(spec, mesh)
    local = t
    coord = mesh.get_coordinate()
    for d, p in enumerate(pl):
        if isinstance(p, Shard):
            n = mesh.size(d)
            if local.shape[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(t.shape)} does not "
                                 f"divide over {n}")
            local = local.chunk(n, dim=p.dim)[coord[d]]
    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False)


def distribute(tree, specs, mesh):
    """``tree`` (full tensors) as DTensors laid out by the spec tree."""
    from repro_torch.tree import get_path

    return map_with_path(
        lambda path, t: shard_tensor(t, get_path(specs, path), mesh), tree)


def full_tree(tree):
    """Every DTensor of ``tree`` gathered to its full tensor (a collective
    on each); other leaves as they are."""
    return map_with_path(
        lambda _, t: t.full_tensor() if is_dtensor(t) else t, tree)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes its grad contiguous."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def contiguous_grad(t: torch.Tensor) -> torch.Tensor:
    """``t``, whose grad arrives contiguous. A ``local_map`` body applies it
    to its inputs: DTensor's backward of a matmul views its grad's local
    tensor, which a body's transposed local grad would not fit."""
    return _ContiguousGrad.apply(t) if t.requires_grad else t


_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


def current_mesh():
    """The ambient mesh (inside ``set_mesh``) or None."""
    return _MESH.get()


def _mesh_or_ambient(mesh):
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        raise ValueError("no mesh given and none set (repro_torch.models."
                         "sharding.set_mesh)")
    return mesh


@contextlib.contextmanager
def set_mesh(mesh):
    """Make ``mesh`` ambient (``jax.set_mesh``): ``constrain`` redistributes
    on it, ``moe_ffn`` takes its mesh dispatch, and plain tensors in a
    DTensor op count as replicated (DTensor's ``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication

    token = _MESH.set(mesh)
    try:
        with implicit_replication():
            yield mesh
    finally:
        _MESH.reset(token)


def constrain(x: torch.Tensor, *entries) -> torch.Tensor:
    """Sharding constraint (``with_sharding_constraint``): outside a mesh
    ``x`` itself; inside one, ``x`` redistributed to the checked spec of
    ``entries`` ("batch" names every non-model axis). A plain tensor there
    counts as replicated."""
    mesh = current_mesh()
    if mesh is None:
        return x
    b = batch_axes(mesh)
    spec = checked_spec(tuple(x.shape), mesh,
                        *(b if e == "batch" else e for e in entries))
    # reduce the partial dims first, then reshard: one redistribute that
    # does both can run DTensor's reshard of a dim before the reduction of
    # another
    return to_placements(reduce_partials(x), mesh, placements(spec, mesh))


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
