"""The port's GSPMD training rules (``repro_torch.models.sharding``) and its
dry-run stand-ins (``repro_torch.launch.specs``) against the JAX package's,
on JAX's production meshes as ``AbstractMesh``es (no devices, no process
group): every param, opt-state, batch and cache spec, with JAX's stacked
``[L, ...]`` entries dropped from the port's per-layer leaves, and the
bytes one device holds of the step's arguments."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

try:
    from jax.sharding import AbstractMesh, AxisType, PartitionSpec as P
except ImportError:  # pre-0.4.35 jax: no AbstractMesh axis types
    pytest.skip("jax.sharding.AxisType unavailable in this jax version",
                allow_module_level=True)

import jax  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.launch import specs as j_specs  # noqa: E402
from repro.models import sharding as j_sharding  # noqa: E402
from repro.training.optimizer import OptimizerConfig as JOC  # noqa: E402
from repro.training.optimizer import adamw_init as j_adamw_init  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.launch import specs as t_specs  # noqa: E402
from repro_torch.models import sharding as t_sharding  # noqa: E402
from repro_torch.training import OptimizerConfig  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

MESHES = {
    "single": AbstractMesh((16, 16), ("data", "model"),
                           axis_types=(AxisType.Auto,) * 2),
    "multi": AbstractMesh((2, 16, 16), ("pod", "data", "model"),
                          axis_types=(AxisType.Auto,) * 3),
}
#: every architecture as configured (deepseek-v2 and kimi-k2 with their
#: own fsdp=True), plus a dense config with fsdp=True
CASES = [(a, False) for a in j_configs.all_arch_ids()] + [
    ("stablelm-1.6b", True)]
#: the port's per-layer stacks: JAX stacks each one's leaves [L, ...]
STACKS = ("layers", "head_layers", "groups", "tail")
BATCH, SEQ = 256, 4096            # train_4k
CACHE_BATCH, CACHE_SEQ = 128, 64  # a decode cache (its seq cut: shapes only)


def _norm(spec):
    """A spec as a tuple, one-axis tuple entries as the axis name."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _jax_key(path):
    """The JAX tree path of a port leaf path, and how many leading
    (stacked) entries JAX's spec has that the port's lacks."""
    parts = path.split("/")
    if parts[0] in STACKS:
        return "/".join([parts[0]] + parts[2:]), 1
    if parts[0] == "mu" and len(parts) > 1 and parts[1] in STACKS:
        return "/".join(parts[:2] + parts[3:]), 1
    return path, 0


def _flat(tree):
    is_spec = lambda x: isinstance(x, P)  # noqa: E731
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=is_spec)[0]:
        out["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)] = leaf
    return out


class _Arch:
    """One config's stand-ins in both packages (JAX's ``eval_shape``
    structs, the port's fake tensors)."""

    def __init__(self, arch, fsdp):
        over = {"fsdp": True} if fsdp else {}
        self.jcfg = j_configs.get_config(arch).with_overrides(**over)
        self.tcfg = t_configs.get_config(arch).with_overrides(**over)
        self.fake = FakeTensorMode()
        self.j_params = j_specs.param_structs(self.jcfg)
        self.t_params = t_specs.param_structs(self.tcfg, self.fake)
        self.j_batch = j_specs.batch_structs(self.jcfg, BATCH, SEQ,
                                             train=True)
        self.t_batch = t_specs.batch_structs(self.tcfg, BATCH, SEQ,
                                             train=True, fake=self.fake)
        self.j_opt, self.t_opt = {}, {}

    def opt(self, int8):
        if int8 not in self.t_opt:
            # JAX's opt_structs, on the param structs built once
            self.j_opt[int8] = jax.eval_shape(functools.partial(
                j_adamw_init, oc=JOC(int8_state=int8)), self.j_params)
            self.t_opt[int8] = t_specs.opt_structs(
                self.tcfg, OptimizerConfig(int8_state=int8), self.fake,
                self.t_params)
        return self.j_opt[int8], self.t_opt[int8]


_ARCHS = {}


def _arch(arch, fsdp):
    if (arch, fsdp) not in _ARCHS:
        _ARCHS[(arch, fsdp)] = _Arch(arch, fsdp)
    return _ARCHS[(arch, fsdp)]


def _jax_param_specs(a, mesh):
    with jax.sharding.use_abstract_mesh(mesh):
        return j_sharding.param_specs(a.jcfg, a.j_params)


def _assert_specs_match(port_specs, jax_specs, what):
    want = _flat(jax_specs)
    n = 0
    for path, spec in leaves_with_path(port_specs):
        key, drop = _jax_key(path)
        assert key in want, f"{what}: {path} has no JAX leaf {key}"
        assert _norm(spec) == _norm(tuple(want[key]))[drop:], \
            f"{what} {path}: port {spec}, JAX {want[key]}"
        n += 1
    assert n >= len(want)


def _spec_of(tree_specs, path):
    from repro_torch.tree import get_path

    return get_path(tree_specs, path)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch,fsdp", CASES)
def test_param_specs_match_jax(arch, fsdp, mesh_name):
    a, mesh = _arch(arch, fsdp), MESHES[mesh_name]
    _assert_specs_match(t_specs.param_shardings(a.tcfg, mesh, a.t_params),
                        _jax_param_specs(a, mesh), "param")


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch,fsdp", CASES)
def test_opt_specs_match_jax(arch, fsdp, mesh_name, int8):
    """Moments inherit their param's spec, scales and step replicate: JAX's
    ``opt_shardings`` rule on its own structs."""
    a, mesh = _arch(arch, fsdp), MESHES[mesh_name]
    j_opt, t_opt = a.opt(int8)
    with jax.sharding.use_abstract_mesh(mesh):
        p_flat = _flat(j_sharding.param_specs(a.jcfg, a.j_params))

    def j_rule(path, leaf):          # JAX's opt_shardings rule, spec only
        parts = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        if parts[-1] in ("m", "v", "q") and parts[0] == "mu":
            key = "/".join(p for p in parts[1:] if p not in ("m", "v", "q"))
            spec = p_flat.get(key)
            if spec is not None and len(spec) == leaf.ndim:
                return spec
        return P(*([None] * leaf.ndim))

    j_specs_tree = jax.tree_util.tree_map_with_path(j_rule, j_opt)
    p_specs = t_specs.param_shardings(a.tcfg, mesh, a.t_params)
    _assert_specs_match(t_specs.opt_shardings(a.tcfg, mesh, t_opt, p_specs),
                        j_specs_tree, "opt")


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch,fsdp", CASES)
def test_data_and_cache_specs_match_jax(arch, fsdp, mesh_name):
    a, mesh = _arch(arch, fsdp), MESHES[mesh_name]
    for name, leaf in a.t_batch.items():
        assert _norm(t_sharding.data_spec(tuple(leaf.shape), mesh)) == \
            _norm(tuple(j_sharding.data_spec(a.j_batch[name].shape, mesh)))
    j_cache = j_specs.cache_structs(a.jcfg, CACHE_BATCH, CACHE_SEQ)
    t_cache = t_specs.cache_structs(a.tcfg, CACHE_BATCH, CACHE_SEQ, a.fake)
    j_flat = _flat(jax.tree.map(lambda l: j_sharding.cache_spec(l.shape,
                                                                mesh),
                                j_cache))
    j_leaves = {k: v for k, v in _flat(j_cache).items()}
    n = 0
    for path, spec in leaves_with_path(t_specs.cache_shardings(mesh,
                                                               t_cache)):
        key, drop = _jax_key(path)
        assert drop == 1, path
        assert _norm(spec) == _norm(tuple(j_flat[key]))[1:], \
            f"cache {path}: port {spec}, JAX {j_flat[key]} " \
            f"({j_leaves[key].shape})"
        n += 1
    assert n > 0


def _spec_bytes(shape, itemsize, spec, mesh):
    """Bytes one device holds of a port leaf laid out by ``spec``."""
    axes = t_sharding.mesh_axes(mesh)
    n = itemsize
    for i, d in enumerate(shape):
        e = spec[i] if i < len(spec) else None
        for ax in ((e,) if isinstance(e, str) else (e or ())):
            d //= axes[ax]
        n *= d
    return n


def _jax_bytes(structs, specs, mesh):
    """Per-device bytes of JAX structs under a spec tree."""
    axes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    total = 0
    for leaf, spec in zip(jax.tree.leaves(structs),
                          jax.tree.leaves(specs,
                                          is_leaf=lambda x: isinstance(x, P))):
        n = np.dtype(leaf.dtype).itemsize
        for i, d in enumerate(leaf.shape):
            e = spec[i] if i < len(spec) else None
            for ax in ((e,) if isinstance(e, str) else (e or ())):
                d //= axes[ax]
            n *= d
        total += n
    return total


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch,fsdp", CASES)
def test_argument_bytes_match_jax(arch, fsdp, mesh_name):
    """The bytes one device holds of the train step's params, fp32
    moments and batch: the port's fake structs under the port's specs
    against JAX's structs under JAX's specs."""
    a, mesh = _arch(arch, fsdp), MESHES[mesh_name]
    j_opt, t_opt = a.opt(False)
    p_specs = t_specs.param_shardings(a.tcfg, mesh, a.t_params)
    trees = ((a.t_params, p_specs),
             (t_opt, t_specs.opt_shardings(a.tcfg, mesh, t_opt, p_specs)),
             (a.t_batch, t_specs.batch_shardings(mesh, a.t_batch)))
    port = sum(_spec_bytes(tuple(leaf.shape), leaf.element_size(),
                           _spec_of(specs, path), mesh)
               for tree, specs in trees
               for path, leaf in leaves_with_path(tree))
    jp = _jax_param_specs(a, mesh)
    flat_p = _flat(jp)

    def j_rule(path, leaf):
        parts = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        if parts[-1] in ("m", "v") and parts[0] == "mu":
            spec = flat_p.get("/".join(parts[1:-1]))
            if spec is not None and len(spec) == leaf.ndim:
                return spec
        return P(*([None] * leaf.ndim))

    jo = jax.tree_util.tree_map_with_path(j_rule, j_opt)
    jb = jax.tree.map(lambda l: j_sharding.data_spec(l.shape, mesh),
                      a.j_batch)
    want = (_jax_bytes(a.j_params, jp, mesh) + _jax_bytes(j_opt, jo, mesh)
            + _jax_bytes(a.j_batch, jb, mesh))
    assert port == want
