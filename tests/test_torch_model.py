"""The port's dense model, quantization and calibration against the JAX
package on the fp32 smoke configs: the same JAX-initialised weights,
bridged as numpy arrays, go through both; plus the port's own contracts
(no CPU fallback, import isolation)."""
import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.api.variants import VariantSpec as JSpec  # noqa: E402
from repro.core.quant import CalibrationSession as JCalib  # noqa: E402
from repro.core.quant import QuantConfig as JQC  # noqa: E402
from repro.core.quant import dequantize_tensor as j_dequantize  # noqa: E402
from repro.core.quant import quantize_tree as j_quantize_tree  # noqa: E402
from repro.models import decode_step as j_decode  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.api.variants import VariantSpec as TSpec  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.core.quant import CalibrationSession as TCalib  # noqa: E402
from repro_torch.core.quant import QuantConfig as TQC  # noqa: E402
from repro_torch.core.quant import dequantize_tensor as t_dequantize  # noqa: E402
from repro_torch.core.quant import quantize_tree as t_quantize_tree  # noqa: E402
from repro_torch.core.quant import tree_size_bytes  # noqa: E402
from repro_torch.models import decode_step as t_decode  # noqa: E402
from repro_torch.models import forward as t_forward  # noqa: E402
from repro_torch.models import init_cache, init_params  # noqa: E402
from repro_torch.models import prefill as t_prefill  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["stablelm-1.6b", "mistral-nemo-12b"]   # MHA hd 32; GQA 4:2 hd 32
SPECS = {"fp32": (JSpec.fp32, TSpec.fp32),
         "dynamic_int8": (JSpec.dynamic_int8, TSpec.dynamic_int8),
         "static_int8": (JSpec.static_int8, TSpec.static_int8)}


class _Pair:
    """One arch: JAX params and the same weights bridged into the port."""

    def __init__(self, arch):
        self.jcfg = j_configs.smoke_config(arch).with_overrides(
            dtype="float32")
        self.tcfg = t_configs.smoke_config(arch).with_overrides(
            dtype="float32")
        self.jp = j_init(jax.random.PRNGKey(0), self.jcfg)
        self.tp = params_from_jax(jax.tree.map(np.asarray, self.jp),
                                  self.tcfg, "cpu")
        rng = np.random.default_rng(1)
        self.calib = [rng.integers(0, self.jcfg.vocab_size, (2, 24))
                      for _ in range(2)]
        self._built = {}

    def variant(self, name):
        if name not in self._built:
            jspec, tspec = (f() for f in SPECS[name])
            jq, _ = jspec.build(self.jp, self.jcfg, calib_data=[
                {"tokens": jnp.asarray(c)} for c in self.calib])
            tq, _ = tspec.build(self.tp, self.tcfg, calib_data=[
                {"tokens": torch.as_tensor(c)} for c in self.calib])
            self._built[name] = (jq, tq)
        return self._built[name]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _Pair(request.param)


def _layer_leaf(tree_j, i, *path):
    node = tree_j["layers"]
    for k in path:
        node = node[k]
    return np.asarray(node)[i]


def test_bridge_unstacks_layers(pair):
    cfg = pair.tcfg
    assert len(pair.tp["layers"]) == cfg.n_layers
    for i in range(cfg.n_layers):
        for path in (("attn", "wq"), ("mlp", "wi"), ("ln1",)):
            leaf = pair.tp["layers"][i]
            for k in path:
                leaf = leaf[k]
            np.testing.assert_array_equal(leaf.numpy(),
                                          _layer_leaf(pair.jp, i, *path))
    np.testing.assert_array_equal(pair.tp["unembed"].numpy(),
                                  np.asarray(pair.jp["unembed"]))


@pytest.mark.parametrize("mode", ["dynamic_int8", "static_int8"])
def test_quantize_tree_codes_and_scales_bit_identical(pair, mode):
    act_j = act_t = None
    if mode == "static_int8":
        # the same act_scales on both sides: weight codes and the
        # act_scale = max(absmax, 1e-12) / 127 transform are under test here
        n = pair.jcfg.n_layers
        vals = {"attn/wq": 3.0, "attn/wk": 2.5, "mlp/wo": 0.75}
        act_j = {f"layers/{p}": [v * (i + 1) for i in range(n)]
                 for p, v in vals.items()}
        act_t = {f"layers/{i}/{p}": v * (i + 1)
                 for p, v in vals.items() for i in range(n)}
    jq, jpaths = j_quantize_tree(pair.jp, JQC(mode=mode, min_size=1024),
                                 act_j)
    tq, tpaths = t_quantize_tree(pair.tp, TQC(mode=mode, min_size=1024),
                                 act_t)
    n = pair.tcfg.n_layers
    assert sorted(tpaths) == sorted(
        p.replace("layers/", f"layers/{i}/") if p.startswith("layers/")
        else p for p in jpaths for i in (range(n) if p.startswith("layers/")
                                         else [0]))
    for name in ("embed", "unembed"):
        np.testing.assert_array_equal(tq[name]["w_int8"].numpy(),
                                      np.asarray(jq[name]["w_int8"]))
        np.testing.assert_array_equal(tq[name]["scale"].numpy(),
                                      np.asarray(jq[name]["scale"]))
    for i in range(n):
        for blk, w in (("attn", "wq"), ("attn", "wk"), ("attn", "wv"),
                       ("attn", "wo"), ("mlp", "wi"), ("mlp", "wo")):
            t_leaf = tq["layers"][i][blk][w]
            j_leaf = jq["layers"][blk][w]
            for key in t_leaf:
                np.testing.assert_array_equal(
                    t_leaf[key].numpy(), np.asarray(j_leaf[key])[i],
                    err_msg=f"layers/{i}/{blk}/{w}/{key}")
            assert set(t_leaf) == set(j_leaf)
        np.testing.assert_array_equal(
            t_dequantize(tq["layers"][i]["mlp"]["wi"]).numpy(),
            np.asarray(j_dequantize(jq["layers"]["mlp"]["wi"]))[i])
    assert tree_size_bytes(tq) < tree_size_bytes(pair.tp) / 3.5


def test_calibration_act_scales_match_jax(pair):
    qc_j, qc_t = (JQC(mode="static_int8", min_size=1024),
                  TQC(mode="static_int8", min_size=1024))
    js, ts = JCalib(pair.jp, qc_j), TCalib(pair.tp, qc_t)
    for c in pair.calib:
        jax.block_until_ready(j_forward(js.instrumented_params,
                                        {"tokens": jnp.asarray(c)},
                                        pair.jcfg)[0])
        t_forward(ts.instrumented_params, {"tokens": torch.as_tensor(c)},
                  pair.tcfg)
    j_scales, t_scales = js.act_scales(), ts.act_scales()
    n = pair.tcfg.n_layers
    want = {}
    for p, v in j_scales.items():
        if p.startswith("layers/"):
            for i in range(n):
                want[p.replace("layers/", f"layers/{i}/")] = v[i]
        else:
            want[p] = v
    assert sorted(t_scales) == sorted(want)
    # activations differ between the frameworks only by f32 matmul rounding
    for p in want:
        np.testing.assert_allclose(t_scales[p], want[p], rtol=1e-5, err_msg=p)


@pytest.mark.parametrize("variant", list(SPECS))
def test_prefill_decode_logits_match_jax(pair, variant):
    jq, tq = pair.variant(variant)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, pair.jcfg.vocab_size, (2, 19))
    jl, jc = j_prefill(jq, {"tokens": jnp.asarray(toks)}, pair.jcfg,
                       pad_to=32)
    tl, tc = t_prefill(tq, {"tokens": torch.as_tensor(toks)}, pair.tcfg,
                       pad_to=32)
    # f32 matmuls in another order; int8 codes can flip only where an
    # activation sits within ~1e-7 of a rounding boundary
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tc["layers"][0][0].numpy(),
                               np.asarray(jc["layers"][0][0]), atol=1e-4)
    for step in range(3):
        nxt = rng.integers(0, pair.jcfg.vocab_size, (2, 1))
        jl, jc = j_decode(jq, jc, jnp.asarray(nxt), 19 + step, pair.jcfg)
        tl, tc = t_decode(tq, tc, torch.as_tensor(nxt), 19 + step, pair.tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)


def test_forward_logits_match_jax(pair):
    toks = np.random.default_rng(3).integers(0, pair.jcfg.vocab_size, (2, 33))
    jl, _ = j_forward(pair.jp, {"tokens": jnp.asarray(toks)}, pair.jcfg)
    tl, _ = t_forward(pair.tp, {"tokens": torch.as_tensor(toks)}, pair.tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)


def test_entry_points_raise_without_cuda_and_no_device():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = t_configs.smoke_config("stablelm-1.6b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 1, 16)
    p = init_params(cfg, seed=3, device="cpu")
    assert p["embed"].dtype == torch.bfloat16 and p["embed"].device.type == "cpu"
    assert torch.equal(p["unembed"], init_params(cfg, seed=3,
                                                 device="cpu")["unembed"])


def test_unported_branches_name_the_roadmap():
    cfg = t_configs.smoke_config("mistral-nemo-12b")
    # item 9's last slice: an audio frontend and codebooks are served
    for ok in (cfg.with_overrides(frontend="audio", frontend_dim=8),
               cfg.with_overrides(n_codebooks=2),
               cfg.with_overrides(arch_type="audio")):
        init_params(ok, seed=1, device="cpu")
    with pytest.raises(ValueError, match="frontend_dim"):
        init_params(cfg.with_overrides(frontend="audio"), device="cpu")
    # a window, tied embeddings and a sliding window are served now; a
    # sliding window of 0 and an SSM stack without a state are refused
    for ok in (cfg.with_overrides(window=8),
               cfg.with_overrides(tie_embeddings=True),
               cfg.with_overrides(attention="sliding", window=8)):
        init_params(ok, seed=1, device="cpu")
    for bad in (cfg.with_overrides(attention="sliding"),
                cfg.with_overrides(arch_type="ssm")):
        with pytest.raises(ValueError):
            init_params(bad, device="cpu")
    with pytest.raises(NotImplementedError, match="layer_pattern"):
        init_params(cfg.with_overrides(layer_pattern=("rec", "attn")),
                    device="cpu")
    # every KV tier is served: fp, int8 and int4
    for tier in ("fp", "int8", "int4"):
        init_params(cfg.with_overrides(kv_cache_precision=tier), seed=1,
                    device="cpu")
    assert t_configs.get_config("musicgen-large").n_codebooks == 4


def _imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(REPO, "src", "repro_torch")):
        files += [os.path.join(d, n) for n in sorted(names)
                  if n.endswith(".py")]
    assert len(files) > 20
    bad = [(os.path.relpath(f, REPO), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
