"""The port's quantization modes against the JAX package: int4 and int8
codes, per-channel, per-tensor and per-group scales (including a
contraction axis the group does not divide), percentile clipping (also on
a leaf over 2^24 elements, where ``torch.quantile`` refuses) and the
asymmetric zero point, bit for bit from the same inputs; dequantization,
artifact sizes, and the logits of the new variants (weight-only linears and
quantized embeddings) on bridged weights."""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.api.variants import VariantSpec as JSpec  # noqa: E402
from repro.core.quant import QuantConfig as JQC  # noqa: E402
from repro.core.quant import quantize_tree as j_quantize_tree  # noqa: E402
from repro.core.quant.quantize import dequantize_tensor as j_dequant  # noqa: E402
from repro.core.quant.quantize import quant_values as j_values  # noqa: E402
from repro.core.quant.quantize import quantize_tensor as j_quant  # noqa: E402
from repro.core.quant.quantize import quantized_size_bytes as j_qsize  # noqa: E402
from repro.core.quant.quantize import tree_size_bytes as j_size  # noqa: E402
from repro.models import decode_step as j_decode  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.api.variants import VariantSpec as TSpec  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.core.quant import QuantConfig as TQC  # noqa: E402
from repro_torch.core.quant import quantize_tree as t_quantize_tree  # noqa: E402
from repro_torch.core.quant.quantize import dequantize_tensor as t_dequant  # noqa: E402
from repro_torch.core.quant.quantize import percentile  # noqa: E402
from repro_torch.core.quant.quantize import quant_values as t_values  # noqa: E402
from repro_torch.core.quant.quantize import quantize_tensor as t_quant  # noqa: E402
from repro_torch.core.quant.quantize import quantized_size_bytes as t_qsize  # noqa: E402
from repro_torch.core.quant.quantize import tree_size_bytes as t_size  # noqa: E402
from repro_torch.models import decode_step as t_decode  # noqa: E402
from repro_torch.models import forward as t_forward  # noqa: E402
from repro_torch.models import prefill as t_prefill  # noqa: E402
from repro_torch.models.layers import place_params  # noqa: E402


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint8).reshape(-1)


def _same_leaf(jq, tq, where=""):
    """Same keys, shapes, dtypes and bytes (codes, scales, zero)."""
    assert set(jq) == set(tq), (where, set(jq), set(tq))
    for key in jq:
        j, t = np.asarray(jq[key]), tq[key].numpy()
        assert j.shape == t.shape and j.dtype == t.dtype, (where, key)
        assert np.array_equal(_bits(j), _bits(t)), (where, key)


def _inputs(shape, dtype, seed=0):
    """A weight-like leaf with one outlier per column block, as f32 numpy,
    and the same values in JAX and torch at ``dtype``."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    x.reshape(-1, shape[-1])[3, ::7] = 1.5          # outliers to clip
    xj = jnp.asarray(x).astype(dtype)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    return xj, xt


# K = 256 (groups of 64 and 128 divide it), 200 (128 does not: per-channel
# fall-back; 64 does not either), a stacked [L, K, N] leaf
SHAPES = ((256, 96), (200, 64), (2, 128, 48))
MODES = [dict(bits=b, per_channel=pc, group_size=g)
         for b, pc, g in itertools.product((8, 4), (True, False),
                                           (0, 64, 128))]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize(
    "mode", MODES,
    ids=lambda m: "b{bits}-pc{per_channel:d}-g{group_size}".format(**m))
def test_quantize_tensor_bit_identical(shape, dtype, mode):
    xj, xt = _inputs(shape, dtype)
    for clip in (0.0, 99.9, 97.3):
        kw = dict(mode, clip_percentile=clip)
        jq, tq = j_quant(xj, **kw), t_quant(xt, **kw)
        _same_leaf(jq, tq, kw)
        key = "w_int4" if mode["bits"] == 4 else "w_int8"
        assert key in tq and t_values(tq) is tq[key]
        assert np.array_equal(np.asarray(j_values(jq)), t_values(tq).numpy())
        if mode["bits"] == 4:
            assert int(tq[key].abs().max()) <= 7
        grouped = tq["scale"].dim() == tq[key].dim() + 1
        k = shape[-2]
        g = min(mode["group_size"], k)
        assert grouped == bool(g and k % g == 0)
        if grouped:
            assert tq["scale"].shape[-3:] == (k // g, 1, shape[-1])
        np.testing.assert_array_equal(t_dequant(tq).numpy(),
                                      np.asarray(j_dequant(jq)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("per_channel", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_asymmetric_zero_point_bit_identical(shape, per_channel, dtype):
    xj, xt = _inputs(shape, dtype, seed=3)
    xj, xt = xj + 0.02, xt + 0.02              # skewed: zero point != 0
    kw = dict(per_channel=per_channel, symmetric=False)
    jq, tq = j_quant(xj, **kw), t_quant(xt, **kw)
    _same_leaf(jq, tq, kw)
    assert "zero" in tq and tq["w_int8"].dtype == torch.int8
    np.testing.assert_array_equal(t_dequant(tq, torch.float32).numpy(),
                                  np.asarray(j_dequant(jq, jnp.float32)))
    np.testing.assert_array_equal(
        t_dequant(tq, torch.bfloat16).float().numpy(),
        np.asarray(j_dequant(jq, jnp.bfloat16).astype(jnp.float32)))


@pytest.mark.parametrize("n, pct, dims", [
    (1, 99.9, (0,)), (2, 97.3, (0,)), (5, 12.345, (0,)), (3, 50.0, (0, 1)),
    (1, 99.9, (0, 1)), (4, 99.99, (1,))])
def test_percentile_matches_jnp_bits(n, pct, dims):
    """The interpolation's f32 arithmetic as XLA compiles it: the folded
    ``pct * (f32(1/100) * (n - 1))`` and one fused multiply-add, on the low
    term for several outputs and on the high term for one."""
    rng = np.random.default_rng(n)
    for rows in (7, 130, 1000):
        a = np.abs(rng.standard_normal((rows, n))).astype(np.float32)
        if dims == (1,):
            a = a.T.copy()
        want = np.asarray(jnp.percentile(jnp.asarray(a), pct, axis=dims,
                                         keepdims=True))
        got = percentile(torch.from_numpy(a), pct, dims).numpy()
        assert got.shape == want.shape
        assert np.array_equal(_bits(got), _bits(want)), (rows, n, pct, dims)


@pytest.mark.parametrize("per_channel, bits", [(True, 8), (False, 4)])
def test_percentile_on_a_leaf_over_2_24_elements(per_channel, bits):
    """``torch.quantile`` refuses inputs over 2^24 elements; the sort +
    gather percentile takes a 16.8 M-element leaf and gives JAX's bits."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((4100, 4096)) * 0.02).astype(np.float32)
    assert x.size > 2 ** 24
    with pytest.raises(RuntimeError):
        torch.quantile(torch.from_numpy(x).abs(), 0.999)
    kw = dict(per_channel=per_channel, bits=bits, clip_percentile=99.9)
    jq = j_quant(jnp.asarray(x), **kw)
    tq = t_quant(torch.from_numpy(x), **kw)
    _same_leaf(jq, tq, kw)


def _tiny_tree(rng, k, n, layers=3):
    """A JAX-layout tree with stacked [L, K, N] leaves and a top-level one."""
    return {"unembed": rng.standard_normal((k, n)).astype(np.float32),
            "layers": {"attn": {"wq": rng.standard_normal(
                (layers, k, n)).astype(np.float32)}}}


@pytest.mark.parametrize("qc", [
    dict(bits=4, granularity="per_group", group_size=64),
    dict(bits=4, granularity="per_channel"),
    dict(granularity="per_group", group_size=128),
    dict(clip_percentile=99.9),
    dict(symmetric=False),
    dict(granularity="per_tensor")], ids=str)
def test_tree_sizes_match_jax(qc):
    """``tree_size_bytes`` / ``quantized_size_bytes`` equal JAX's, int4
    codes counted as nibbles per stacked path: a per-layer leaf of an odd
    size (65 x 63) gives the JAX [3, 65, 63] leaf's total, not three
    rounded-up halves."""
    rng = np.random.default_rng(5)
    for k, n in ((65, 63), (128, 64)):
        tree = _tiny_tree(rng, k, n)
        jq, _ = j_quantize_tree(jax.tree.map(jnp.asarray, tree),
                                JQC(min_size=256, **qc))
        tp = {"unembed": torch.from_numpy(tree["unembed"]),
              "layers": [{"attn": {"wq": torch.from_numpy(w)}}
                         for w in tree["layers"]["attn"]["wq"]]}
        tq, _ = t_quantize_tree(tp, TQC(min_size=256, **qc))
        assert t_size(tq) == j_size(jq) == t_qsize(tq) == j_qsize(jq)
        assert t_size(tp) == j_size(jax.tree.map(jnp.asarray, tree))


# --------------------------------------------------------------------- #
# Variants on the smoke model: weight-only linears, quantized embeddings
# --------------------------------------------------------------------- #
VARIANTS = {
    "int4": (lambda S: S.int4(), None),
    "int4_g32": (lambda S: S.int4(group_size=32), None),
    "int8_per_group": (lambda S: S.dynamic_int8(granularity="per_group",
                                                group_size=64), None),
    "int8_percentile": (lambda S: S.dynamic_int8(clip_percentile=99.9),
                        None),
    "int4_percentile": (lambda S: S.int4(clip_percentile=99.0), None),
    "asymmetric": (None, dict(symmetric=False, min_size=1024)),
    "asymmetric_per_tensor": (None, dict(symmetric=False, min_size=1024,
                                         granularity="per_tensor")),
}


@pytest.fixture(scope="module")
def smoke():
    arch = "mistral-nemo-12b"                 # GQA 4:2
    jcfg = j_configs.smoke_config(arch).with_overrides(dtype="float32")
    tcfg = t_configs.smoke_config(arch).with_overrides(dtype="float32")
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, tcfg, jp, tp


def _build(smoke, name):
    jcfg, tcfg, jp, tp = smoke
    spec, qc = VARIANTS[name]
    if spec is not None:
        return spec(JSpec).build(jp, jcfg)[0], spec(TSpec).build(tp, tcfg)[0]
    return (j_quantize_tree(jp, JQC(**qc))[0],
            t_quantize_tree(tp, TQC(**qc))[0])


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_logits_match_jax(smoke, name):
    """f32 logits of each new variant within atol 1e-4 of JAX's: the
    forward, a prefill and 4 greedy decode steps; every linear leaf and the
    embedding are quantized (the embedding dequantizes per gathered row),
    and the leaves are bit-identical to JAX's."""
    jcfg, tcfg, _, _ = smoke
    jq, tq = _build(smoke, name)
    assert "w_int8" in tq["embed"] or "w_int4" in tq["embed"]
    _same_leaf(jq["embed"], tq["embed"], "embed")
    _same_leaf(jax.tree.map(lambda a: a[1], jq["layers"]["mlp"]["wi"]),
               tq["layers"][1]["mlp"]["wi"], "layers/1/mlp/wi")
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 20))
    want = np.asarray(j_forward(jq, {"tokens": jnp.asarray(tokens)},
                                jcfg)[0])
    with torch.no_grad():
        got = t_forward(tq, {"tokens": torch.as_tensor(tokens)},
                        tcfg)[0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    jl, jc = j_prefill(jq, {"tokens": jnp.asarray(tokens)}, jcfg, pad_to=32)
    with torch.no_grad():
        tl, tc = t_prefill(tq, {"tokens": torch.as_tensor(tokens)}, tcfg,
                           pad_to=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    tok = np.array(jnp.argmax(jl[:, -1], axis=-1)).reshape(2, 1)
    for i in range(4):
        jl, jc = j_decode(jq, jc, jnp.asarray(tok), 20 + i, jcfg)
        with torch.no_grad():
            tl, tc = t_decode(tq, tc, torch.as_tensor(tok), 20 + i, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)
        assert np.array_equal(np.argmax(np.asarray(jl[:, -1]), -1),
                              torch.argmax(tl[:, -1], -1).numpy())
        tok = np.array(jnp.argmax(jl[:, -1], axis=-1)).reshape(2, 1)


@pytest.mark.parametrize("name", ["int4", "int8_per_group", "asymmetric"])
def test_weight_only_leaves_are_never_packed(smoke, name):
    """``place_params`` packs plain per-channel int8 linears for the card's
    GEMMs and leaves int4, grouped (rank-3 scale) and asymmetric leaves,
    and the embedding, as they are: ``linear`` dequantizes them."""
    _, tq = _build(smoke, name)
    packed = place_params(tq, "cpu", pack=True)
    assert "w_packed" not in packed["embed"]
    for leaf in (packed["unembed"], packed["layers"][0]["attn"]["wq"],
                 packed["layers"][1]["mlp"]["wi"]):
        assert "w_packed" not in leaf and ("w_int4" in leaf
                                           or "w_int8" in leaf)
    plain, _ = t_quantize_tree(smoke[3], TQC(min_size=1024))
    assert "w_packed" in place_params(plain, "cpu", pack=True)["unembed"]


def test_variant_spec_int4_and_draft_of_mirror_jax():
    for j, t in ((JSpec.int4(), TSpec.int4()),
                 (JSpec.int4(group_size=32, draft_of="fp32"),
                  TSpec.int4(group_size=32, draft_of="fp32")),
                 (JSpec.dynamic_int8(draft_of="fp32"),
                  TSpec.dynamic_int8(draft_of="fp32")),
                 (JSpec.static_int8(draft_of="fp32"),
                  TSpec.static_int8(draft_of="fp32"))):
        assert (j.variant, j.draft_of, j.calib_batches) == (
            t.variant, t.draft_of, t.calib_batches)
        jqc, tqc = j.recipe.to_quant_config(), t.recipe.to_quant_config()
        for f in ("mode", "granularity", "group_size", "bits",
                  "clip_percentile", "min_size"):
            assert getattr(jqc, f) == getattr(tqc, f), f
    assert TSpec.fp32().draft_of is None
