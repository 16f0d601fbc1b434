"""The port's artifact registry and checkpoint format: twins of the JAX
package's registry tests (round trip, tampering, manifests, version order,
static calibration, the ref error), and registries crossing between the
packages in both directions (leaves equal, sha verified, session logits
within 1e-4), plus a bf16 round trip."""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.api import ArtifactRegistry as JRegistry  # noqa: E402
from repro.api import ModelArtifact as JArtifact  # noqa: E402
from repro.api import VariantSpec as JSpec  # noqa: E402
from repro.data import VQITask, vqi_batch  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.serving.engine import InferenceSession as JSession  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.api import (ArtifactRegistry, ModelArtifact,  # noqa: E402
                             QuantRecipe, VariantSpec)
from repro_torch.bridge import params_from_jax, stack_layers  # noqa: E402
from repro_torch.core.quant import QuantConfig, quantize_tree  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.training import load_checkpoint, save_checkpoint  # noqa: E402

SPECS = [VariantSpec.fp32(), VariantSpec.dynamic_int8(),
         VariantSpec.static_int8(calib_batches=2)]
J_SPECS = [JSpec.fp32(), JSpec.dynamic_int8(),
           JSpec.static_int8(calib_batches=2)]
VLM = "phi-3-vision-4.2b"


def _flat(tree, prefix=""):
    """{"a::b": leaf} over a JAX-layout tree (dicts of arrays)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}::{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


def _assert_same_leaves(port_params, jax_params):
    got, want = _flat(stack_layers(port_params)), _flat(jax_params)
    assert sorted(got) == sorted(want)
    for key, val in want.items():
        val = np.asarray(val)
        assert got[key].numpy().dtype == val.dtype, key
        np.testing.assert_array_equal(got[key].numpy(), val, err_msg=key)


@pytest.fixture
def setup(tmp_path):
    cfg = t_configs.smoke_config("stablelm-1.6b").with_overrides(
        dtype="float32")
    params = init_params(cfg, seed=0, device="cpu")
    registry = ArtifactRegistry(str(tmp_path / "registry"))
    return cfg, params, registry


def _calib(cfg, n=2):
    rng = np.random.default_rng(100)
    return [{"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (2, 16)))}
            for _ in range(n)]


def _tamper(registry, ref):
    wpath = os.path.join(registry._index[ref.key]["dir"], "weights.npz")
    with open(wpath, "r+b") as f:
        f.seek(100)
        f.write(b"XX")


# --------------------------------------------------------------------- #
# Twins of the JAX package's registry tests
# --------------------------------------------------------------------- #
def test_publish_fetch_roundtrip(setup):
    cfg, params, registry = setup
    ref = registry.publish("m", "v1", params, cfg, "fp32",
                           metrics={"accuracy": 0.9})
    params2, cfg2, manifest = registry.fetch(ref, "cpu")
    assert cfg2 == cfg
    assert manifest["meta"]["metrics"]["accuracy"] == 0.9
    assert torch.equal(params2["embed"], params["embed"])
    assert torch.equal(params2["layers"][1]["mlp"]["wi"],
                       params["layers"][1]["mlp"]["wi"])


def test_registry_detects_tampering(setup):
    cfg, params, registry = setup
    ref = registry.publish("m", "v1", params, cfg)
    _tamper(registry, ref)
    with pytest.raises(IOError, match="sha"):
        registry.fetch(ref, "cpu")


def test_quantized_artifact_roundtrip(setup):
    cfg, params, registry = setup
    qp, _ = quantize_tree(params, QuantConfig("dynamic_int8", min_size=1024))
    ref = registry.publish("m", "v1", qp, cfg, "dynamic_int8")
    assert ref.size_bytes < registry.publish("m", "v1", params, cfg,
                                             "fp32").size_bytes / 2
    qp2, _, _ = registry.fetch(ref, "cpu")
    leaf = qp2["layers"][0]["attn"]["wq"]
    assert leaf["w_int8"].dtype == torch.int8
    assert torch.equal(leaf["w_int8"], qp["layers"][0]["attn"]["wq"]["w_int8"])


def test_publish_variants_declarative(setup):
    cfg, params, registry = setup
    model = ModelArtifact.create("m", "v1", params, cfg)
    published = registry.publish_variants(model, SPECS,
                                          calib_data=_calib(cfg))
    assert set(published) == {"fp32", "dynamic_int8", "static_int8"}
    for art in published.values():
        assert art.published and art.sha256
    assert published["fp32"].size_bytes > 2 * published["static_int8"].size_bytes
    static = published["static_int8"].params
    assert "act_scale" in static["layers"][0]["attn"]["wq"]


def test_published_and_fetched_manifests_match(setup):
    cfg, params, registry = setup
    published = registry.publish_variants(
        ModelArtifact.create("m", "v1", params, cfg), [VariantSpec.fp32()])
    fetched = registry.get("m", "v1", "fp32", device="cpu")
    assert published["fp32"].manifest.keys() == fetched.manifest.keys()
    assert published["fp32"].manifest["sha256"] == fetched.manifest["sha256"]
    assert fetched.key == "m:v1:fp32" and fetched.published


def test_latest_version_is_publication_order_not_lexicographic(setup):
    cfg, params, registry = setup
    for v in [f"v{i}" for i in range(1, 11)]:       # v1 .. v10
        registry.publish_variants(ModelArtifact.create("m", v, params, cfg),
                                  [VariantSpec.fp32()])
    assert registry.versions("m")[-1] == "v10"
    assert registry.get("m", device="cpu").version == "v10"


def test_static_spec_requires_calib_data(setup):
    cfg, params, _ = setup
    with pytest.raises(ValueError, match="calib_data"):
        VariantSpec.static_int8().build(params, cfg)


def test_quant_recipe_maps_to_quant_config():
    qc = QuantRecipe(mode="dynamic_int8", granularity="per_group",
                     group_size=64, bits=4).to_quant_config()
    assert (qc.granularity, qc.group_size, qc.bits) == ("per_group", 64, 4)


def test_registry_ref_error_lists_published_variants(setup):
    cfg, params, registry = setup
    registry.publish_variants(ModelArtifact.create("m", "v1", params, cfg),
                              [VariantSpec.fp32()])
    with pytest.raises(KeyError, match="published variants: fp32"):
        registry.ref("m", "v1", "static_int8")


def test_registry_integrity_failure_through_artifact_api(setup):
    from repro_torch.api import DeviceProfile, EdgeAgent

    cfg, params, registry = setup
    published = registry.publish_variants(
        ModelArtifact.create("m", "v1", params, cfg), [VariantSpec.fp32()])
    ref = published["fp32"].ref
    _tamper(registry, ref)
    with pytest.raises(IOError, match="sha"):
        registry.fetch_artifact(ref, "cpu")
    agent = EdgeAgent("dev-0", registry, DeviceProfile(memory_bytes=10**10),
                      device="cpu")
    with pytest.raises(IOError, match="sha"):
        agent.install(ref)


def test_fetch_defaults_to_the_card(setup):
    cfg, params, registry = setup
    ref = registry.publish("m", "v1", params, cfg)
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        registry.fetch(ref)


# --------------------------------------------------------------------- #
# Across the packages
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def vqi():
    """phi-3-vision smoke in f32: JAX params, the same bridged, and JAX-made
    VQI batches (calibration and one to serve)."""
    jcfg = j_configs.smoke_config(VLM).with_overrides(dtype="float32")
    tcfg = t_configs.smoke_config(VLM).with_overrides(dtype="float32")
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    batches = [{k: v for k, v in vqi_batch(jax.random.PRNGKey(20 + i), jcfg,
                                           VQITask(), 4).items()
                if k in ("tokens", "frontend_embeds")} for i in range(3)]
    return jcfg, tcfg, jp, tp, batches


def _torch_batch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def test_port_fetches_a_jax_published_registry(tmp_path, vqi):
    jcfg, tcfg, jp, _, batches = vqi
    root = str(tmp_path / "jax-registry")
    published = JRegistry(root).publish_variants(
        JArtifact.create("vqi", "v1", jp, jcfg), J_SPECS,
        calib_data=batches[:2])
    registry = ArtifactRegistry(root)
    assert registry.versions("vqi") == ["v1"]
    assert registry.variants("vqi", "v1") == [
        "dynamic_int8", "fp32", "static_int8"]
    for variant, jart in published.items():
        art = registry.get("vqi", "v1", variant, device="cpu")
        assert art.sha256 == jart.sha256 and art.config == tcfg
        _assert_same_leaves(art.params, jart.params)
        want = JSession(jart.params, jcfg).logits(batches[2])
        got = art.session(device="cpu").logits(_torch_batch(batches[2]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0, err_msg=variant)


def test_jax_fetches_a_port_published_registry(tmp_path, vqi):
    jcfg, tcfg, _, tp, batches = vqi
    root = str(tmp_path / "port-registry")
    published = ArtifactRegistry(root).publish_variants(
        ModelArtifact.create("vqi", "v1", tp, tcfg), SPECS,
        calib_data=[_torch_batch(b) for b in batches[:2]])
    registry = JRegistry(root)
    assert registry.versions("vqi") == ["v1"]
    for variant, art in published.items():
        jart = registry.get("vqi", "v1", variant)
        assert jart.sha256 == art.sha256 and jart.config == jcfg
        _assert_same_leaves(art.params, jart.params)
    with open(os.path.join(root, "index.json")) as f:
        assert sorted(json.load(f)) == sorted(a.key for a in
                                              published.values())


def test_jax_draft_relation_survives_a_port_publish(tmp_path, vqi):
    """The port keeps index entries whole: a ``draft_of`` relation that the
    JAX package published is still there after the port publishes into the
    same registry."""
    jcfg, tcfg, jp, tp, _ = vqi
    root = str(tmp_path / "registry")
    JRegistry(root).publish_variants(
        JArtifact.create("vqi", "v1", jp, jcfg),
        [JSpec.fp32(), JSpec.dynamic_int8(draft_of="fp32")])
    ArtifactRegistry(root).publish_variants(
        ModelArtifact.create("vqi", "v2", tp, tcfg), [VariantSpec.fp32()])
    registry = JRegistry(root)
    assert registry.versions("vqi") == ["v1", "v2"]
    draft = registry.draft_for("vqi", "v1")
    assert draft is not None and draft.variant == "dynamic_int8"
    assert registry.draft_for("vqi", "v2") is None


def test_bf16_checkpoint_roundtrip(tmp_path, vqi):
    """bf16 leaves are written as JAX writes them (``|V2``) and read back
    bit for bit, quantized leaves beside them."""
    _, tcfg, _, _, _ = vqi
    cfg = tcfg.with_overrides(dtype="bfloat16")
    params = init_params(cfg, seed=4, device="cpu")
    qp, _ = quantize_tree(params, QuantConfig("dynamic_int8", min_size=1024))
    for tree, sub in ((params, "fp"), (qp, "q")):
        d = str(tmp_path / sub)
        save_checkpoint(d, tree, cfg)
        with np.load(os.path.join(d, "weights.npz")) as npz:
            assert npz["final_norm"].dtype == np.dtype("V2")
        back, cfg2, _ = load_checkpoint(d, "cpu")
        assert cfg2 == cfg
        got, want = _flat(stack_layers(back)), _flat(stack_layers(tree))
        assert sorted(got) == sorted(want)
        for key, val in want.items():
            assert got[key].dtype == val.dtype, key
            assert torch.equal(got[key], val), key
    assert back["frontend_proj"]["w_int8"].dtype == torch.int8
    assert params["embed"].dtype == torch.bfloat16
