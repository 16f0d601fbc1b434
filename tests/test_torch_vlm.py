"""phi-3-vision in the port against the JAX package: the vision frontend
stub (``frontend_proj`` and the projected patches put in front of the
text) on the smoke config with a float32 override and weights bridged
from JAX, fed JAX-made VQI batches. Logits, int8 codes and scales
(``frontend_proj`` included), static activation scales and greedy streams."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.api.variants import VariantSpec as JSpec  # noqa: E402
from repro.core.quant import CalibrationSession as JCalib  # noqa: E402
from repro.core.quant import QuantConfig as JQC  # noqa: E402
from repro.data import VQITask, vqi_batch  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.serving.engine import InferenceSession as JSession  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.api.variants import VariantSpec as TSpec  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.core.quant import CalibrationSession as TCalib  # noqa: E402
from repro_torch.core.quant import QuantConfig as TQC  # noqa: E402
from repro_torch.models import forward as t_forward  # noqa: E402
from repro_torch.models import init_params, prefill  # noqa: E402
from repro_torch.models.config import check_supported  # noqa: E402
from repro_torch.serving import ContinuousBatchingEngine  # noqa: E402
from repro_torch.serving import InferenceSession  # noqa: E402

ARCH = "phi-3-vision-4.2b"
SPECS = {"fp32": (JSpec.fp32, TSpec.fp32),
         "dynamic_int8": (JSpec.dynamic_int8, TSpec.dynamic_int8),
         "static_int8": (lambda: JSpec.static_int8(calib_batches=2),
                         lambda: TSpec.static_int8(calib_batches=2))}


def _to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()
            if k in ("tokens", "frontend_embeds")}


class _Vlm:
    """JAX params and VQI batches, and the same bridged into the port."""

    def __init__(self):
        self.jcfg = j_configs.smoke_config(ARCH).with_overrides(
            dtype="float32")
        self.tcfg = t_configs.smoke_config(ARCH).with_overrides(
            dtype="float32")
        self.jp = j_init(jax.random.PRNGKey(0), self.jcfg)
        self.tp = params_from_jax(jax.tree.map(np.asarray, self.jp),
                                  self.tcfg, "cpu")
        task = VQITask()
        self.jbatches = [
            {k: v for k, v in vqi_batch(jax.random.PRNGKey(10 + i),
                                        self.jcfg, task, 4).items()
             if k in ("tokens", "frontend_embeds")}
            for i in range(3)]
        self.tbatches = [_to_torch(b) for b in self.jbatches]
        self._built = {}

    def variant(self, name):
        if name not in self._built:
            jspec, tspec = (f() for f in SPECS[name])
            jq, _ = jspec.build(self.jp, self.jcfg,
                                calib_data=self.jbatches[:2])
            tq, _ = tspec.build(self.tp, self.tcfg,
                                calib_data=self.tbatches[:2])
            self._built[name] = (jq, tq)
        return self._built[name]


@pytest.fixture(scope="module")
def vlm():
    return _Vlm()


def test_config_and_bridge_carry_the_frontend(vlm):
    cfg = vlm.tcfg
    check_supported(cfg)
    assert cfg.arch_type == "vlm" and cfg.frontend == "vision"
    np.testing.assert_array_equal(vlm.tp["frontend_proj"].numpy(),
                                  np.asarray(vlm.jp["frontend_proj"]))
    p = init_params(cfg, seed=2, device="cpu")
    assert tuple(p["frontend_proj"].shape) == (cfg.frontend_dim, cfg.d_model)
    full = t_configs.get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.d_ff,
            full.vocab_size, full.frontend_dim, full.n_frontend_tokens) == (
        32, 3072, 32, 8192, 32064, 1024, 576)
    for bad, err in ((cfg.with_overrides(frontend="audio"), ValueError),
                     (cfg.with_overrides(frontend_dim=0), ValueError)):
        with pytest.raises(err):
            check_supported(bad)
    # frontend requests are served by the engine (item 9's last slice)
    engine = ContinuousBatchingEngine(vlm.tp, cfg, n_slots=1, max_len=32,
                                      device="cpu")
    req = engine.submit(vlm.tbatches[0]["tokens"][:1, :2], 3,
                        frontend_embeds=vlm.tbatches[0]["frontend_embeds"][:1])
    engine.run()
    assert req.done and len(req.out_tokens) == 3


def test_forward_logits_with_frontend_match_jax(vlm):
    for jb, tb in zip(vlm.jbatches, vlm.tbatches):
        jl, _ = j_forward(vlm.jp, jb, vlm.jcfg)
        tl, _ = t_forward(vlm.tp, tb, vlm.tcfg)
        assert tl.shape == (4, vlm.tcfg.n_frontend_tokens + 3,
                            vlm.tcfg.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                                   rtol=0)


@pytest.mark.parametrize("variant", ["dynamic_int8", "static_int8"])
def test_int8_codes_and_scales_bit_identical(vlm, variant):
    jq, tq = vlm.variant(variant)
    leaf_t, leaf_j = tq["frontend_proj"], jq["frontend_proj"]
    assert set(leaf_t) == set(leaf_j)
    assert (variant == "static_int8") == ("act_scale" in leaf_t)
    for key in ("w_int8", "scale"):
        np.testing.assert_array_equal(leaf_t[key].numpy(),
                                      np.asarray(leaf_j[key]))
        np.testing.assert_array_equal(tq["unembed"][key].numpy(),
                                      np.asarray(jq["unembed"][key]))
        for i in range(vlm.tcfg.n_layers):
            for blk, w in (("attn", "wq"), ("attn", "wo"), ("mlp", "wi"),
                           ("mlp", "wo")):
                np.testing.assert_array_equal(
                    tq["layers"][i][blk][w][key].numpy(),
                    np.asarray(jq["layers"][blk][w][key])[i],
                    err_msg=f"layers/{i}/{blk}/{w}/{key}")
    if variant == "static_int8":
        # calibrated on the same batches: activations differ only by f32
        # matmul rounding
        np.testing.assert_allclose(leaf_t["act_scale"].numpy(),
                                   np.asarray(leaf_j["act_scale"]),
                                   rtol=1e-5)


def test_calibration_observes_the_frontend(vlm):
    qc_j, qc_t = (JQC(mode="static_int8", min_size=1024),
                  TQC(mode="static_int8", min_size=1024))
    js, ts = JCalib(vlm.jp, qc_j), TCalib(vlm.tp, qc_t)
    for jb, tb in zip(vlm.jbatches[:2], vlm.tbatches[:2]):
        jax.block_until_ready(j_forward(js.instrumented_params, jb,
                                        vlm.jcfg)[0])
        t_forward(ts.instrumented_params, tb, vlm.tcfg)
    j_scales, t_scales = js.act_scales(), ts.act_scales()
    assert "frontend_proj" in t_scales
    n = vlm.tcfg.n_layers
    want = {}
    for p, v in j_scales.items():
        if p.startswith("layers/"):
            for i in range(n):
                want[p.replace("layers/", f"layers/{i}/")] = v[i]
        else:
            want[p] = v
    assert sorted(t_scales) == sorted(want)
    for p in want:
        np.testing.assert_allclose(t_scales[p], want[p], rtol=1e-5, err_msg=p)


@pytest.mark.parametrize("variant", list(SPECS))
def test_quantized_prefill_logits_match_jax(vlm, variant):
    jq, tq = vlm.variant(variant)
    jb, tb = vlm.jbatches[2], vlm.tbatches[2]
    jl, _ = j_prefill(jq, jb, vlm.jcfg, pad_to=32)
    tl, _ = prefill(tq, tb, vlm.tcfg, pad_to=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)


@pytest.mark.parametrize("variant", ["fp32", "dynamic_int8"])
def test_greedy_generate_from_vqi_prompt_matches_jax(vlm, variant):
    jq, tq = vlm.variant(variant)
    js = JSession(jq, vlm.jcfg)
    ts = InferenceSession(tq, vlm.tcfg, device="cpu")
    for jb, tb in zip(vlm.jbatches[:2], vlm.tbatches[:2]):
        # the BOS token alone, then the asset token too: the frontend's 8
        # patch tokens count in the prompt length
        for n in (1, 2):
            jp = {"tokens": jb["tokens"][:, :n],
                  "frontend_embeds": jb["frontend_embeds"]}
            tp = {"tokens": tb["tokens"][:, :n],
                  "frontend_embeds": tb["frontend_embeds"]}
            want = np.asarray(js.generate(jp, 6))
            got = ts.generate(tp, 6)
            np.testing.assert_array_equal(got.numpy(), want)
