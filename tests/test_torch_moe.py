"""The port's capacity-routed MoE (deepseek-v2 with MLA, kimi-k2 with GQA)
against the JAX package on the fp32 smoke configs: ``moe_ffn`` against
``_moe_ffn_gspmd`` (outputs, top-k choices, the kept mask, aux values, a
case that drops tokens), the int8 artifacts' codes and scales bit for bit
(the 3-D expert leaves included), forward / prefill / decode logits and
aux, greedy streams through ``generate``, the dense and paged engines (a
pool small enough to preempt) and the spec engine with an MoE target; the
configs field for field, ``param_count`` and the paged pools of the
published configs."""
import dataclasses

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
from repro.core.quant import quantize_tree as j_quantize_tree  # noqa: E402
from repro.core.quant import quantized_size_bytes as j_size  # noqa: E402
from repro.models import decode_step as j_decode  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro.models.layers import linear as j_linear  # noqa: E402
from repro.models.moe import _moe_ffn_gspmd  # noqa: E402
from repro.models.moe import capacity as j_capacity  # noqa: E402
from repro.models.moe import init_moe_params as j_init_moe  # noqa: E402
from repro.serving import kvcache as j_kv  # noqa: E402
from repro.serving.engine import InferenceSession as JSession  # noqa: E402
from repro.serving.scheduler import \
    ContinuousBatchingEngine as JEngine  # noqa: E402
from repro.serving.spec_decode import SpecConfig as JSpecConfig  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.api import SpecConfig  # noqa: E402
from repro_torch.api.variants import VariantSpec as TSpec  # noqa: E402
from repro_torch.bridge import params_from_jax, to_torch  # noqa: E402
from repro_torch.core.quant import CalibrationSession as TCalib  # noqa: E402
from repro_torch.core.quant import QuantConfig as TQC  # noqa: E402
from repro_torch.core.quant import quantize_tree as t_quantize_tree  # noqa: E402
from repro_torch.core.quant import quantized_size_bytes as t_size  # noqa: E402
from repro_torch.models import decode_step as t_decode  # noqa: E402
from repro_torch.models import forward as t_forward  # noqa: E402
from repro_torch.models import init_params as t_init  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import prefill as t_prefill  # noqa: E402
from repro_torch.models.config import check_supported  # noqa: E402
from repro_torch.serving import (ContinuousBatchingEngine,  # noqa: E402
                                 InferenceSession)
from repro_torch.serving import kvcache as t_kv  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

ARCHS = ["deepseek-v2-236b", "kimi-k2-1t-a32b"]
ATOL = 1e-4
COUNTING = ("completed", "submitted", "decode_steps", "generated_tokens",
            "prefill_tokens", "preempted", "prefix_hit_tokens",
            "prompt_tokens_computed", "kv_blocks_peak", "kv_hbm_bytes_per_req")
# the experts are outside every activation-observing ``linear``: the JAX
# calibration cannot instrument them, so both sides calibrate without them
EXPERTS_OUT = r"(rec/(wa|wi)|lam|conv_w|router|A_log|dt_bias|moe/(wi|wo))"


class _Pair:
    """One MoE arch in f32: JAX params and the same weights bridged, and
    its int8 variants built on each side."""

    def __init__(self, arch):
        self.arch = arch
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
        self._variants = {"fp32": (self.jp, self.tp)}

    def act_scales(self):
        """Both packages' calibrated activation scales (experts left out);
        JAX's per-layer lists spelled as the port's per-layer paths."""
        qj = JQC(mode="static_int8", min_size=1024, exclude=EXPERTS_OUT)
        qt = TQC(mode="static_int8", min_size=1024, exclude=EXPERTS_OUT)
        js, ts = JCalib(self.jp, qj), TCalib(self.tp, qt)
        for c in self.calib:
            jax.block_until_ready(j_forward(
                js.instrumented_params, {"tokens": jnp.asarray(c)},
                self.jcfg)[0])
            t_forward(ts.instrumented_params, {"tokens": torch.as_tensor(c)},
                      self.tcfg)
        # a one-layer stack (head_layers) comes back as a float: as a
        # one-element list it quantizes to an [L] act_scale, as the scan
        # over the stack needs
        j_scales, want = {}, {}
        for p, v in js.act_scales().items():
            root = p.split("/")[0]
            if root in ("layers", "head_layers"):
                j_scales[p] = v if isinstance(v, list) else [v]
                for i, vi in enumerate(j_scales[p]):
                    want[_port_path(p, i)] = vi
            else:
                j_scales[p] = want[p] = v
        return j_scales, want, ts.act_scales()

    def variant(self, name):
        if name not in self._variants:
            if name == "static_int8":
                j_scales, want, _ = self.act_scales()
                jq, _ = j_quantize_tree(
                    self.jp, JQC(mode="static_int8", min_size=1024), j_scales)
                tq, _ = t_quantize_tree(
                    self.tp, TQC(mode="static_int8", min_size=1024), want)
            else:
                jq, _ = JSpec.dynamic_int8().build(self.jp, self.jcfg)
                tq, _ = TSpec.dynamic_int8().build(self.tp, self.tcfg)
            self._variants[name] = (jq, tq)
        return self._variants[name]


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _Pair(request.param)


def _port_path(jpath: str, i: int) -> str:
    root = jpath.split("/")[0]
    return jpath.replace(f"{root}/", f"{root}/{i}/", 1)


# --------------------------------------------------------------------- #
# configs
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_copy_jax_and_param_count(arch):
    for get in ("get_config", "smoke_config"):
        j = getattr(j_configs, get)(arch)
        t = getattr(t_configs, get)(arch)
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        check_supported(t)
        for active in (False, True):
            assert t.param_count(active_only=active) == \
                j.param_count(active_only=active)
        assert t.layer_types() == j.layer_types()
        assert [t.is_moe_layer(i) for i in range(t.n_layers)] == \
            [j.is_moe_layer(i) for i in range(j.n_layers)]
    cfg = t_configs.get_config(arch)
    assert cfg.arch_type == "moe" and cfg.fsdp
    # the depth-cut runs of chip_smoke.py: 13.30 B (deepseek-v2, 4 layers)
    # and 19.97 B (kimi-k2, 2 layers) parameters
    cut = {"deepseek-v2-236b": 4, "kimi-k2-1t-a32b": 2}[arch]
    n = cfg.with_overrides(n_layers=cut).param_count()
    assert round(n / 1e9, 2) == {"deepseek-v2-236b": 13.30,
                                 "kimi-k2-1t-a32b": 19.97}[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_jax(arch):
    for cf in (0.25, 1.0, 1.25, 8.0):
        jcfg = j_configs.get_config(arch).with_overrides(capacity_factor=cf)
        tcfg = t_configs.get_config(arch).with_overrides(capacity_factor=cf)
        for n in list(range(0, 80)) + [255, 256, 1024, 4096, 100_000]:
            assert t_moe.capacity(n, tcfg) == j_capacity(n, jcfg), (cf, n)
    # an 8-slot decode step: every expert computed at C = 8
    assert t_moe.capacity(8, t_configs.get_config(arch)) == 8


# --------------------------------------------------------------------- #
# moe_ffn against _moe_ffn_gspmd
# --------------------------------------------------------------------- #
def _jax_plan(p, x, cfg):
    """JAX's top-k choices and kept mask, the way ``_moe_ffn_gspmd`` forms
    them (in numpy from its own routing)."""
    xt = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(j_linear(p["router"], xt.astype(jnp.float32)), -1)
    _, idx = jax.lax.top_k(probs, cfg.top_k)
    idx = np.asarray(idx)
    flat_e = idx.reshape(-1)
    order = np.argsort(flat_e, kind="stable")
    se = flat_e[order]
    counts = np.bincount(se, minlength=cfg.n_experts)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    keep = (np.arange(flat_e.size) - offsets[se]) < j_capacity(len(idx), cfg)
    return idx, keep


MOE_CASES = {"prefill": (2, 11, 1.25), "drops": (2, 64, 0.25),
             "decode1": (1, 1, 1.25), "decode8": (8, 1, 1.25)}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_jax(arch, case):
    b, s, cf = MOE_CASES[case]
    jcfg = j_configs.smoke_config(arch).with_overrides(
        dtype="float32", capacity_factor=cf)
    tcfg = t_configs.smoke_config(arch).with_overrides(
        dtype="float32", capacity_factor=cf)
    jp = j_init_moe(jax.random.PRNGKey(3), jcfg)
    tp = jax.tree.map(lambda a: to_torch(np.asarray(a), "cpu"), jp)
    x = np.random.default_rng(b * 100 + s).standard_normal(
        (b, s, jcfg.d_model)).astype(np.float32)
    jo, ja = _moe_ffn_gspmd(jp, jnp.asarray(x), jcfg)
    to, ta = t_moe.moe_ffn(tp, torch.as_tensor(x), tcfg)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    for key in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(float(ta[key]), float(ja[key]), atol=1e-6,
                                   rtol=0, err_msg=key)
    assert float(ta["fraction_dropped"]) == float(ja["fraction_dropped"])
    if case == "drops":     # tests/test_moe.py's capacity cut
        assert float(ta["fraction_dropped"]) > 0
    j_idx, j_keep = _jax_plan(jp, jnp.asarray(x), jcfg)
    _, _, _, t_idx = t_moe.route(tp, torch.as_tensor(x).reshape(b * s, -1),
                                 tcfg)
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)
    _, t_keep, _, cap = t_moe.dispatch_plan(t_idx, tcfg)
    np.testing.assert_array_equal(t_keep.numpy(), j_keep)
    assert cap == j_capacity(b * s, jcfg)


def test_top_k_ties_go_to_the_lower_expert():
    """Equal probabilities (a zero router) give experts 0..k-1 in order, as
    ``jax.lax.top_k`` does; NaN rows (an idle engine slot's 0/0) rank NaN
    first, in index order, on both sides."""
    cfg = t_configs.smoke_config("kimi-k2-1t-a32b").with_overrides(
        dtype="float32")
    p = {"router": torch.zeros((cfg.d_model, cfg.n_experts))}
    x = torch.randn(5, cfg.d_model)
    x[3] = float("nan")
    _, _, gate, idx = t_moe.route(p, x, cfg)
    _, j_idx = jax.lax.top_k(jax.nn.softmax(jnp.asarray(
        (x @ p["router"]).numpy()), -1), cfg.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    assert idx[0].tolist() == list(range(cfg.top_k))
    assert torch.isnan(gate[3]).all()


def test_quantized_experts_dequantize_in_chunks(monkeypatch):
    """int8 expert leaves: the chunked dequantization gives the unchunked
    output bit for bit, and both hold to JAX's."""
    arch = "deepseek-v2-236b"
    jcfg = j_configs.smoke_config(arch).with_overrides(dtype="float32")
    tcfg = t_configs.smoke_config(arch).with_overrides(dtype="float32")
    jp = j_init_moe(jax.random.PRNGKey(4), jcfg)
    tp = jax.tree.map(lambda a: to_torch(np.asarray(a), "cpu"), jp)
    jq, _ = j_quantize_tree(jp, JQC(min_size=1024))
    tq, paths = t_quantize_tree(tp, TQC(min_size=1024))
    assert {"wi", "wo"} <= set(paths) and "router" not in paths
    # quantized a chunk of experts at a time: the same codes and scales
    from repro_torch.core.quant import quantize as t_quantize

    for gran in ("per_channel", "per_tensor", "per_group"):
        qc = TQC(min_size=1024, granularity=gran, group_size=32)
        whole, _ = t_quantize_tree(tp, qc)
        monkeypatch.setattr(t_quantize, "CHUNK_BYTES",
                            tp["wi"][0].numel() * 4)           # 1 expert
        chunked, _ = t_quantize_tree(tp, qc)
        monkeypatch.undo()
        for leaf in ("wi", "wo"):
            for key in whole[leaf]:
                assert torch.equal(whole[leaf][key], chunked[leaf][key])
    assert tq["wi"]["w_int8"].shape == (4, 128, 128)
    x = torch.randn(2, 9, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    whole, _ = t_moe.moe_ffn(tq, x, tcfg)
    monkeypatch.setattr(t_moe, "DEQUANT_CHUNK_BYTES",
                        tq["wi"]["w_int8"][0].numel() * 4)      # 1 expert
    chunked, _ = t_moe.moe_ffn(tq, x, tcfg)
    assert torch.equal(whole, chunked)
    jo, _ = _moe_ffn_gspmd(jq, jnp.asarray(x.numpy()), jcfg)
    np.testing.assert_allclose(whole.numpy(), np.asarray(jo), atol=ATOL,
                               rtol=0)


# --------------------------------------------------------------------- #
# int8 artifacts
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mode", ["dynamic_int8", "static_int8"])
def test_quantize_tree_codes_and_scales_bit_identical(pair, mode):
    """Every leaf of both stacks, the 3-D expert leaves ``moe/wi [E, d,
    2ff]`` and ``moe/wo [E, ff, d]`` (per channel over axis ndim - 2)
    included; ``router`` and ``w_kr`` stay fp."""
    if mode == "static_int8":
        jq, tq = pair.variant(mode)
    else:
        jq, jpaths = j_quantize_tree(pair.jp, JQC(min_size=1024))
        tq, tpaths = t_quantize_tree(pair.tp, TQC(min_size=1024))
        stacked = ("layers", "head_layers")
        assert sorted(tpaths) == sorted(
            [p for p in jpaths if p.split("/")[0] not in stacked]
            + [_port_path(p, i) for p in jpaths
               if p.split("/")[0] in stacked
               for i in range(len(pair.tp[p.split("/")[0]]))])
    jflat = dict(leaves_with_path(jax.tree.map(np.asarray, jq)))
    seen = set()
    for path, leaf in leaves_with_path(tq):
        root, *rest = path.split("/")
        if root in ("layers", "head_layers"):
            key = "/".join([root] + rest[1:])
            want = jflat[key][int(rest[0])]
        else:
            key, want = path, jflat[path]
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want),
                                      err_msg=path)
        seen.add(key)
    assert seen == set(jflat)
    layer = tq["layers"][0]
    assert layer["moe"]["wi"]["w_int8"].dim() == 3
    assert layer["moe"]["wi"]["scale"].shape == (
        pair.tcfg.n_experts, 1, 2 * pair.tcfg.d_ff_expert)
    assert torch.is_tensor(layer["moe"]["router"])
    if pair.tcfg.attention == "mla":
        assert torch.is_tensor(layer["attn"]["w_kr"])
        assert "w_int8" in layer["attn"]["w_ukv"]
    assert t_size(tq) == j_size(jq)


def test_calibration_act_scales_match_jax(pair):
    _, want, got = pair.act_scales()
    assert sorted(got) == sorted(want)
    assert any("shared_wi" in p for p in got)
    for p in want:
        np.testing.assert_allclose(got[p], want[p], rtol=1e-5, err_msg=p)


# --------------------------------------------------------------------- #
# the model
# --------------------------------------------------------------------- #
def test_bridge_keeps_both_stacks(pair):
    tp = pair.tp
    assert len(tp["head_layers"]) == pair.tcfg.n_dense_layers
    assert len(tp["layers"]) == pair.tcfg.n_layers - pair.tcfg.n_dense_layers
    assert "mlp" in tp["head_layers"][0] and "moe" in tp["layers"][0]
    assert tp["head_layers"][0]["mlp"]["wo"].shape[0] == \
        pair.tcfg.d_ff_dense
    own = t_init(pair.tcfg, seed=0, device="cpu")
    assert {p: tuple(t.shape) for p, t in leaves_with_path(own)} == {
        p: tuple(t.shape) for p, t in leaves_with_path(tp)}


@pytest.mark.parametrize("variant", ["fp32", "dynamic_int8", "static_int8"])
def test_forward_prefill_decode_match_jax(pair, variant):
    jq, tq = pair.variant(variant)
    rng = np.random.default_rng(7)
    toks = rng.integers(0, pair.jcfg.vocab_size, (2, 19))
    jl, ja = j_forward(jq, {"tokens": jnp.asarray(toks)}, pair.jcfg)
    tl, ta = t_forward(tq, {"tokens": torch.as_tensor(toks)}, pair.tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for key in ja:
        np.testing.assert_allclose(float(ta[key]), float(ja[key]), atol=ATOL,
                                   rtol=0, err_msg=key)
    jl, jc = j_prefill(jq, {"tokens": jnp.asarray(toks)}, pair.jcfg,
                       pad_to=32)
    tl, tc = t_prefill(tq, {"tokens": torch.as_tensor(toks)}, pair.tcfg,
                       pad_to=32)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for key in ("head_layers", "layers"):
        for f, leaf in enumerate(tc[key][0]):
            np.testing.assert_allclose(leaf.numpy(),
                                       np.asarray(jc[key][f][0]), atol=ATOL)
    for step in range(3):
        nxt = rng.integers(0, pair.jcfg.vocab_size, (2, 1))
        jl, jc = j_decode(jq, jc, jnp.asarray(nxt), 19 + step, pair.jcfg)
        tl, tc = t_decode(tq, tc, torch.as_tensor(nxt), 19 + step, pair.tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("variant", ["fp32", "dynamic_int8"])
def test_generate_streams_match_jax(pair, variant):
    jq, tq = pair.variant(variant)
    js, ts = JSession(jq, pair.jcfg), InferenceSession(tq, pair.tcfg,
                                                       device="cpu")
    for n, seed in ((9, 1), (23, 2)):
        toks = np.random.default_rng(seed).integers(
            0, pair.jcfg.vocab_size, (2, n))
        jg = np.asarray(js.generate({"tokens": jnp.asarray(toks)}, 8))
        tg = ts.generate({"tokens": torch.as_tensor(toks)}, 8).numpy()
        np.testing.assert_array_equal(tg, jg)


def _prompts(vocab, lens, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (1, n)) for n in lens]


def _run_engines(engines, prompts, n_new):
    je, te = engines
    pairs = [(je.submit(jnp.asarray(p), max_new_tokens=n_new),
              te.submit(torch.as_tensor(p), max_new_tokens=n_new))
             for p in prompts]
    for e in engines:
        e.run()
    for jr, tr in pairs:
        assert tr.done and tr.out_tokens == jr.out_tokens, tr.rid
        assert tr.preemptions == jr.preemptions
    mj, mt = je.metrics(), te.metrics()
    assert {k: mt[k] for k in COUNTING} == {k: mj[k] for k in COUNTING}
    return mt


ENGINE_MODES = {"dense": {}, "chunked": {"prefill_chunk": 4},
                "paged": {"paged": True, "block_size": 8},
                "preempting": {"paged": True, "block_size": 4,
                               "n_blocks": 12}}


@pytest.mark.parametrize("mode", sorted(ENGINE_MODES))
@pytest.mark.parametrize("variant", ["fp32", "dynamic_int8"])
def test_engine_streams_match_jax(pair, variant, mode):
    """5 requests on 2 slots: idle slots route too (their rows take
    capacity), so the streams hold only if every row matches JAX's."""
    jq, tq = pair.variant(variant)
    kw = dict(n_slots=2, max_len=64, **ENGINE_MODES[mode])
    engines = (JEngine(jq, pair.jcfg, **kw),
               ContinuousBatchingEngine(tq, pair.tcfg, device="cpu", **kw))
    prompts = _prompts(pair.jcfg.vocab_size, (5, 13, 20, 9, 17))
    m = _run_engines(engines, prompts, 6)
    if mode == "preempting":
        assert m["preempted"] > 0


@pytest.mark.parametrize("paged", [False, True])
def test_spec_engine_with_moe_target_matches_jax(pair, paged):
    """The fp32 MoE target verified k + 1 tokens at a time under
    ``allow_moe_target``, the dynamic-int8 variant as its draft."""
    jd, td = pair.variant("dynamic_int8")
    kw = dict(n_slots=2, max_len=64)
    if paged:
        kw.update(paged=True, block_size=8)
    engines = (
        JEngine(pair.jp, pair.jcfg, spec=JSpecConfig(
            draft=(jd, pair.jcfg), k=3, allow_moe_target=True), **kw),
        ContinuousBatchingEngine(pair.tp, pair.tcfg, device="cpu",
                                 spec=SpecConfig(draft=(td, pair.tcfg), k=3,
                                                 allow_moe_target=True),
                                 **kw))
    m = _run_engines(engines, _prompts(pair.jcfg.vocab_size, (7, 15, 11)), 8)
    mj = engines[0].metrics()
    for key in ("spec_events", "spec_draft_tokens", "spec_accepted_tokens"):
        assert m[key] == mj[key], key
    assert m["spec_events"] > 0
    with pytest.raises(ValueError, match="allow_moe_target"):
        ContinuousBatchingEngine(pair.tp, pair.tcfg, device="cpu",
                                 spec=SpecConfig(draft=(td, pair.tcfg), k=3))


# --------------------------------------------------------------------- #
# the published configs' pools and accounting
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ARCHS)
def test_published_configs_build_pools_on_cpu(arch):
    jcfg, tcfg = j_configs.get_config(arch), t_configs.get_config(arch)
    pools = t_kv.init_paged_pools(tcfg, 3, 16, device="cpu")
    assert len(pools["head_layers"]) == tcfg.n_dense_layers
    assert len(pools["layers"]) == tcfg.n_layers - tcfg.n_dense_layers
    assert t_kv.kv_bytes_per_token(tcfg) == j_kv.kv_bytes_per_token(jcfg)
    assert t_kv.kv_bytes_per_block(tcfg, 16) == \
        j_kv.kv_bytes_per_block(jcfg, 16)
    kv = t_kv.PagedKVCache(tcfg, 2, 3, 16, 2, device="cpu")
    assert kv.bytes_per_token == tcfg.n_layers * t_kv.kv_bytes_per_token(tcfg)
    if tcfg.attention == "mla":
        # the compressed streams: (512 + 64) bf16 per token and layer
        assert [tuple(t.shape) for t in pools["layers"][0]] == [
            (3, 16, 512), (3, 16, 64)]
    else:
        assert tuple(pools["layers"][0][0].shape) == (3, 16, 8, 128)
    assert not t_kv.bucketed_prefill_ok(tcfg)
