"""The port's training (loss, AdamW with fp32 and int8 moments,
loss_and_grads, train_step, fit), the flash prefill's backward, the LM
stream, VQI training and retraining, and the training launcher, against
the JAX package: the same JAX-initialised weights, bridged as numpy
arrays, and the same JAX-made batches go through both."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.api.backends import use_backend  # noqa: E402
from repro.data import lm_stream as j_lm_stream  # noqa: E402
from repro.data import vqi_stream as j_vqi_stream  # noqa: E402
from repro.fleet import vqi as j_vqi  # noqa: E402
from repro.fleet.telemetry import InferenceRecord as JRecord  # noqa: E402
from repro.fleet.telemetry import TelemetryHub as JHub  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.training import OptimizerConfig as JOC  # noqa: E402
from repro.training import adamw_init as j_adamw_init  # noqa: E402
from repro.training import adamw_update as j_adamw_update  # noqa: E402
from repro.training import fit as j_fit  # noqa: E402
from repro.training import total_loss as j_total_loss  # noqa: E402
from repro.training import xent as j_xent  # noqa: E402
from repro.training.optimizer import _dq8 as j_dq8  # noqa: E402
from repro.training.optimizer import _q8 as j_q8  # noqa: E402
from repro.training.optimizer import lr_at as j_lr_at  # noqa: E402
from repro.training.train_step import loss_and_grads as j_grads  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.bridge import (grads_to_jax, opt_state_from_jax,  # noqa: E402
                                params_from_jax)
from repro_torch.data import lm_batch, lm_stream  # noqa: E402
from repro_torch.fleet import vqi as t_vqi  # noqa: E402
from repro_torch.fleet.telemetry import InferenceRecord  # noqa: E402
from repro_torch.fleet.telemetry import TelemetryHub  # noqa: E402
from repro_torch.kernels import flash_prefill as t_flash  # noqa: E402
from repro_torch.kernels.ref import (flash_prefill_ref,  # noqa: E402
                                     flash_prefill_vjp)
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.launch import train as t_launch  # noqa: E402
from repro_torch.training import (IGNORE, OptimizerConfig,  # noqa: E402
                                  adamw_init, adamw_update, fit,
                                  loss_and_grads, lr_at, total_loss, xent)
from repro_torch.training import loop as t_loop  # noqa: E402
from repro_torch.training.optimizer import _dq8, _q8  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

ARCHS = ["stablelm-1.6b", "mistral-nemo-12b"]   # MHA hd 32; GQA 4:2 hd 32


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _to_torch(batch):
    return {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}


def _with_norm_noise(params, seed=5):
    """Non-zero norm gains (zeros at init), so weight decay on them shows."""
    rng = np.random.default_rng(seed)

    def noisy(path, x):
        name = str(path[-1].key)
        if name in ("ln1", "ln2", "final_norm"):
            return x + jnp.asarray(rng.standard_normal(x.shape) * 0.3,
                                   x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(noisy, params)


class _Arch:
    """One arch at f32: JAX params (norm gains made non-zero) and the same
    weights bridged into the port, plus JAX-made LM batches."""

    def __init__(self, arch, **over):
        self.jcfg = j_configs.smoke_config(arch).with_overrides(
            dtype="float32", **over)
        self.tcfg = t_configs.smoke_config(arch).with_overrides(
            dtype="float32", **over)
        self.jp = _with_norm_noise(j_init(jax.random.PRNGKey(0), self.jcfg))
        self.tp = params_from_jax(_np(self.jp), self.tcfg, "cpu")
        stream = j_lm_stream(self.jcfg, 4, 16, seed=3)
        self.batches = [next(stream) for _ in range(3)]


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return _Arch(request.param)


def _leafwise_close(port_tree, jax_tree, rtol, rel_atol):
    """Each leaf within rtol, plus rel_atol times the leaf's max |x|."""
    got = jax.tree_util.tree_flatten_with_path(grads_to_jax(port_tree))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(_np(jax_tree))[0])
    assert len(got) == len(want)
    for path, g in got:
        w = want[path]
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rel_atol * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))


# --------------------------------------------------------------------- #
# Loss
# --------------------------------------------------------------------- #
def test_xent_and_total_loss_match_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :3] = IGNORE
    labels[2, -1] = IGNORE
    jl, ja = j_xent(jnp.asarray(logits), jnp.asarray(labels))
    tl, ta = xent(torch.as_tensor(logits), torch.as_tensor(labels))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    np.testing.assert_allclose(ta.item(), float(ja), rtol=1e-6)
    # every position masked: the count floors at 1
    none = np.full((3, 7), IGNORE, np.int32)
    assert xent(torch.as_tensor(logits), torch.as_tensor(none))[0].item() \
        == float(j_xent(jnp.asarray(logits), jnp.asarray(none))[0]) == 0.0

    # the VLM pads its labels over the 8 frontend positions
    jcfg = j_vqi.vqi_config(d_model=64)
    tcfg = t_vqi.vqi_config(d_model=64)
    logits = rng.standard_normal((2, 11, jcfg.vocab_size)).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab_size, (2, 3)).astype(np.int32)
    labels[:, -1] = IGNORE
    aux = {"lb_loss": 0.25, "z_loss": 2.0, "fraction_dropped": 0.0}
    jl, jm = j_total_loss(jnp.asarray(logits),
                          {k: jnp.float32(v) for k, v in aux.items()},
                          {"labels": jnp.asarray(labels)}, jcfg)
    tl, tm = total_loss(torch.as_tensor(logits),
                        {k: torch.tensor(v) for k, v in aux.items()},
                        {"labels": torch.as_tensor(labels)}, tcfg)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-6)
    assert sorted(tm) == sorted(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6)


# --------------------------------------------------------------------- #
# Optimizer
# --------------------------------------------------------------------- #
def _q8_cases():
    rng = np.random.default_rng(1)
    ties = np.array([[127.0, 2.5, -3.5, 0.5, -0.5, 1.5, 126.5, -126.5]],
                    np.float32)     # scale 1: every code a half-integer tie
    rows = rng.standard_normal((5, 33)).astype(np.float32) * 1e-3
    rows[1] = 0.0                   # a zero row: the 1e-20 floor
    return {"ties": ties, "rows": rows,
            "zero_d": np.float32(-0.37),
            "tiny": np.full((2, 3), 1e-30, np.float32),
            "stacked": rng.standard_normal((2, 4, 9)).astype(np.float32)}


@pytest.mark.parametrize("case", sorted(_q8_cases()))
def test_q8_dq8_bit_identical(case):
    x = _q8_cases()[case]
    jq = j_q8(jnp.asarray(x))
    tq = _q8(torch.as_tensor(x))
    for k in ("q", "scale"):
        assert tq[k].numpy().dtype == np.asarray(jq[k]).dtype
        np.testing.assert_array_equal(tq[k].numpy(), np.asarray(jq[k]))
    np.testing.assert_array_equal(_dq8(tq).numpy(), np.asarray(j_dq8(jq)))


def test_lr_at_matches_jax():
    for oc in (OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=40),
               OptimizerConfig(lr=5e-4, warmup_steps=0, total_steps=7)):
        joc = JOC(**dataclasses.asdict(oc))
        for step in range(oc.total_steps + 6):
            want = float(j_lr_at(jnp.int32(step), joc))
            np.testing.assert_allclose(float(lr_at(step, oc)), want,
                                       rtol=1e-6)
            np.testing.assert_allclose(
                float(lr_at(torch.tensor(step, dtype=torch.int32), oc)),
                want, rtol=1e-6)


def _jax_grads(arch, seed):
    """Random grads in the JAX layout, about the size of real ones."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape) * 0.05, p.dtype),
        arch.jp)


def _adamw_steps(arch, oc, n_steps):
    """n_steps of adamw_update in both packages on identical grads, eager
    JAX (the function as written, no XLA rewrites)."""
    joc = JOC(**dataclasses.asdict(oc))
    jp, js = arch.jp, j_adamw_init(arch.jp, joc)
    tp, ts = arch.tp, adamw_init(arch.tp, oc)
    for i in range(n_steps):
        g = _jax_grads(arch, 10 + i)
        jp, js, jm = j_adamw_update(jp, g, js, joc)
        tp, ts, tm = adamw_update(
            tp, params_from_jax(_np(g), arch.tcfg, "cpu"), ts, oc)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(ts["step"]) == int(js["step"]) == n_steps
    return jp, js, tp, ts


@pytest.mark.parametrize("grad_clip", [1e9, 1.0])
def test_adamw_update_fp32_matches_jax(arch, grad_clip):
    """Params and moments rtol 1e-6 over 3 steps. The per-layer norm gains
    are decayed, as JAX decays its [L, d] leaves. With the clip active
    (grad norm ~5 > 1) the clip scale may differ by an ulp, and where ``b1
    * m`` and ``(1 - b1) * g`` nearly cancel that ulp is a large part of
    the moment: those leaves hold to 1e-6 of their largest element. The
    params do so in every case: torch's CPU ``sqrt`` is not correctly
    rounded (XLA's is), and an ulp of the update shows where ``p`` and
    ``lr * update`` nearly cancel."""
    oc = OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                         grad_clip=grad_clip)
    rel_atol = 0.0 if grad_clip > 1e3 else 1e-6
    jp, js, tp, ts = _adamw_steps(arch, oc, 3)
    _leafwise_close(tp, jp, 1e-6, 1e-6)
    _leafwise_close(ts["mu"], js["mu"], 1e-6, rel_atol)
    # the bridge carries the state across: one more step from JAX's state
    g = _jax_grads(arch, 99)
    jp2, js2, _ = j_adamw_update(jp, g, js, JOC(**dataclasses.asdict(oc)))
    tp2, ts2, _ = adamw_update(
        params_from_jax(_np(jp), arch.tcfg, "cpu"),
        params_from_jax(_np(g), arch.tcfg, "cpu"),
        opt_state_from_jax(_np(js), arch.tcfg, "cpu"), oc)
    _leafwise_close(tp2, jp2, 1e-6, 1e-6)
    _leafwise_close(ts2["mu"], js2["mu"], 1e-6, rel_atol)


def test_adamw_weight_decay_follows_the_jax_rank(arch):
    """ln1 / ln2 ([d] per layer, [L, d] in JAX) decay; final_norm does not."""
    oc = OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                         weight_decay=0.5)
    zero = jax.tree.map(jnp.zeros_like, arch.jp)
    tp, _, _ = adamw_update(arch.tp,
                            params_from_jax(_np(zero), arch.tcfg, "cpu"),
                            adamw_init(arch.tp, oc), oc)
    lr = float(lr_at(1, oc))
    for i, layer in enumerate(tp["layers"]):
        for name in ("ln1", "ln2"):
            before = arch.tp["layers"][i][name]
            torch.testing.assert_close(layer[name],
                                       before - lr * 0.5 * before)
    assert torch.equal(tp["final_norm"], arch.tp["final_norm"])


def test_adamw_int8_moments_bit_identical(arch):
    """int8 moments over 3 steps with the clip inactive: codes and scales
    bit for bit, params rtol 1e-6 (plus 1e-6 of each leaf's largest
    element, as in the fp32 case)."""
    oc = OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                         grad_clip=1e9, int8_state=True)
    jp, js, tp, ts = _adamw_steps(arch, oc, 3)
    got = jax.tree_util.tree_flatten_with_path(grads_to_jax(ts["mu"]))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(_np(js["mu"]))[0])
    assert len(got) == len(want) and any("scale" in jax.tree_util.keystr(p)
                                         for p, _ in got)
    for path, g in got:
        assert g.dtype == want[path].dtype
        np.testing.assert_array_equal(g, want[path],
                                      err_msg=jax.tree_util.keystr(path))
    _leafwise_close(tp, jp, 1e-6, 1e-6)


def test_adamw_int8_moments_close_with_the_clip_active(arch):
    oc = OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                         int8_state=True)
    jp, js, tp, ts = _adamw_steps(arch, oc, 2)
    dq = lambda tree: jax.tree.map(  # noqa: E731
        lambda q: np.asarray(q["q"], np.float32) * np.asarray(q["scale"]),
        tree, is_leaf=lambda n: isinstance(n, dict) and "q" in n)
    got = jax.tree_util.tree_flatten_with_path(dq(grads_to_jax(ts["mu"])))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(dq(_np(js["mu"])))[0])
    for path, g in got:
        # one code step at most, where a .5 quotient met an ulp of scale
        step = np.abs(want[path]).max() / 127 + 1e-30
        np.testing.assert_allclose(g, want[path], rtol=0, atol=1.01 * step)
    _leafwise_close(tp, jp, 1e-5, 1e-6)


# --------------------------------------------------------------------- #
# loss_and_grads, remat, fit
# --------------------------------------------------------------------- #
def _jit_grads(cfg):
    return jax.jit(lambda p, b: j_grads(p, b, cfg))


@pytest.mark.parametrize("accum", [1, 2])
def test_loss_and_grads_match_jax(arch, accum):
    jcfg = arch.jcfg.with_overrides(grad_accum=accum)
    tcfg = arch.tcfg.with_overrides(grad_accum=accum)
    batch = arch.batches[0]
    jl, jm, jg = _jit_grads(jcfg)(arch.jp, batch)
    tl, tm, tg = loss_and_grads(arch.tp, _to_torch(batch), tcfg)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7)
    _leafwise_close(tg, jg, 0.0, 1e-5)
    assert not any(t.requires_grad for _, t in leaves_with_path(tg))


def test_vlm_loss_and_grads_match_jax():
    """phi-3-vision reduced (the VQI family): frontend_proj gets grads and
    the labels are padded over the patch positions."""
    jcfg = j_vqi.vqi_config(d_model=64)
    tcfg = t_vqi.vqi_config(d_model=64)
    jp = j_init(jax.random.PRNGKey(1), jcfg)
    tp = params_from_jax(_np(jp), tcfg, "cpu")
    batch = next(j_vqi_stream(jcfg, 4, seed=2))
    batch = {k: batch[k] for k in ("tokens", "labels", "frontend_embeds")}
    jl, _, jg = _jit_grads(jcfg)(jp, batch)
    tl, _, tg = loss_and_grads(tp, _to_torch(batch), tcfg)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    _leafwise_close(tg, jg, 0.0, 1e-5)


def _counting_flash(monkeypatch):
    """Route the model's attention through the autograd Function with the
    plain forward standing in for the card's kernel, and count its
    launches: the wiring of the card's training path, on the CPU."""
    calls = []

    def fake_kernel(q, k, v, body=None, tile=None):
        calls.append(q.shape)
        return flash_prefill_ref(q, k, v)

    monkeypatch.setattr(t_flash, "_flash_tc", fake_kernel)

    def through_function(q, k, v):
        if torch.is_grad_enabled() and q.requires_grad:
            # the body and the tile the wrapper would launch
            body = t_flash.body_for(q, k, v)
            tile = t_flash.tile_for(body, q.shape[3], v.shape[3])
            return t_flash._FlashPrefill.apply(q, k, v, body, tile)
        return fake_kernel(q, k, v)

    monkeypatch.setattr(t_ops, "flash_prefill", through_function)
    return calls


def test_remat_gives_equal_loss_and_grads(arch, monkeypatch):
    """cfg.remat recomputes each layer in the backward: the same loss and
    grads, and two flash launches per layer (forward and recompute), as
    the card counts them."""
    calls = _counting_flash(monkeypatch)
    batch = _to_torch(arch.batches[1])
    l0, _, g0 = loss_and_grads(arch.tp, batch,
                               arch.tcfg.with_overrides(remat=False))
    assert len(calls) == arch.tcfg.n_layers
    calls.clear()
    l1, _, g1 = loss_and_grads(arch.tp, batch,
                               arch.tcfg.with_overrides(remat=True))
    assert len(calls) == 2 * arch.tcfg.n_layers
    assert l1.item() == l0.item()
    for (_, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(
            grads_to_jax(g1))[0], jax.tree_util.tree_flatten_with_path(
            grads_to_jax(g0))[0]):
        np.testing.assert_array_equal(a, b)
    # and the Function's grads are JAX's
    jl, _, jg = _jit_grads(arch.jcfg)(arch.jp, arch.batches[1])
    np.testing.assert_allclose(l1.item(), float(jl), rtol=1e-5)
    _leafwise_close(g1, jg, 0.0, 1e-5)


@pytest.mark.parametrize("int8_state", [False, True])
def test_fit_loss_history_matches_jax(arch, int8_state):
    oc = OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=3,
                         int8_state=int8_state)
    joc = JOC(**dataclasses.asdict(oc))
    _, jh = j_fit(arch.jcfg, joc, iter(arch.batches), 3, params=arch.jp,
                  log_every=1, log_fn=lambda s: None)
    lines = []
    _, th = fit(arch.tcfg, oc, map(_to_torch, arch.batches), 3,
                params=arch.tp,
                log_every=1, log_fn=lines.append, device="cpu")
    assert len(lines) == len(th) == 3
    assert [sorted(h) for h in th] == [sorted(h) for h in jh]
    # JAX's jitted step multiplies by f32(1/127) in the int8 moments, so a
    # code can differ, and a v code of 0 against 1 moves its element's
    # update far: the int8 run holds by its loss history, which is the
    # contract, not by its later grad norms
    keys = ("loss", "xent", "token_acc", "lr") + (
        () if int8_state else ("grad_norm",))
    for key in keys:
        np.testing.assert_allclose([h[key] for h in th],
                                   [h[key] for h in jh], rtol=1e-4,
                                   err_msg=key)
    # fit returns new tensors: the caller's params are as they were
    assert torch.equal(arch.tp["unembed"],
                       torch.as_tensor(np.array(arch.jp["unembed"])))


# --------------------------------------------------------------------- #
# The flash prefill's backward
# --------------------------------------------------------------------- #
VJP_CASES = [(2, 13, 4, 4, 16, 16), (2, 13, 4, 2, 16, 24),
             (1, 70, 6, 3, 32, 8)]      # (B, S, Hq, Hkv, hd, dv)


@pytest.mark.parametrize("b,s,hq,hkv,hd,dv", VJP_CASES)
def test_flash_prefill_vjp_matches_autograd_and_jax(b, s, hq, hkv, hd, dv):
    rng = np.random.default_rng(hq * s + dv)
    q, k, v, dout = (rng.standard_normal(shape).astype(np.float32)
                     for shape in ((b, s, hq, hd), (b, s, hkv, hd),
                                   (b, s, hkv, dv), (b, s, hq, dv)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = flash_prefill_ref(tq, tk, tv)
    want = torch.autograd.grad(out, (tq, tk, tv), torch.as_tensor(dout))
    got = flash_prefill_vjp(tq.detach(), tk.detach(), tv.detach(),
                            out.detach(), torch.as_tensor(dout))
    with use_backend("ref"):
        j_out, vjp = jax.vjp(j_ops.flash_prefill, jnp.asarray(q),
                             jnp.asarray(k), jnp.asarray(v))
        j_want = vjp(jnp.asarray(dout))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               atol=1e-5)
    for g, w, jw in zip(got, want, j_want):
        assert g.shape == w.shape == jw.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-5)
        np.testing.assert_allclose(g.numpy(), np.asarray(jw), atol=1e-5)
    # bf16 inputs get bf16 grads
    got16 = flash_prefill_vjp(*(t.detach().to(torch.bfloat16)
                                for t in (tq, tk, tv)), out.detach(),
                              torch.as_tensor(dout))
    assert [g.dtype for g in got16] == [torch.bfloat16] * 3


# --------------------------------------------------------------------- #
# Data, VQI training and retraining, the launcher
# --------------------------------------------------------------------- #
def test_lm_batch_layout_and_structure():
    cfg = t_configs.smoke_config("stablelm-1.6b")
    gen = torch.Generator().manual_seed(0)
    b = lm_batch(gen, cfg, 64, 32, "cpu")
    toks, labels = b["tokens"], b["labels"]
    assert toks.shape == labels.shape == (64, 32)
    assert toks.dtype == labels.dtype == torch.int64
    assert toks.min() >= 0 and toks.max() < cfg.vocab_size
    assert torch.equal(labels[:, :-1], toks[:, 1:])
    assert (labels[:, -1] == IGNORE).all()
    # first-order structure: each step is 31 * (a Pareto(1.2) * 8 draw)
    steps = (toks[:, 1:] - toks[:, :-1]) % cfg.vocab_size
    inv31 = pow(31, -1, cfg.vocab_size)
    z = (steps * inv31) % cfg.vocab_size
    assert z.min() >= 8          # Pareto >= 1, so every draw is >= 8
    assert 0.1 < (z >= 40).float().mean() < 0.25   # P(x >= 5) = 5**-1.2
    # the JAX stream has the same layout and the same step law
    jb = next(j_lm_stream(j_configs.smoke_config("stablelm-1.6b"), 64, 32))
    jt = np.asarray(jb["tokens"]).astype(np.int64)
    jz = ((jt[:, 1:] - jt[:, :-1]) % cfg.vocab_size * inv31) \
        % cfg.vocab_size
    assert jz.min() >= 8 and 0.1 < (jz >= 40).mean() < 0.25
    # a seed gives the same stream
    s1, s2 = lm_stream(cfg, 2, 8, seed=4, device="cpu"), \
        lm_stream(cfg, 2, 8, seed=4, device="cpu")
    for _ in range(2):
        assert torch.equal(next(s1)["tokens"], next(s2)["tokens"])


def test_train_vqi_model_history_matches_jax(monkeypatch):
    """train_vqi_model's optimizer and loop against JAX's on the same
    batches (the JAX stream) and the same initial weights (JAX's
    ``PRNGKey(0)``)."""
    jcfg = j_vqi.vqi_config(d_model=64)
    tcfg = t_vqi.vqi_config(d_model=64)
    steps, batch = 4, 8
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    jstream = j_vqi_stream(jcfg, batch)
    fed = [next(jstream) for _ in range(steps)]
    monkeypatch.setattr(t_vqi, "vqi_stream", lambda cfg, b, device=None:
                        iter([_to_torch(x) for x in fed]))
    monkeypatch.setattr(t_loop, "init_params", lambda cfg, seed, dev:
                        params_from_jax(_np(jp), cfg, dev))
    _, jh = j_vqi.train_vqi_model(jcfg, steps=steps, batch=batch,
                                  log_fn=lambda s: None)
    _, th = t_vqi.train_vqi_model(tcfg, steps=steps, batch=batch,
                                  log_fn=lambda s: None, device="cpu")
    assert [h["step"] for h in th] == [h["step"] for h in jh] == [0, 3]
    for key in ("loss", "token_acc", "grad_norm", "lr"):
        np.testing.assert_allclose([h[key] for h in th],
                                   [h[key] for h in jh], rtol=1e-4,
                                   err_msg=key)


def _records(record_cls, cfg, as_array):
    rng = np.random.default_rng(7)
    out = []
    for i in range(9):
        sample = None
        if i % 3:
            sample = {"frontend_embeds": as_array(rng.standard_normal(
                (cfg.n_frontend_tokens, cfg.frontend_dim)).astype(
                    np.float32)),
                "tokens": as_array(np.array([cfg.vocab_size - 8, 1, 2])),
                "labels": as_array(np.array([1, 2, IGNORE]))
                if i % 3 == 1 else None}
        out.append(record_cls(
            device_id="edge-0", model_key="vqi:v1:fp32", latency_ms=1.0,
            asset_id=f"a{i}", prediction={"asset_type": "power_line",
                                          "condition": "good"},
            confidence=0.3, correct=None, sample=sample))
    return out


def test_retrain_from_telemetry_replays_what_jax_replays():
    jcfg = j_vqi.vqi_config(d_model=64)
    tcfg = t_vqi.vqi_config(d_model=64)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    jhub, thub = JHub(), TelemetryHub()
    for rec in _records(JRecord, jcfg, jnp.asarray):
        jhub.push(rec)
    for rec in _records(InferenceRecord, tcfg, torch.as_tensor):
        thub.push(rec)
    _, jinfo = j_vqi.retrain_from_telemetry(jhub, jp, jcfg, steps=2,
                                            batch=8, log_fn=lambda s: None)
    tp = params_from_jax(_np(jp), tcfg, "cpu")
    new, tinfo = t_vqi.retrain_from_telemetry(thub, tp, tcfg, steps=2,
                                              batch=8, log_fn=lambda s: None,
                                              device="cpu")
    assert tinfo["replayed_samples"] == jinfo["replayed_samples"] == 3
    assert np.isfinite(tinfo["final_loss"])
    assert not torch.equal(new["unembed"], tp["unembed"])


def test_launch_train_runs_on_the_cpu_and_needs_a_device(tmp_path,
                                                         monkeypatch):
    history = t_launch.main(["--arch", "stablelm-1.6b", "--steps", "3",
                             "--device", "cpu", "--checkpoint",
                             str(tmp_path / "ckpt")])
    assert len(history) == 2 and np.isfinite(history[-1]["loss"])
    assert (tmp_path / "ckpt" / "weights.npz").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_launch.main(["--arch", "stablelm-1.6b", "--steps", "1"])
