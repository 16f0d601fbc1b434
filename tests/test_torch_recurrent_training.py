"""Training on the recurrent stacks (Mamba2's ``layers``, the hybrid's
``groups`` and ``tail``) against the JAX package on the f32 smoke
configs: ``loss_and_grads`` (remat off, as the smoke configs have it, and
on: one checkpoint per scanned unit, a hybrid group as one), then one
``train_step`` with fp32 and with int8 moments, whose AdamW update is held
to JAX's ``adamw_update`` on the same grads (int8 moment codes and scales
bit for bit), and weight decay by the JAX layout's rank (a per-layer
``[d]`` leaf under ``groups/`` or ``tail/`` is ``[L, d]`` there and
decays)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.data import lm_stream as j_lm_stream  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.training import OptimizerConfig as JOC  # noqa: E402
from repro.training import adamw_init as j_adamw_init  # noqa: E402
from repro.training import adamw_update as j_adamw_update  # noqa: E402
from repro.training.train_step import loss_and_grads as j_grads  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.bridge import grads_to_jax, params_from_jax  # noqa: E402
from repro_torch.training import (OptimizerConfig, adamw_init,  # noqa: E402
                                  adamw_update, loss_and_grads, lr_at,
                                  train_step)
from repro_torch.tree import leaves_with_path  # noqa: E402

ARCHS = ["mamba2-780m", "recurrentgemma-9b"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _noisy(params, seed=5):
    """Non-zero norm gains and biases (zeros at init), so their grads and
    their weight decay show."""
    rng = np.random.default_rng(seed)

    def noisy(path, x):
        name = str(path[-1].key)
        if name in ("ln1", "ln2", "final_norm", "norm", "ba", "bi",
                    "dt_bias"):
            return x + jnp.asarray(rng.standard_normal(x.shape) * 0.3,
                                   x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(noisy, params)


class _Arch:
    def __init__(self, arch):
        self.jcfg = j_configs.smoke_config(arch).with_overrides(
            dtype="float32")
        self.tcfg = t_configs.smoke_config(arch).with_overrides(
            dtype="float32")
        self.jp = _noisy(j_init(jax.random.PRNGKey(0), self.jcfg))
        self.tp = params_from_jax(_np(self.jp), self.tcfg, "cpu")
        # 32 tokens: mamba2's chunked SSD (chunk 16), past the window of 16
        self.batch = next(j_lm_stream(self.jcfg, 4, 32, seed=3))


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    return _Arch(request.param)


def _torch_batch(batch):
    return {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}


def _leafwise_close(port_tree, jax_tree, rtol, rel_atol):
    got = jax.tree_util.tree_flatten_with_path(grads_to_jax(port_tree))[0]
    want = dict(jax.tree_util.tree_flatten_with_path(_np(jax_tree))[0])
    assert len(got) == len(want)
    for path, g in got:
        w = want[path]
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=rel_atol * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(arch, remat):
    """Grads of every leaf (the SSM's A_log, D, dt_bias; the RG-LRU's lam,
    block-diagonal gates and conv) to 1e-5 of the leaf's largest."""
    jcfg = arch.jcfg.with_overrides(remat=remat)
    tcfg = arch.tcfg.with_overrides(remat=remat)
    jl, jm, jg = jax.jit(lambda p, b: j_grads(p, b, jcfg))(arch.jp,
                                                           arch.batch)
    tl, tm, tg = loss_and_grads(arch.tp, _torch_batch(arch.batch), tcfg)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7)
    _leafwise_close(tg, jg, 0.0, 1e-5)
    assert not any(t.requires_grad for _, t in leaves_with_path(tg))


@pytest.mark.parametrize("int8_state", [False, True])
def test_train_step_matches_jax(arch, int8_state):
    """One ``train_step``: its loss is JAX's and its params are its own
    grads then its own update; the update, taken on JAX's grads, is JAX's
    ``adamw_update`` (eager: the function as written) with params to 1e-6
    and moments to 1e-6 (fp32) or codes and scales bit for bit (int8)."""
    oc = OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                         grad_clip=1e9, int8_state=int8_state)
    joc = JOC(**dataclasses.asdict(oc))
    tb = _torch_batch(arch.batch)
    tp1, ts1, tm = train_step(arch.tp, adamw_init(arch.tp, oc), tb,
                              arch.tcfg, oc)
    jl, _, jg = jax.jit(lambda p, b: j_grads(p, b, arch.jcfg))(arch.jp,
                                                               arch.batch)
    np.testing.assert_allclose(float(tm["loss"]), float(jl), rtol=1e-5)
    assert int(ts1["step"]) == 1 and np.isfinite(float(tm["grad_norm"]))
    jp, js, _ = j_adamw_update(arch.jp, jg, j_adamw_init(arch.jp, joc), joc)
    tp, ts, _ = adamw_update(arch.tp, params_from_jax(_np(jg), arch.tcfg,
                                                      "cpu"),
                             adamw_init(arch.tp, oc), oc)
    _leafwise_close(tp, jp, 1e-6, 1e-6)
    if int8_state:
        got = jax.tree_util.tree_flatten_with_path(grads_to_jax(ts["mu"]))[0]
        want = dict(jax.tree_util.tree_flatten_with_path(_np(js["mu"]))[0])
        assert len(got) == len(want)
        for path, g in got:
            assert g.dtype == want[path].dtype
            np.testing.assert_array_equal(
                g, want[path], err_msg=jax.tree_util.keystr(path))
    else:
        _leafwise_close(ts["mu"], js["mu"], 1e-6, 0.0)
    # the step is its grads then its update: Adam's first step is about
    # lr * sign(g), so it is held to the port's own composition
    _, _, tg = loss_and_grads(arch.tp, tb, arch.tcfg)
    want, _, _ = adamw_update(arch.tp, tg, adamw_init(arch.tp, oc), oc)
    mine = dict(leaves_with_path(tp1))
    for path, leaf in leaves_with_path(want):
        assert torch.equal(mine[path], leaf), path


def test_weight_decay_follows_the_jax_rank(arch):
    """Per-layer ``[d]`` leaves (ln1, ln2, the SSM's D / dt_bias / norm,
    the RG-LRU's lam / ba / bi) are ``[L, d]`` in JAX and decay, under
    ``layers/``, ``groups/`` and ``tail/`` alike; final_norm does not."""
    oc = OptimizerConfig(lr=1e-2, warmup_steps=1, total_steps=10,
                         weight_decay=0.5)
    zero = jax.tree.map(jnp.zeros_like, arch.jp)
    tp, _, _ = adamw_update(arch.tp,
                            params_from_jax(_np(zero), arch.tcfg, "cpu"),
                            adamw_init(arch.tp, oc), oc)
    lr = float(lr_at(1, oc))
    before = dict(leaves_with_path(arch.tp))
    decayed = 0
    for path, leaf in leaves_with_path(tp):
        if leaf.dim() != 1:
            continue
        if path == "final_norm":
            assert torch.equal(leaf, before[path])
        else:
            torch.testing.assert_close(
                leaf, before[path] - lr * 0.5 * before[path], msg=path)
            decayed += 1
    stacks = {p.split("/")[0] for p, t in leaves_with_path(tp)
              if t.dim() == 1 and p != "final_norm"}
    assert stacks == ({"groups", "tail"} if arch.tcfg.arch_type == "hybrid"
                      else {"layers"})
    assert decayed > 0
