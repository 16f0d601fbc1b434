"""The architecture sweep on the CPU: the port's twin of
``tests/test_smoke_archs.py`` / ``scripts/smoke_all.py``. Every smoke
config of the JAX package, in f32 on bridged weights: the port's forward,
prefill and decode logits held to JAX's for all ten architectures (dense
GQA, phi-3-vision's frontend, MLA + MoE, GQA + MoE, Mamba2's SSD, the
RG-LRU hybrid and musicgen's conditioning frames with its codebook
tokens ``[B, S, K]`` and logits ``[B, S, K, V]``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import decode_step as j_decode  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro.models import prefill as j_prefill  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.models import decode_step as t_decode  # noqa: E402
from repro_torch.models import forward as t_forward  # noqa: E402
from repro_torch.models import prefill as t_prefill  # noqa: E402

ARCHS = sorted(j_configs.all_arch_ids())
UNPORTED = set()
SEQ, STEPS = 20, 3
ATOL = 1e-4


def test_the_sweep_covers_every_arch():
    assert len(ARCHS) == 10
    assert set(ARCHS) - set(t_configs.CLI_ALIASES) == UNPORTED
    assert t_configs.UNPORTED == frozenset()


def _tokens(rng, cfg, b, s):
    k = cfg.n_codebooks
    return rng.integers(0, cfg.vocab_size, (b, s, k) if k > 1 else (b, s))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_jax(arch):
    jcfg = j_configs.smoke_config(arch).with_overrides(dtype="float32")
    tcfg = t_configs.smoke_config(arch).with_overrides(dtype="float32")
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    rng = np.random.default_rng(len(arch))
    batch = {"tokens": _tokens(rng, jcfg, 2, SEQ)}
    if jcfg.frontend != "none":
        batch["frontend_embeds"] = rng.standard_normal(
            (2, jcfg.n_frontend_tokens, jcfg.frontend_dim)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    jl, ja = j_forward(jp, jb, jcfg)
    tl, ta = t_forward(tp, tb, tcfg)
    cb = (jcfg.n_codebooks,) if jcfg.n_codebooks > 1 else ()
    assert tl.shape == (2, SEQ + jcfg.n_frontend_tokens, *cb,
                        jcfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    for key in ja:
        np.testing.assert_allclose(float(ta[key]), float(ja[key]), atol=ATOL,
                                   rtol=0, err_msg=key)
    jl, jc = j_prefill(jp, jb, jcfg, pad_to=64)
    tl, tc = t_prefill(tp, tb, tcfg, pad_to=64)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=0)
    pos = SEQ + jcfg.n_frontend_tokens
    for step in range(STEPS):
        nxt = _tokens(rng, jcfg, 2, 1)
        jl, jc = j_decode(jp, jc, jnp.asarray(nxt), pos + step, jcfg)
        tl, tc = t_decode(tp, tc, torch.as_tensor(nxt), pos + step, tcfg)
        assert torch.isfinite(tl).all()
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL,
                                   rtol=0, err_msg=f"decode {step}")
