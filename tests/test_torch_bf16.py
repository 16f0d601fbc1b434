"""The port's bf16 forward against the JAX package's, on the smoke configs
at their bf16 default: the same JAX-initialised bf16 weights, bridged as
numpy arrays, and the same tokens go through both. bf16 rounds each
package's intermediates in its own order, so the bound is set by JAX
itself: the port may differ from JAX's bf16 logits by at most twice what
JAX's bf16 logits differ from its f32 logits on the same weights."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as j_configs  # noqa: E402
from repro.models import forward as j_forward  # noqa: E402
from repro.models import init_params as j_init  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.models import forward as t_forward  # noqa: E402


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "mistral-nemo-12b"])
def test_bf16_forward_within_twice_jax_own_bf16_delta(arch):
    jcfg = j_configs.smoke_config(arch)
    tcfg = t_configs.smoke_config(arch)
    assert jcfg.dtype == tcfg.dtype == "bfloat16"
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 24))
    j_bf16 = np.asarray(j_forward(jp, {"tokens": jnp.asarray(tokens)},
                                  jcfg)[0])
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    j_f32 = np.asarray(j_forward(jp32, {"tokens": jnp.asarray(tokens)},
                                 jcfg.with_overrides(dtype="float32"))[0])
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    assert tp["unembed"].dtype == torch.bfloat16
    with torch.no_grad():
        t_bf16 = t_forward(tp, {"tokens": torch.as_tensor(tokens)},
                           tcfg)[0].numpy()
    assert t_bf16.dtype == j_bf16.dtype == np.float32
    own = np.abs(j_bf16 - j_f32).max()
    port = np.abs(t_bf16 - j_bf16).max()
    assert 0 < own < 0.2
    assert port <= 2 * own, (port, own)
