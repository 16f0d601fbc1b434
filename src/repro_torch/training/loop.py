"""The train loop: the port of ``repro.training.loop``. Batches stream in,
one ``train_step`` each, metrics logged every ``log_every`` steps."""
from __future__ import annotations

import time
from typing import Callable, Dict, Iterator

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import init_params
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import OptimizerConfig, adamw_init
from repro_torch.training.train_step import train_step


def fit(cfg: ModelConfig, oc: OptimizerConfig,
        stream: Iterator[Dict[str, torch.Tensor]],
        steps: int, params=None, log_every: int = 20,
        log_fn: Callable[[str], None] = print, seed: int = 0,
        device: DeviceLike = None):
    """Returns (params, history); each batch moves to ``device``. Without
    ``params`` the weights are drawn by ``init_params(cfg, seed, device)``
    (not the JAX package's numbers: its ``PRNGKey`` stream cannot be drawn
    in torch). A logged step copies its metrics to the host, which waits
    for the device. On the CPU the steps run under the ``ref`` backend
    (``api.backends.bind_for``), as an unpinned session does."""
    from repro_torch.api.backends import bind_for, use_backend

    dev = resolve_device(device)
    if params is None:
        params = init_params(cfg, seed, dev)
    opt_state = adamw_init(params, oc)
    history = []
    # repro: allow-wallclock -- wall_s logs real train-step throughput
    t0 = time.perf_counter()
    with use_backend(bind_for(None, dev)):
        for i in range(steps):
            batch = {k: v.to(dev) for k, v in next(stream).items()}
            params, opt_state, metrics = train_step(params, opt_state, batch,
                                                    cfg, oc)
            if i % log_every == 0 or i == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = i
                # repro: allow-wallclock -- interval vs t0 above, logging only
                m["wall_s"] = round(time.perf_counter() - t0, 1)
                history.append(m)
                log_fn(f"step {i:5d} loss={m['loss']:.4f} "
                       f"acc={m['token_acc']:.3f} "
                       f"gnorm={m['grad_norm']:.2f} ({m['wall_s']}s)")
    return params, history
