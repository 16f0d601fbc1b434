"""Fake-tensor stand-ins and the sharding assembly for the dry-run.

The twin of ``repro.launch.specs``. Where JAX takes ``jax.eval_shape``
stand-ins, the port builds fake tensors (``FakeTensorMode``): the same
``init_params`` / ``adamw_init`` / ``init_cache`` on "cpu", with shapes and
dtypes and no memory. Every ``*_structs`` function runs under the fake mode
it is given, else the active one, else a new one; structs that meet in one
step must come from one fake mode.

The ``*_shardings`` functions return spec trees (``models/sharding.py``'s
``Spec`` per leaf, JAX's ``NamedSharding``s less the mesh), and
``distribute`` lays a struct tree out on a mesh as DTensors over fake
local shards.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import torch

from repro_torch.configs import INPUT_SHAPES
from repro_torch.models import init_cache, init_params
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import (Spec, cache_spec, data_spec,
                                         param_specs)
from repro_torch.training.optimizer import OptimizerConfig, adamw_init
from repro_torch.tree import get_path, map_with_path


def fake_mode(fake=None):
    """``fake``, else the active fake mode, else a new one."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode

    return fake or detect_fake_mode() or FakeTensorMode()


@contextlib.contextmanager
def _under(fake):
    mode = fake_mode(fake)
    with mode:
        yield mode


def _token_struct(cfg: ModelConfig, batch: int, seq: int) -> torch.Tensor:
    shape = (batch, seq, cfg.n_codebooks) if cfg.n_codebooks > 1 \
        else (batch, seq)
    return torch.zeros(shape, dtype=torch.int32)


def batch_structs(cfg: ModelConfig, batch: int, seq: int, *, train: bool,
                  fake=None) -> Dict[str, torch.Tensor]:
    with _under(fake):
        s_text = seq - cfg.n_frontend_tokens
        out = {"tokens": _token_struct(cfg, batch, s_text)}
        if train:
            out["labels"] = _token_struct(cfg, batch, s_text)
        if cfg.frontend != "none":
            out["frontend_embeds"] = torch.zeros(
                (batch, cfg.n_frontend_tokens, cfg.frontend_dim),
                dtype=torch.float32)
        return out


def param_structs(cfg: ModelConfig, fake=None):
    with _under(fake):
        return init_params(cfg, device="cpu")


def opt_structs(cfg: ModelConfig, oc: OptimizerConfig, fake=None,
                p_structs=None):
    with _under(fake) as mode:
        return adamw_init(p_structs or param_structs(cfg, mode), oc)


def cache_structs(cfg: ModelConfig, batch: int, seq: int, fake=None):
    with _under(fake):
        return init_cache(cfg, batch, seq, device="cpu")


# ------------------------------------------------------------------ #
# Sharding assembly
# ------------------------------------------------------------------ #
def param_shardings(cfg: ModelConfig, mesh, structs):
    return param_specs(cfg, structs, mesh)


def opt_shardings(cfg: ModelConfig, mesh, o_structs, p_specs):
    """Moments inherit their param's spec; scales and ``step``
    replicate."""
    def rule(path, leaf):
        parts = path.split("/")
        if parts[-1] in ("m", "v", "q") and parts[0] == "mu":
            # mu/<param path>/m (fp32) or mu/<param path>/m/q (int8)
            ppath = "/".join(p for p in parts[1:] if p not in ("m", "v", "q"))
            spec = get_path(p_specs, ppath)
            if len(spec) == leaf.dim():
                return spec
        return Spec(*([None] * leaf.dim()))

    return map_with_path(rule, o_structs)


def batch_shardings(mesh, structs):
    return map_with_path(lambda _, l: data_spec(tuple(l.shape), mesh),
                         structs)


def cache_shardings(mesh, structs):
    return map_with_path(lambda _, l: cache_spec(tuple(l.shape), mesh),
                         structs)


def shape_kind(shape_name: str) -> str:
    return INPUT_SHAPES[shape_name]["kind"]


def config_for_shape(cfg: ModelConfig, shape_name: str) -> ModelConfig:
    if shape_name == "long_500k":
        return cfg.for_long_context()
    return cfg
