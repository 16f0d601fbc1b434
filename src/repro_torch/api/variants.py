"""Declarative variant specs: the port of ``repro.api.variants``.

    specs = [VariantSpec.fp32(), VariantSpec.dynamic_int8(),
             VariantSpec.static_int8(calib_batches=4)]
    qparams, info = spec.build(params, cfg, calib_data=batches)

Static recipes run the calibration forward passes inside ``build``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from repro_torch.core.quant import (CalibrationSession, QuantConfig,
                                    quantize_tree)
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class QuantRecipe:
    """Declarative quantization recipe; maps 1:1 onto ``QuantConfig``."""
    mode: str = "dynamic_int8"        # none | dynamic_int8 | static_int8
    granularity: str = "per_channel"  # per_channel | per_tensor | per_group
    group_size: int = 128
    bits: int = 8
    clip_percentile: float = 0.0
    min_size: int = 1024

    def to_quant_config(self) -> QuantConfig:
        return QuantConfig(mode=self.mode, granularity=self.granularity,
                           group_size=self.group_size, bits=self.bits,
                           clip_percentile=self.clip_percentile,
                           min_size=self.min_size)

    @property
    def needs_calibration(self) -> bool:
        return self.mode == "static_int8"


@dataclasses.dataclass(frozen=True)
class VariantSpec:
    """One artifact variant: its published label + the recipe producing it.

    ``draft_of`` declares a speculative-decoding relation: this variant
    serves as the *draft* for the named target variant (e.g.
    ``dynamic_int8`` drafting for ``fp32``). The registry records it in its
    index at publish time, and ``Deployment.spec_config`` pairs the two
    into a serving ``SpecConfig``."""
    variant: str
    recipe: Optional[QuantRecipe] = None     # None -> params pass through
    calib_batches: int = 0                   # cap on calib_data (0 = all)
    draft_of: Optional[str] = None           # target variant this one drafts

    @classmethod
    def fp32(cls) -> "VariantSpec":
        return cls("fp32", None)

    @classmethod
    def dynamic_int8(cls, min_size: int = 1024,
                     draft_of: Optional[str] = None, **kw) -> "VariantSpec":
        return cls("dynamic_int8",
                   QuantRecipe(mode="dynamic_int8", min_size=min_size, **kw),
                   draft_of=draft_of)

    @classmethod
    def static_int8(cls, calib_batches: int = 4, min_size: int = 1024,
                    draft_of: Optional[str] = None, **kw) -> "VariantSpec":
        return cls("static_int8",
                   QuantRecipe(mode="static_int8", min_size=min_size, **kw),
                   calib_batches=calib_batches, draft_of=draft_of)

    @classmethod
    def int4(cls, group_size: int = 64, min_size: int = 1024,
             draft_of: Optional[str] = None, **kw) -> "VariantSpec":
        """Weight-only int4, one scale per ``group_size`` contraction
        elements (the paper's "advanced quantization" future work)."""
        return cls("int4",
                   QuantRecipe(mode="dynamic_int8", bits=4,
                               granularity="per_group", group_size=group_size,
                               min_size=min_size, **kw),
                   draft_of=draft_of)

    def build(self, params, cfg: ModelConfig,
              calib_data: Optional[Iterable[Dict[str, torch.Tensor]]] = None,
              forward_fn: Optional[Callable] = None
              ) -> Tuple[Any, Dict[str, Any]]:
        """Produce this variant's params from the fp ``params``.
        ``calib_data`` (input batches) is required for static recipes;
        ``forward_fn(params, batch)`` defaults to the model forward."""
        if self.recipe is None or self.recipe.mode == "none":
            return params, {"variant": self.variant, "quantized_paths": []}
        qc = self.recipe.to_quant_config()
        act_scales = None
        n_calib = 0
        if self.recipe.needs_calibration:
            if calib_data is None:
                raise ValueError(
                    f"variant {self.variant!r} is static-quantized and needs "
                    "calib_data (an iterable of input batches)")
            if forward_fn is None:
                from repro_torch.models import forward as _fwd
                forward_fn = lambda p, b: _fwd(p, b, cfg)[0]  # noqa: E731
            sess = CalibrationSession(params, qc)
            with torch.no_grad():
                for i, batch in enumerate(calib_data):
                    if self.calib_batches and i >= self.calib_batches:
                        break
                    forward_fn(sess.instrumented_params, batch)
                    n_calib += 1
            act_scales = sess.act_scales()
        with torch.no_grad():
            qparams, paths = quantize_tree(params, qc, act_scales)
        return qparams, {"variant": self.variant, "quantized_paths": paths,
                         "calibration_batches": n_calib}


#: The paper's trio: the default publish set.
DEFAULT_VARIANTS = (VariantSpec.fp32(), VariantSpec.dynamic_int8(),
                    VariantSpec.static_int8())
