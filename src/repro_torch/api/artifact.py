"""``ModelArtifact``: the port of ``repro.api.artifact``, the one object
that travels the EdgeMLOps lifecycle.

An artifact is a model *variant*: params + config + identity (name,
version, variant) + provenance (manifest, metrics, and the registry ref
once published or fetched).

    model = ModelArtifact.create("vqi", "v1", params, cfg)
    published = registry.publish_variants(model, specs, calib_data=...)
    session = published["static_int8"].session()          # on the card
    plain = published["static_int8"].session(backend="ref")  # plain path

``session(backend=, device=)``: ``backend`` pins a kernel backend of the
registry (``repro_torch.api.backends``), ``device`` places the weights.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.device import DeviceLike
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class ModelArtifact:
    name: str
    version: str
    params: Any
    config: ModelConfig
    variant: str = "fp32"
    manifest: Dict[str, Any] = dataclasses.field(default_factory=dict)
    metrics: Dict[str, Any] = dataclasses.field(default_factory=dict)
    ref: Optional[Any] = None          # api.registry.ArtifactRef once stored

    @classmethod
    def create(cls, name: str, version: str, params,
               config: ModelConfig) -> "ModelArtifact":
        """An unpublished fp32 artifact, ready for ``publish_variants``."""
        return cls(name=name, version=version, params=params, config=config)

    # ------------------------------------------------------------------ #
    @property
    def key(self) -> str:
        return f"{self.name}:{self.version}:{self.variant}"

    @property
    def sha256(self) -> Optional[str]:
        return self.ref.sha256 if self.ref is not None else None

    @property
    def size_bytes(self) -> int:
        if self.ref is not None:
            return self.ref.size_bytes
        from repro_torch.core.quant import tree_size_bytes

        return tree_size_bytes(self.params)

    @property
    def published(self) -> bool:
        return self.ref is not None

    # ------------------------------------------------------------------ #
    def with_variant(self, variant: str, params,
                     metrics: Optional[Dict[str, Any]] = None
                     ) -> "ModelArtifact":
        """A sibling artifact: same model identity, different variant params."""
        return dataclasses.replace(
            self, variant=variant, params=params, metrics=metrics or {},
            manifest={}, ref=None)

    def session(self, backend=None, device: DeviceLike = None):
        """An ``InferenceSession`` serving this artifact on ``device``
        (default: the card), optionally pinned to a kernel backend of the
        registry."""
        from repro_torch.serving.engine import InferenceSession

        return InferenceSession.from_artifact(self, backend=backend,
                                              device=device)

    def __repr__(self) -> str:
        state = "published" if self.published else "local"
        return (f"ModelArtifact({self.key}, {state}, "
                f"{self.size_bytes / 1e6:.2f}MB)")
