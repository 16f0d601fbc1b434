"""The artifact store's old location: ``ArtifactRegistry`` / ``ArtifactRef``
live in ``repro_torch.api.registry``, next to ``ModelArtifact``,
``VariantSpec`` and ``Deployment``; the fleet layer consumes artifacts, it
does not store them. This module keeps the JAX package's import path."""
from repro_torch.api.registry import ArtifactRef, ArtifactRegistry

__all__ = ["ArtifactRef", "ArtifactRegistry"]
