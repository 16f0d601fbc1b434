"""Artifact registry, the Cumulocity IoT *Software Repository* analog: the
port of ``repro.api.registry``.

A content-addressed, versioned store of model artifacts (weights +
manifest, ``training/checkpoint.py``'s format) with an ``index.json`` in
the JAX package's layout, so each package reads the other's registry. The
same model version is published as fp32 / static_int8 / dynamic_int8
variants and devices pull the variant their profile requires. A variant
published with ``VariantSpec(draft_of=...)`` records its speculative-decoding
relation in its index entry, and ``draft_for`` finds it again, whichever
package published it.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.clock import now
from repro_torch.device import DeviceLike
from repro_torch.models.config import ModelConfig
from repro_torch.training.checkpoint import load_checkpoint, save_checkpoint


@dataclasses.dataclass(frozen=True)
class ArtifactRef:
    name: str
    version: str
    variant: str            # fp32 | static_int8 | dynamic_int8
    sha256: str
    size_bytes: int

    @property
    def key(self) -> str:
        return f"{self.name}:{self.version}:{self.variant}"


class ArtifactRegistry:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._index_path = os.path.join(root, "index.json")
        self._index: Dict[str, Dict[str, Any]] = {}
        if os.path.exists(self._index_path):
            with open(self._index_path) as f:
                self._index = json.load(f)

    # ------------------------------------------------------------- #
    def _save_index(self) -> None:
        with open(self._index_path, "w") as f:
            json.dump(self._index, f, indent=1)

    def _dir(self, name: str, version: str, variant: str) -> str:
        return os.path.join(self.root, name, version, variant)

    def publish(self, name: str, version: str, params, cfg: ModelConfig,
                variant: str = "fp32",
                metrics: Optional[Dict[str, float]] = None) -> ArtifactRef:
        """Low-level publish of one variant's params. Prefer
        ``publish_artifact`` / ``publish_variants``."""
        d = self._dir(name, version, variant)
        manifest = save_checkpoint(d, params, cfg, meta={
            "name": name, "version": version, "variant": variant,
            "published_at": now(), "metrics": metrics or {},
        })
        ref = ArtifactRef(name, version, variant,
                          manifest["sha256"], manifest["size_bytes"])
        self._index[ref.key] = {
            "sha256": ref.sha256, "size_bytes": ref.size_bytes,
            "dir": d, "metrics": metrics or {}, "published_at": now(),
        }
        self._save_index()
        return ref

    def fetch(self, ref: ArtifactRef, device: DeviceLike = None
              ) -> Tuple[Any, ModelConfig, Dict[str, Any]]:
        """Integrity-checked load onto ``device`` (sha256 verified by
        ``load_checkpoint``). Legacy tuple form: prefer
        ``fetch_artifact``."""
        entry = self._index.get(ref.key)
        if entry is None:
            raise KeyError(f"unknown artifact {ref.key}")
        params, cfg, manifest = load_checkpoint(entry["dir"], device)
        if manifest["sha256"] != ref.sha256:
            raise IOError(f"registry integrity failure for {ref.key}")
        return params, cfg, manifest

    def _manifest(self, key: str) -> Dict[str, Any]:
        """The checkpoint manifest for an indexed artifact (no weight load)."""
        with open(os.path.join(self._index[key]["dir"], "manifest.json")) as f:
            return json.load(f)

    # ----------------------- ModelArtifact API ----------------------- #
    def publish_artifact(self, artifact):
        """Publish a ``ModelArtifact``; returns it with its registry ``ref``
        and manifest filled in."""
        ref = self.publish(artifact.name, artifact.version, artifact.params,
                           artifact.config, artifact.variant,
                           metrics=artifact.metrics or None)
        artifact.ref = ref
        artifact.manifest = self._manifest(ref.key)
        return artifact

    def publish_variants(self, model, specs=None, calib_data=None,
                         evaluate=None) -> Dict[str, Any]:
        """Build and publish every variant of ``model`` (an fp32
        ``ModelArtifact``) declared by ``specs`` (default: the paper's
        fp32 / dynamic / static trio). ``calib_data``: input batches, needed
        by static specs. ``evaluate``: optional ``fn(params, cfg) ->
        metrics`` recorded per variant in the index."""
        from repro_torch.api.variants import DEFAULT_VARIANTS

        specs = DEFAULT_VARIANTS if specs is None else specs
        calib_data = list(calib_data) if calib_data is not None else None
        out: Dict[str, Any] = {}
        for spec in specs:
            vparams, _info = spec.build(model.params, model.config,
                                        calib_data=calib_data)
            metrics = evaluate(vparams, model.config) if evaluate else {}
            artifact = self.publish_artifact(
                model.with_variant(spec.variant, vparams, metrics))
            if spec.draft_of:
                # the draft relation, for Deployment.spec_config
                self._index[artifact.ref.key]["draft_of"] = spec.draft_of
                self._save_index()
            out[spec.variant] = artifact
        return out

    def draft_for(self, name: str, version: str,
                  target_variant: str = "fp32") -> Optional[ArtifactRef]:
        """The variant published with ``draft_of == target_variant`` for
        this model version (its speculative-decoding draft), or None."""
        for key, entry in self._index.items():
            n, v, variant = key.split(":")
            if (n == name and v == version
                    and entry.get("draft_of") == target_variant):
                return ArtifactRef(name, version, variant,
                                   entry["sha256"], entry["size_bytes"])
        return None

    def fetch_artifact(self, ref: ArtifactRef, device: DeviceLike = None):
        """Integrity-checked load as a ``ModelArtifact`` on ``device``."""
        from repro_torch.api.artifact import ModelArtifact

        params, cfg, manifest = self.fetch(ref, device)
        return ModelArtifact(
            name=ref.name, version=ref.version, params=params, config=cfg,
            variant=ref.variant, manifest=manifest,
            metrics=manifest.get("meta", {}).get("metrics", {}), ref=ref)

    def get(self, name: str, version: Optional[str] = None,
            variant: str = "fp32", device: DeviceLike = None):
        """Fetch by coordinates (version None = latest) as a ModelArtifact."""
        return self.fetch_artifact(self.ref(name, version, variant), device)

    def versions(self, name: str) -> List[str]:
        """Versions ordered oldest -> newest by first publication time (a
        lexicographic sort would order v10 before v9)."""
        first_seen: Dict[str, float] = {}
        for key, entry in self._index.items():
            n, v, _ = key.split(":")
            if n == name:
                t = entry.get("published_at", 0.0)
                first_seen[v] = min(first_seen.get(v, t), t)
        return sorted(first_seen, key=lambda v: (first_seen[v], v))

    def variants(self, name: str, version: str) -> List[str]:
        return sorted(key.split(":")[2] for key in self._index
                      if key.startswith(f"{name}:{version}:"))

    def ref(self, name: str, version: Optional[str] = None,
            variant: str = "fp32") -> ArtifactRef:
        if version is None:
            vs = self.versions(name)
            if not vs:
                raise KeyError(f"no versions for {name}")
            version = vs[-1]
        key = f"{name}:{version}:{variant}"
        entry = self._index.get(key)
        if entry is None:
            published = self.variants(name, version)
            raise KeyError(
                f"no artifact {key!r}: variant {variant!r} is not published "
                f"for {name}:{version} (published variants: "
                f"{', '.join(published) if published else 'none'})")
        return ArtifactRef(name, version, variant,
                           entry["sha256"], entry["size_bytes"])
