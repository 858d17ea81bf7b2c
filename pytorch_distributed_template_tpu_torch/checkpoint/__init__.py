"""Serving artifacts: params-only state dicts with checksum manifests."""
from .serving import (
    ArtifactCorrupt, load_serving_meta, restore_serving_params,
    save_serving_params, verify_artifact_manifest, write_artifact_manifest,
)

__all__ = ["ArtifactCorrupt", "load_serving_meta", "restore_serving_params",
           "save_serving_params", "verify_artifact_manifest",
           "write_artifact_manifest"]
