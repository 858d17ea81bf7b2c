"""Checkpoints: serving artifacts (params-only state dicts with checksum
manifests) and training checkpoints (model, optimizer, counters)."""
from .manager import CheckpointManager
from .serving import (
    ArtifactCorrupt, load_serving_meta, restore_serving_params,
    save_serving_params, verify_artifact_manifest, write_artifact_manifest,
)

__all__ = ["ArtifactCorrupt", "CheckpointManager", "load_serving_meta",
           "restore_serving_params", "save_serving_params",
           "verify_artifact_manifest", "write_artifact_manifest"]
