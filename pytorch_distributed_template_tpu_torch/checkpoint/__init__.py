"""Checkpoints: serving artifacts (params-only state dicts with checksum
manifests) and training checkpoints (model, optimizer, counters, EMA;
epoch, interval and emergency saves; warm start)."""
from .manager import CheckpointManager, load_model, warm_start_params
from .serving import (
    ArtifactCorrupt, check_artifact_tp_geometry, load_serving_meta,
    restore_serving_params,
    save_serving_params, verify_artifact_manifest, write_artifact_manifest,
)

__all__ = ["ArtifactCorrupt", "CheckpointManager",
           "check_artifact_tp_geometry", "load_model",
           "load_serving_meta",
           "restore_serving_params", "save_serving_params",
           "verify_artifact_manifest", "warm_start_params",
           "write_artifact_manifest"]
