"""Params-only serving artifacts: the port of the serving half of the JAX
package's ``checkpoint/manager.py``.

An artifact is a directory ``<out>/model/`` holding ``params.pt`` (a torch
state dict), a ``model.meta.json`` sidecar carrying ``params_only: true``,
and a ``model.manifest.json`` sha256 manifest over the directory's files.
Restoring verifies the manifest first and refuses loudly on any mismatch:
serving garbage weights is the one failure nothing downstream catches.
The meta records the model's ``tp_geometry`` (``parallel.tp.
model_geometry``), and :func:`check_artifact_tp_geometry` refuses a
tensor-parallel degree that geometry cannot shard before a weight is read.
The ``ckpt_corrupt`` fault (resilience/faults.py) fires in
:func:`verify_artifact_manifest`, once per verification.
"""
from __future__ import annotations

import hashlib
import json
import logging
from pathlib import Path
from typing import Optional

import torch

from ..resilience import faults

logger = logging.getLogger(__name__)

MANIFEST_SUFFIX = ".manifest.json"
PARAMS_FILE = "params.pt"


class ArtifactCorrupt(RuntimeError):
    """A serving artifact failed its manifest checksum; carries the failing
    file(s) in the message."""


def _artifact_digests(path: Path) -> dict:
    """``{relpath: {"sha256", "bytes"}}`` over every regular file in the
    artifact tree, sorted for a stable manifest."""
    out = {}
    for f in sorted(p for p in path.rglob("*") if p.is_file()):
        h = hashlib.sha256()
        with open(f, "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 24), b""):
                h.update(chunk)
        out[str(f.relative_to(path))] = {
            "sha256": h.hexdigest(), "bytes": f.stat().st_size}
    return out


def write_artifact_manifest(path) -> Path:
    """Write the ``<name>.manifest.json`` checksum sidecar."""
    path = Path(path).resolve()
    manifest = {"files": _artifact_digests(path), "algo": "sha256"}
    mpath = path.parent / f"{path.name}{MANIFEST_SUFFIX}"
    mpath.write_text(json.dumps(manifest, indent=2))
    return mpath


def verify_artifact_manifest(path) -> bool:
    """Re-hash the artifact tree against its manifest. False when there is
    no manifest; :class:`ArtifactCorrupt` on any missing, extra or changed
    file."""
    path = Path(path).resolve()
    mpath = path.parent / f"{path.name}{MANIFEST_SUFFIX}"
    if not mpath.exists():
        return False
    want = json.loads(mpath.read_text()).get("files") or {}
    got = _artifact_digests(path)
    spec = faults.on_artifact_load()
    if spec is not None and got:
        # the ckpt_corrupt fault perturbs the OBSERVED digest of the first
        # entry: the refusal path runs without destroying the artifact
        first = sorted(got)[0]
        got[first] = dict(got[first], sha256="0" * 64)
        logger.warning("fault ckpt_corrupt: perturbed digest of %s (%s)",
                       first, spec.describe())
    bad = []
    for rel, meta in want.items():
        have = got.get(rel)
        if have is None:
            bad.append(f"{rel}: MISSING")
        elif have["sha256"] != meta["sha256"]:
            bad.append(f"{rel}: sha256 {have['sha256'][:12]}... != "
                       f"manifest {meta['sha256'][:12]}...")
        elif have["bytes"] != meta["bytes"]:
            bad.append(f"{rel}: {have['bytes']}B != manifest "
                       f"{meta['bytes']}B")
    extra = sorted(set(got) - set(want))
    if extra:
        bad.append(f"unmanifested files: {extra}")
    if bad:
        raise ArtifactCorrupt(
            f"serving artifact {path} FAILED its checksum manifest — "
            f"REFUSING to serve possibly-garbage weights:\n  "
            + "\n  ".join(bad))
    logger.info("artifact manifest verified: %s (%d files)", path,
                len(want))
    return True


def save_serving_params(path, state_dict: dict, meta: dict) -> Path:
    """Write ``state_dict`` as a params-only artifact at ``path`` plus its
    meta sidecar and checksum manifest."""
    path = Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    torch.save(state_dict, path / PARAMS_FILE)
    meta = dict(meta, params_only=True)
    (path.parent / f"{path.name}.meta.json").write_text(
        json.dumps(meta, indent=2))
    write_artifact_manifest(path)
    logger.info("Saved serving params: %s", path)
    return path


def load_serving_meta(path) -> Optional[dict]:
    """The artifact's sidecar iff ``path`` is a params-only serving
    artifact, else None."""
    path = Path(path)
    cand = path.parent / f"{path.name}.meta.json"
    if not cand.exists():
        return None
    meta = json.loads(cand.read_text())
    return meta if meta.get("params_only") else None


def check_artifact_tp_geometry(path, tp: int) -> None:
    """Refuse a tensor-parallel degree ``tp`` the artifact's recorded
    ``tp_geometry`` cannot shard, naming every dimension it does not
    divide (JAX's ``check_artifact_tp_geometry``). Artifacts without a
    recorded geometry pass: the model-level check
    (``parallel.tp.validate_tp_geometry``) still guards them."""
    tp = int(tp)
    if tp <= 1:
        return
    geom = (load_serving_meta(path) or {}).get("tp_geometry")
    if not geom:
        return
    bad = [f"{k}={v}" for k, v in sorted(geom.items())
           if isinstance(v, int) and v and v % tp]
    if bad:
        raise ValueError(
            f"artifact {path} cannot serve at tensor_parallel={tp}: "
            f"recorded geometry {', '.join(bad)} not divisible "
            "(re-produce the artifact with a compatible shape, or pick a "
            "tp dividing every recorded dimension)")


def restore_serving_params(path, device, verify: bool = True) -> dict:
    """Verify the manifest (unless the caller already did: a TP group's
    ranks, after the serving process), then load the state dict
    memory-mapped onto ``device`` (``"cpu"`` keeps it mapped: only the
    parts a caller copies are read)."""
    if verify:
        verify_artifact_manifest(path)
    return torch.load(Path(path).resolve() / PARAMS_FILE,
                      map_location=device, weights_only=True, mmap=True)
