"""A bundle's structural validation, torch-free.

Split from ``bundle.py`` and ``warm.py`` (which re-export every name
here) so that a process that must not import torch — ``python -m
estorch_tpu_torch.doctor --bundle DIR``, an operator's check of a copied
artifact — can validate a bundle: the manifest's schema and keys, every
checksummed file's sha256, the warm block's format and ladder, and the
payload's parameter count, with the standard library and NumPy only.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

BUNDLE_SCHEMA = 1
MANIFEST_NAME = "MANIFEST.json"
ARRAYS_NAME = "arrays.npz"
WARM_FORMAT = "torch_eager"


class BundleError(ValueError):
    """Malformed, corrupt, or incompatible bundle."""


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def validate_warm_block(manifest: dict) -> None:
    """Structural validation of the manifest's warm block (no device
    touched): a known format, the platform facts present, and the bucket
    ladder COMPLETE — verified + excluded buckets covering exactly the
    ladder of its recorded ``max_batch``.  A version or platform mismatch
    is NOT an error here — ``warm.install_warmth`` reports it."""
    warm = manifest.get("warm")
    if warm is None:
        return
    if not isinstance(warm, dict):
        raise BundleError("manifest 'warm' block is not an object")
    if warm.get("format") != WARM_FORMAT:
        raise BundleError(
            f"warm block has unknown format {warm.get('format')!r} — "
            f"this version reads only {WARM_FORMAT!r}")
    for key in ("max_batch", "torch_version", "platform"):
        if key not in warm:
            raise BundleError(f"warm block is missing {key!r}")
    if not bool(warm.get("recurrent_only")):
        from .batcher import bucket_sizes

        try:
            ladder = set(bucket_sizes(int(warm["max_batch"])))
        except ValueError as e:
            raise BundleError(f"warm block max_batch invalid: {e}") from e
        covered = set(int(b) for b in warm.get("buckets", [])) | set(
            int(b) for b in warm.get("buckets_excluded", []))
        if covered != ladder:
            raise BundleError(
                f"warm block ladder incomplete: covers {sorted(covered)} "
                f"but max_batch {warm['max_batch']} needs {sorted(ladder)}")


def validate_bundle(path: str) -> dict:
    """Structural validation WITHOUT importing the policy module or
    touching a device.  Returns the manifest; raises :class:`BundleError`
    with the finding otherwise.
    """
    path = os.path.abspath(path)
    manifest_path = os.path.join(path, MANIFEST_NAME)
    if not os.path.isdir(path):
        raise BundleError(f"bundle path {path!r} is not a directory")
    if not os.path.exists(manifest_path):
        raise BundleError(
            f"bundle at {path!r} has no {MANIFEST_NAME} — the export never "
            "committed (crashed mid-write?) or this is not a bundle"
        )
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except ValueError as e:
        raise BundleError(f"unreadable {MANIFEST_NAME}: {e}") from e
    schema = manifest.get("schema")
    if schema != BUNDLE_SCHEMA:
        raise BundleError(
            f"bundle schema {schema!r} != supported {BUNDLE_SCHEMA} — "
            "re-export from the run that produced it"
        )
    for key in ("module", "obs_shape", "param_dim", "sha256", "version"):
        if key not in manifest:
            raise BundleError(f"{MANIFEST_NAME} is missing {key!r}")
    arrays_path = os.path.join(path, ARRAYS_NAME)
    if not os.path.exists(arrays_path):
        raise BundleError(f"bundle is missing its payload {ARRAYS_NAME}")
    sha = manifest.get("sha256")
    want = sha.get(ARRAYS_NAME) if isinstance(sha, dict) else None
    if not want:
        raise BundleError(
            f"{MANIFEST_NAME} records no checksum for {ARRAYS_NAME} — "
            "not a bundle this version can trust"
        )
    for rel, want in sorted(sha.items()):
        fpath = os.path.join(path, *rel.split("/"))
        if not os.path.exists(fpath):
            raise BundleError(f"bundle is missing checksummed file {rel!r}")
        got = _sha256_file(fpath)
        if got != want:
            raise BundleError(
                f"{rel} checksum mismatch (manifest {str(want)[:12]}…, "
                f"file {got[:12]}…) — the payload is corrupt or was "
                "modified after export"
            )
    validate_warm_block(manifest)
    with np.load(arrays_path) as z:
        if "params_flat" not in z.files:
            raise BundleError(f"{ARRAYS_NAME} has no params_flat array")
        n = int(z["params_flat"].shape[0])
    if n != int(manifest["param_dim"]):
        raise BundleError(
            f"params_flat has {n} parameters but the manifest promises "
            f"{manifest['param_dim']}"
        )
    return manifest
