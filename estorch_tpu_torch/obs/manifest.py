"""Run manifest: the facts about a run that its JSONL cannot tell.

Counterpart of ``estorch_tpu/obs/manifest.py``: one JSON file written at
run start with the config, the versions, the devices, the git sha and the
host and pid, under the JAX package's ``schema`` and keys.  Where the JAX
package writes ``jax`` and its devices, the port writes ``torch``,
``cuda`` (torch's CUDA version, or None) and devices as ``{"id",
"platform": "gpu" | "cpu", "kind", "process_index"}``, the process index
being the rank under ``torch.distributed`` (``parallel/multihost.py``).
``ES.run_manifest()`` passes the run's device; this module never
initializes CUDA on its own.  Under a multi-rank mesh only rank 0 writes
(:func:`write_manifest` is ``leader_only``).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

from ..parallel.multihost import leader_only, process_index

MANIFEST_SCHEMA = 1


def _git_sha(cwd: str | None = None) -> str | None:
    """HEAD's sha, or None outside a repository or without git; bounded,
    so a hung VCS helper cannot block a run's start."""
    try:
        r = subprocess.run(["git", "rev-parse", "HEAD"], cwd=cwd, timeout=5.0,
                           capture_output=True, text=True)
    except (OSError, subprocess.TimeoutExpired):
        return None
    sha = r.stdout.strip()
    return sha if r.returncode == 0 and sha else None


def describe_device(device, index: int = 0) -> dict:
    """A torch device as a manifest entry: a card's ``kind`` is its
    ``torch.cuda.get_device_name``."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        i = torch.cuda.current_device() if device.index is None else device.index
        return {"id": int(i), "platform": "gpu", "kind": torch.cuda.get_device_name(i),
                "process_index": process_index()}
    return {"id": int(index), "platform": "cpu", "kind": "cpu",
            "process_index": process_index()}


def collect_manifest(config: dict | None = None, devices=None,
                     extra: dict | None = None) -> dict:
    """The manifest dict; ``devices`` is an iterable of torch devices (or
    device strings) the run already uses."""
    import socket

    man: dict = {
        "schema": MANIFEST_SCHEMA,
        "created_unix": time.time(),
        "argv": list(sys.argv),
        "python": sys.version.split()[0],
        "hostname": socket.gethostname(),
        "pid": os.getpid(),
        "git_sha": _git_sha(os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))),
    }
    try:
        import torch

        man["torch"] = torch.__version__
        man["cuda"] = torch.version.cuda
    except Exception:  # the manifest must assemble even on a broken install
        man["torch"] = man["cuda"] = None
    try:
        import numpy as np

        man["numpy"] = np.__version__
    except Exception:
        man["numpy"] = None
    if devices is not None:
        man["devices"] = [describe_device(d, i) for i, d in enumerate(devices)]
    if config is not None:
        man["config"] = config
    if extra:
        man.update(extra)
    return man


@leader_only
def write_manifest(path: str, manifest: dict) -> str:
    """Atomic write (tmp + rename); returns the absolute path (None on a
    rank other than 0)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, default=float)
    os.replace(tmp, path)
    return path


def load_manifest(path: str) -> dict:
    with open(path) as f:
        man = json.load(f)
    if man.get("schema") != MANIFEST_SCHEMA:
        raise ValueError(f"manifest schema {man.get('schema')!r} != {MANIFEST_SCHEMA} "
                         f"(file: {path})")
    return man
