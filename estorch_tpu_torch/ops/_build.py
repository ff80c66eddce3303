"""Build and load the port's CUDA kernels.

The sources under ``ops/csrc/`` are compiled at first use with ``nvcc`` for
Hopper (``sm_90a``) into a shared library with a plain C interface, which
is loaded with ``ctypes``.  The library is cached under
``build/estorch_tpu_torch/`` at the repository root, named by a hash of the
sources and flags, so a changed source is rebuilt and an unchanged one is
not.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "noise_kernels.cu",)
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "estorch_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
NVCC_TIMEOUT_S = 600

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
SIGNATURES = {
    "estorch_weighted_sum_rows_per_chunk": [],
    # table, table_size, offsets, weights, n, dim, partials, out, stream
    "estorch_weighted_noise_sum": [_P, _I64, _P, _P, _I, _I, _P, _P, _P],
    # table, table_size, offsets, c, x, n, d, h, layer_offset, y, stream
    "estorch_population_noise_matvec": [_P, _I64, _P, _P, _P, _I, _I, _I, _I64, _P, _P],
}

# what the last build in this process did: seconds, nvcc's stderr
# (-Xptxas -v register/spill report) and the library path
build_info: dict = {}
_library = None


def find_nvcc() -> str:
    candidates = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                  shutil.which("nvcc")]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH); the port's CUDA kernels are built from ops/csrc at first use"
    )


def library_path() -> Path:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libestorch_noise_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the hashed library already exists."""
    out = library_path()
    if out.exists():
        build_info.update(seconds=0.0, log="(cached)", path=str(out))
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=NVCC_TIMEOUT_S)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"nvcc timed out after {NVCC_TIMEOUT_S}s: {' '.join(cmd)}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    build_info.update(seconds=time.perf_counter() - t0, log=proc.stderr, path=str(out))
    return out


def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first call and kept for the process."""
    global _library
    if _library is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _library = lib
    return _library
