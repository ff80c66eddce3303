"""Platform rooflines: the denominators that make achieved rates honest.

Counterpart of ``estorch_tpu/obs/profile/roofline.py`` (NumPy and stdlib
only), with the card added.  ``obs profile`` divides per-phase achieved
FLOP/s and bytes/s by a platform peak:

* on an NVIDIA H100 SXM the peaks are data-sheet facts: 67 TFLOP/s of
  float32 outside the tensor cores and 3.35 TB/s of HBM3 — the port's
  compute is float32, and these are the numbers its kernel bounds use;
* on a TPU v5e, the JAX package's data-sheet peaks (kept so the port can
  profile a JAX run's JSONL);
* on the CPU there is no such number worth quoting, so the roofline is
  MEASURED: a short GEMM (NumPy's BLAS) and a large memcpy, tagged
  ``cpu_calibrated`` so nobody mistakes a fraction of this host's GEMM
  rate for a share of accelerator silicon.

Any other card, or a GPU whose kind is unknown, gets ``None`` peaks and no
basis: rates only.  A card's rate is never divided by the host's
calibrated CPU peaks.
"""

from __future__ import annotations

import time

import numpy as np

# TPU v5e per-chip datasheet peaks: bf16 MXU FLOP/s and HBM bandwidth
V5E_BF16_PEAK_FLOPS = 197e12
V5E_HBM_BYTES_PER_S = 819e9

TPU_V5E_ROOFLINE = {
    "platform": "tpu",
    "basis": "tpu_v5e_bf16_peak",
    "peak_flops_per_s": V5E_BF16_PEAK_FLOPS,
    "peak_bytes_per_s": V5E_HBM_BYTES_PER_S,
}

# NVIDIA H100 SXM data-sheet peaks (dense, at the 700 W limit): float32
# outside the tensor cores, and HBM3 bandwidth
H100_SXM_F32_PEAK_FLOPS = 67e12
H100_SXM_HBM_BYTES_PER_S = 3.35e12

H100_SXM_ROOFLINE = {
    "platform": "gpu",
    "basis": "h100_sxm_datasheet_f32",
    "peak_flops_per_s": H100_SXM_F32_PEAK_FLOPS,
    "peak_bytes_per_s": H100_SXM_HBM_BYTES_PER_S,
}

_CPU_CACHE: dict | None = None


def is_h100_sxm(kind: str | None) -> bool:
    """Whether a card's name (``torch.cuda.get_device_name``) is an H100
    SXM part: "H100" and "HBM3" or "SXM" (``NVIDIA H100 80GB HBM3``).  The
    PCIe and NVL parts have other peaks and are not matched."""
    k = str(kind or "").upper()
    return "H100" in k and ("HBM3" in k or "SXM" in k)


def measure_cpu_roofline(budget_s: float = 0.25, gemm_n: int = 384,
                         copy_mb: int = 32) -> dict:
    """Measured CPU roofline: best-of-repeats GEMM FLOP/s + memcpy bytes/s.

    Best-of (not median): the roofline is the *ceiling* this host can
    reach, and on a loaded shared core every slow repeat is interference,
    not capability.  ``budget_s`` bounds each of the two measurements.
    """
    n = int(gemm_n)
    a = np.random.default_rng(0).standard_normal((n, n)).astype(np.float32)
    b = np.random.default_rng(1).standard_normal((n, n)).astype(np.float32)
    a @ b  # warm-up: BLAS thread pool + page faults outside the clock
    flops_per_mm = 2.0 * n * n * n
    best_flops = 0.0
    deadline = time.perf_counter() + float(budget_s)
    while time.perf_counter() < deadline:
        t0 = time.perf_counter()
        a @ b
        dt = time.perf_counter() - t0
        if dt > 0:
            best_flops = max(best_flops, flops_per_mm / dt)

    src = np.zeros(int(copy_mb) * 2**20 // 4, np.float32)
    dst = np.empty_like(src)
    np.copyto(dst, src)  # warm-up
    moved = 2.0 * src.nbytes  # one read + one write per copy
    best_bw = 0.0
    deadline = time.perf_counter() + float(budget_s)
    while time.perf_counter() < deadline:
        t0 = time.perf_counter()
        np.copyto(dst, src)
        dt = time.perf_counter() - t0
        if dt > 0:
            best_bw = max(best_bw, moved / dt)
    return {
        "platform": "cpu",
        "basis": "cpu_calibrated",
        "peak_flops_per_s": best_flops,
        "peak_bytes_per_s": best_bw,
        "gemm_n": n,
        "copy_mb": int(copy_mb),
    }


def platform_roofline(platform: str, measure: bool = True,
                      kind: str | None = None) -> dict:
    """The roofline for ``platform``: data sheet on TPU and on an H100 SXM
    card (``platform="gpu"`` with ``kind`` naming one, see
    :func:`is_h100_sxm`), measured on CPU (cached per process — the
    calibration GEMM should run once, not per phase).  ``measure=False``
    on CPU returns None-peaks with the ``cpu_calibrated`` basis, for
    callers that only want the tag.

    Any OTHER platform or card gets None-peaks and no basis: the host
    GEMM calibration measures this host's CPU, and dividing an
    accelerator's rate by it would produce exactly the dishonest
    cross-silicon number the basis tag exists to prevent — rates-only
    reporting is the honest answer until that card gets its own
    denominator."""
    global _CPU_CACHE
    if platform == "tpu":
        return dict(TPU_V5E_ROOFLINE)
    if platform == "gpu" and is_h100_sxm(kind):
        return dict(H100_SXM_ROOFLINE)
    if platform != "cpu":
        return {"platform": str(platform), "basis": None,
                "peak_flops_per_s": None, "peak_bytes_per_s": None}
    if not measure:
        return {"platform": "cpu", "basis": "cpu_calibrated",
                "peak_flops_per_s": None, "peak_bytes_per_s": None}
    if _CPU_CACHE is None:
        _CPU_CACHE = measure_cpu_roofline()
    return dict(_CPU_CACHE)
