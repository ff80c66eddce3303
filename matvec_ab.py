#!/usr/bin/env python3
"""Time the checkout's ``population_noise_matvec`` kernel against another
version of its source on one CUDA card, in alternating order.

    python3 matvec_ab.py OTHER.cu [--rounds 2]

``OTHER.cu`` is a whole ``noise_kernels.cu`` with the same C interface: an
older commit's (``git show REV:estorch_tpu_torch/ops/csrc/noise_kernels.cu``)
or the checkout's with a line changed.  Both are built with the flags of
``estorch_tpu_torch/ops/_build.py``, at the same time, into the git-ignored
``build/matvec_ab/``; each is checked against the plain PyTorch version,
then timed warm and cold with ``chip_smoke.py``'s timers (device time only)
at the Pendulum MLP64x64 layers and the BIG (256, 256) layer, n = 4096,
mirrored offsets, in the order A B B A for each round.  Prints one line
per layer and one JSON line with every reading, then the card's name and
power limit.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import chip_smoke  # noqa: E402  (its timers; it runs nothing on import)


def build(sources: dict[str, str]) -> dict[str, str]:
    """nvcc for every source at once; the library path of each."""
    from estorch_tpu_torch.ops import _build

    out_dir = os.path.join(HERE, "build", "matvec_ab")
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs, libs = {}, {}
    for name, src in sources.items():
        libs[name] = os.path.join(out_dir, f"{name}.so")
        procs[name] = subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-o", libs[name], src],
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=_build.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            chip_smoke.fail(f"nvcc {sources[name]} (exit {proc.returncode}):\n{err}")
    return libs


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", help="another noise_kernels.cu to time against the checkout's")
    ap.add_argument("--rounds", type=int, default=2, help="rounds of A B B A")
    args = ap.parse_args()

    import ctypes

    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    from estorch_tpu_torch import MLPPolicy, Pendulum
    from estorch_tpu_torch.ops import _build
    from estorch_tpu_torch.ops import noise_kernels as nk
    from estorch_tpu_torch.ops.noise import make_noise_table, member_offsets, sample_pair_offsets
    from estorch_tpu_torch.ops.params import make_param_spec

    card = chip_smoke.card_line()
    sources = {"checkout": str(_build.SOURCES[0]), "other": os.path.abspath(args.other)}
    libs = {}
    for name, path in build(sources).items():
        lib = ctypes.CDLL(path)
        fn = lib.estorch_population_noise_matvec
        fn.argtypes = _build.SIGNATURES["estorch_population_noise_matvec"]
        fn.restype = ctypes.c_int
        libs[name] = fn

    dev = torch.device("cuda")
    table = make_noise_table(chip_smoke.TABLE_SIZE, seed=0, device=dev).data
    gen = torch.Generator().manual_seed(1)
    params = MLPPolicy(**chip_smoke.POLICY).init_params(Pendulum().obs_dim, gen)
    layer_offs = nk.flat_layer_offsets(params)
    dim = make_param_spec(params)[1].dim
    n = chip_smoke.POPULATION
    pair_offs = sample_pair_offsets(gen, n // 2, chip_smoke.TABLE_SIZE, dim)
    big_offs = sample_pair_offsets(gen, n // 2, chip_smoke.TABLE_SIZE, 256 * 256)
    cases = []
    for label, offs, lo, d, h in (
            ("dense_0", pair_offs, layer_offs["dense_0"]["kernel"], 3, 64),
            ("dense_1", pair_offs, layer_offs["dense_1"]["kernel"], 64, 64),
            ("head", pair_offs, layer_offs["head"]["kernel"], 64, 1),
            ("big dense_1", big_offs, 0, 256, 256)):
        x = torch.randn((n, d), generator=gen)
        cases.append({"layer": label, "d": d, "h": h, "lo": lo,
                      "offs": member_offsets(offs).to(dev),
                      "c": (0.05 * torch.tensor([1.0, -1.0]).repeat(n // 2)).to(dev),
                      "x": (2 * x if d < 8 else torch.tanh(x)).to(dev),
                      "y": torch.empty((n, h), device=dev)})

    def launch(fn, case):
        err = fn(table.data_ptr(), table.numel(), case["offs"].data_ptr(), case["c"].data_ptr(),
                 case["x"].data_ptr(), n, case["d"], case["h"], case["lo"],
                 case["y"].data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            chip_smoke.fail(f"launch failed: CUDA error {err}")
        return case["y"]

    # Tolerance: float32 dot products of d <= 256 terms in another order.
    for case in cases:
        want = nk.population_noise_matvec_plain(table, case["offs"], case["c"], case["x"],
                                                case["lo"], case["d"], case["h"])
        for name, fn in libs.items():
            got = launch(fn, case)
            torch.cuda.synchronize()
            if not torch.allclose(got, want, rtol=1e-4, atol=1e-4):
                chip_smoke.fail(f"{name} ({case['d']}, {case['h']}): max |err| "
                                f"{float((got - want).abs().max()):g}")

    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    times = {c["layer"]: {name: {"ms": [], "cold_ms": []} for name in libs} for c in cases}
    for name in ["checkout", "other", "other", "checkout"] * args.rounds:
        for case in cases:
            def kernel(fn=libs[name], case=case):
                return launch(fn, case)

            times[case["layer"]][name]["ms"].append(chip_smoke.time_ms(torch, kernel))
            times[case["layer"]][name]["cold_ms"].append(
                chip_smoke.time_cold_ms(torch, kernel, flush))

    med = {layer: {name: {k: statistics.median(v) for k, v in t.items()} for name, t in by.items()}
           for layer, by in times.items()}
    step = {name: {k: sum(med[layer][name][k] for layer in ("dense_0", "dense_1", "head"))
                   for k in ("ms", "cold_ms")} for name in libs}
    print(f"checkout: {sources['checkout']}\nother:    {sources['other']}")
    print(f"medians of {2 * args.rounds} readings each, ms (other / checkout):")
    for label, m in list(med.items()) + [("one env step", step)]:
        a, b = m["checkout"], m["other"]
        print(f"  {label:13s} warm {a['ms']:.4f} vs {b['ms']:.4f} ({b['ms'] / a['ms']:.3f}), "
              f"cold {a['cold_ms']:.4f} vs {b['cold_ms']:.4f} "
              f"({b['cold_ms'] / a['cold_ms']:.3f})")
    print(json.dumps({"medians": med, "step": step, "readings": times}))
    print(card)


if __name__ == "__main__":
    main()
