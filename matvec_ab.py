#!/usr/bin/env python3
"""Time the checkout's ``population_noise_matvec`` or ``weighted_noise_sum``
kernel against other versions of its source on one CUDA card, in
alternating order.

    python3 matvec_ab.py OTHER.cu [MORE.cu ...] [--kernel reduction] [--rounds 2]

``OTHER.cu`` is a whole ``noise_kernels.cu``: an older commit's (``git show
REV:estorch_tpu_torch/ops/csrc/noise_kernels.cu``) or the checkout's with a
line changed.  All are built with the flags of
``estorch_tpu_torch/ops/_build.py``, at the same time, into the git-ignored
``build/matvec_ab/``; each is checked against the plain PyTorch version,
then timed warm and cold with ``chip_smoke.py``'s timers (device time only),
in the order A B B A (A the checkout; with several others A B C C B A) for
each round.

- ``--kernel matvec`` (the default): the Pendulum MLP64x64 layers and the
  BIG (256, 256) layer, n = 4096, mirrored offsets.
- ``--kernel reduction``: every shape ``chip_smoke.py`` phase 2 times the
  update reduction at (the cell, (g), (i), pong84, (m), (z), (n)), float32
  and float64 output.  A source whose launcher takes a partials buffer (the
  two-pass kernel before the redesign) is called with one, a later one with
  its (n, 2) int64 scratch.  Each library's float32 entries that are not
  bit-equal to the plain version are counted.

Prints one line per shape and one JSON line with every reading, then the
card's name and power limit.  Imports nothing of JAX.
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
    """nvcc for every source at once; the library path of each.  Prints
    ptxas's register and spill lines for each source's kernels."""
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
        for line in err.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"  ptxas {name}: {line.strip()}")
    return libs


def turns(names: list[str], rounds: int) -> list[str]:
    """A B B A for each round (A B C C B A with two others)."""
    return (names + names[::-1]) * rounds


def report(med: dict, names: list[str], extra_rows: list = ()) -> None:
    print(f"medians, ms ({' / '.join(n + ' over checkout' for n in names[1:])}):")
    for label, m in list(med.items()) + list(extra_rows):
        a = m["checkout"]
        parts = []
        for key in ("ms", "cold_ms"):
            vals = ", ".join(f"{m[n][key]:.4f} ({m[n][key] / a[key]:.3f})" for n in names[1:])
            parts.append(f"{'warm' if key == 'ms' else 'cold'} {a[key]:.4f} vs {vals}")
        print(f"  {label:22s} " + "; ".join(parts))


def run_matvec(torch, libs_paths: dict[str, str], rounds: int, card: str) -> None:
    import ctypes

    from estorch_tpu_torch import MLPPolicy, Pendulum
    from estorch_tpu_torch.ops import _build
    from estorch_tpu_torch.ops import noise_kernels as nk
    from estorch_tpu_torch.ops.noise import make_noise_table, member_offsets, sample_pair_offsets
    from estorch_tpu_torch.ops.params import make_param_spec

    libs = {}
    for name, path in libs_paths.items():
        fn = ctypes.CDLL(path).estorch_population_noise_matvec
        fn.argtypes = _build.SIGNATURES["estorch_population_noise_matvec"]
        fn.restype = ctypes.c_int
        libs[name] = fn
    names = list(libs)

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
    for name in turns(names, rounds):
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
    report(med, names, [("one env step", step)])
    print(json.dumps({"kernel": "matvec", "medians": med, "step": step, "readings": times}))
    print(card)


class Reduction:
    """One library's ``weighted_noise_sum`` entry points, called as the
    wrapper calls them, with the scratch each takes: the two-pass source's
    (ceil(n / 64), dim) float64 partials, or the later source's (n, 2) int64
    rows."""

    def __init__(self, path: str):
        import ctypes

        lib = ctypes.CDLL(path)
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        self.rows_per_chunk = None
        if hasattr(lib, "estorch_weighted_sum_rows_per_chunk"):
            lib.estorch_weighted_sum_rows_per_chunk.restype = i
            self.rows_per_chunk = lib.estorch_weighted_sum_rows_per_chunk()
        args = [p, i64, p, p, i, i, p, p, p]  # the scratch: partials, or the rows
        self.fns = {}
        for out_bits, sym in ((32, "estorch_weighted_noise_sum"),
                              (64, "estorch_weighted_noise_sum_f64")):
            fn = getattr(lib, sym)
            fn.argtypes, fn.restype = args, i
            self.fns[out_bits] = fn
        self._mapping = None
        if hasattr(lib, "estorch_weighted_sum_mapping"):
            self._mapping = lib.estorch_weighted_sum_mapping
            self._mapping.argtypes, self._mapping.restype = [i, i, i64, p], i

    def mapping(self, n: int, dim: int, table_size: int):
        """The launcher's split of a shape, as ``noise_kernels.
        weighted_noise_sum_mapping`` reads it; None for a source without."""
        import ctypes

        if self._mapping is None:
            return None
        m = (ctypes.c_int * 4)()
        self._mapping(n, dim, table_size, ctypes.addressof(m))
        return {"cols": m[0], "row_groups": m[3], "cluster": m[1], "sorted": bool(m[2])}

    def prepare(self, torch, case: dict) -> dict:
        """Output buffers and the scratch for one shape, made once."""
        n, dim, dev = case["n"], case["dim"], case["table"].device
        bufs = {32: torch.empty(dim, device=dev),
                64: torch.empty(dim, dtype=torch.float64, device=dev)}
        if self.rows_per_chunk:
            chunks = -(-n // self.rows_per_chunk)
            bufs["scratch"] = torch.empty((chunks, dim), dtype=torch.float64, device=dev)
        else:
            bufs["scratch"] = torch.empty((n, 2), dtype=torch.int64, device=dev)
        return bufs

    def launch(self, torch, case: dict, bufs: dict, out_bits: int):
        t = case["table"]
        err = self.fns[out_bits](t.data_ptr(), t.numel(), case["offs"].data_ptr(),
                                 case["w"].data_ptr(), case["n"], case["dim"],
                                 bufs["scratch"].data_ptr(), bufs[out_bits].data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            chip_smoke.fail(f"weighted_noise_sum launch failed: CUDA error {err}")
        return bufs[out_bits]


def reduction_cases(torch) -> list[dict]:
    """The update reduction's shapes of ``chip_smoke.py`` phase 2: rows,
    dim and table of each, pair offsets (the fold's member rows share a
    pair's offset) and weights in [-1, 1] from a seed."""
    import numpy as np

    from estorch_tpu_torch import Cheetah2D, MLPPolicy, NatureCNN, Pendulum, RecurrentPolicy
    from estorch_tpu_torch import SyntheticEnv
    from estorch_tpu_torch.ops.noise import make_noise_table, sample_pair_offsets
    from estorch_tpu_torch.ops.params import make_param_spec

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(19)

    def dim_of(module, obs):
        return make_param_spec(module.init_params(obs, gen))[1].dim

    table = make_noise_table(chip_smoke.TABLE_SIZE, seed=0, device=dev).data
    pong_table = make_noise_table(chip_smoke.PONG_TABLE, seed=0, device=dev).data
    host_table = chip_smoke.host_table(torch)
    pop = chip_smoke.POPULATION
    shapes = [
        ("cell", table, pop // 2, dim_of(MLPPolicy(**chip_smoke.POLICY), Pendulum().obs_dim)),
        ("g cheetah", table, 1024 // 2, dim_of(
            MLPPolicy(action_dim=Cheetah2D().action_dim, hidden=(64, 64), discrete=False),
            Cheetah2D().obs_dim)),
        ("i synthetic", table, pop // 2, dim_of(
            MLPPolicy(action_dim=SyntheticEnv().action_dim, hidden=(256, 256), discrete=False),
            SyntheticEnv().obs_dim)),
        ("pong84", pong_table, chip_smoke.PONG_PAIRS, dim_of(NatureCNN(3), (84, 84, 4))),
        ("m host", host_table, chip_smoke.HOST_PAIRS, chip_smoke.HOST_DIM),
        ("z fold", host_table, chip_smoke.HOST_POPULATION, chip_smoke.HOST_DIM),
        ("n recurrent", table, chip_smoke.REC_PAIRS,
         dim_of(RecurrentPolicy(**chip_smoke.REC_POLICY), Pendulum().obs_dim)),
    ]
    cases = []
    for label, t, n, dim in shapes:
        if label == "z fold":  # a mirrored pair's two member rows share their offset
            offs = sample_pair_offsets(gen, n // 2, t.numel(), dim).repeat_interleave(2)
        else:
            offs = sample_pair_offsets(gen, n, t.numel(), dim)
        w = torch.from_numpy(np.random.default_rng(n + dim).uniform(-1, 1, n).astype(np.float32))
        cases.append({"label": label, "table": t, "n": n, "dim": dim, "offs_cpu": offs,
                      "offs": offs.to(dev), "w": w.to(dev)})
    return cases


def run_reduction(torch, libs_paths: dict[str, str], rounds: int, card: str) -> None:
    from estorch_tpu_torch.ops import noise_kernels as nk

    libs = {name: Reduction(path) for name, path in libs_paths.items()}
    names = list(libs)
    bw = chip_smoke.card_peaks(torch.cuda.get_device_name(0))[0]
    cases = reduction_cases(torch)
    bufs = {c["label"]: {name: lib.prepare(torch, c) for name, lib in libs.items()}
            for c in cases}
    checks = {}
    for c in cases:
        want = nk.weighted_noise_sum_plain(c["table"], c["offs"], c["w"], c["dim"])
        want64 = nk.weighted_noise_sum_plain(c["table"], c["offs"], c["w"], c["dim"],
                                             out_dtype=torch.float64)
        c["bound_ms"] = 4 * (chip_smoke.union_floats(c["offs_cpu"], c["dim"]) + 2 * c["n"]
                             + c["dim"]) / bw * 1e3
        c["read_mb"] = 4 * c["n"] * c["dim"] / 1e6
        row = checks.setdefault(c["label"], {})
        for name, lib in libs.items():
            got = lib.launch(torch, c, bufs[c["label"]][name], 32).clone()
            got64 = lib.launch(torch, c, bufs[c["label"]][name], 64).clone()
            again = lib.launch(torch, c, bufs[c["label"]][name], 32)
            torch.cuda.synchronize()
            mism = int((got.view(torch.int32) != want.view(torch.int32)).sum())
            err64 = float((got64 - want64).abs().max())
            rounded = bool(torch.equal(got64.float(), got))
            same = bool(torch.equal(got, again))
            mapping = lib.mapping(c["n"], c["dim"], c["table"].numel())
            row[name] = {"not_bit_equal": mism, "f64_max_abs_err": err64,
                         "f64_rounds_to_f32": rounded, "repeat_bit_identical": same,
                         "mapping": mapping}
            print(f"{c['label']:12s} n={c['n']} dim={c['dim']} {name}: {mism} float32 entries "
                  f"not bit-equal to the plain version; float64 max |err| {err64:.3g}, "
                  f"rounds to the float32 output: {rounded}; two launches bit-identical: "
                  f"{same}; mapping {mapping}")
            # tolerance as chip_smoke.py phase 2's: float64 sums rounded once
            if not (torch.allclose(got, want, rtol=1e-4, atol=1e-3) and err64 <= 1e-9
                    and rounded and same):
                chip_smoke.fail(f"{name} at {c['label']}: does not hold against the plain version")

    flush = torch.empty(chip_smoke.L2_FLUSH_BYTES // 4, dtype=torch.float32,
                        device=torch.device("cuda"))
    keys = [(c["label"], bits) for c in cases for bits in (32, 64)]
    times = {f"{label} f{bits}": {name: {"ms": [], "cold_ms": []} for name in libs}
             for label, bits in keys}
    for name in turns(names, rounds):
        lib = libs[name]
        for c in cases:
            for bits in (32, 64):
                def kernel(lib=lib, c=c, bits=bits, name=name):
                    return lib.launch(torch, c, bufs[c["label"]][name], bits)

                t = times[f"{c['label']} f{bits}"][name]
                t["ms"].append(chip_smoke.time_ms(torch, kernel))
                t["cold_ms"].append(chip_smoke.time_cold_ms(torch, kernel, flush))

    med = {key: {name: {k: statistics.median(v) for k, v in t.items()} for name, t in by.items()}
           for key, by in times.items()}
    for c in cases:
        print(f"{c['label']:12s} n={c['n']} dim={c['dim']}: bound {c['bound_ms']:.4f} ms "
              f"(distinct bytes at {bw / 1e12:.2f} TB/s), {c['read_mb']:.1f} MB of row reads")
    report(med, names)
    print(json.dumps({"kernel": "reduction", "medians": med, "checks": checks,
                      "shapes": {c["label"]: {"n": c["n"], "dim": c["dim"],
                                              "table": c["table"].numel(),
                                              "bound_ms": c["bound_ms"]} for c in cases},
                      "readings": times}))
    print(card)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", nargs="+", help="other noise_kernels.cu files to time against "
                                              "the checkout's")
    ap.add_argument("--kernel", choices=("matvec", "reduction"), default="matvec")
    ap.add_argument("--rounds", type=int, default=2, help="rounds of A B B A")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("torch.cuda.is_available() is False: this script needs a CUDA card")
    from estorch_tpu_torch.ops import _build

    card = chip_smoke.card_line()
    sources = {"checkout": str(_build.SOURCES[0])}
    for path in args.others:
        name = os.path.splitext(os.path.basename(path))[0]
        if name in sources:
            chip_smoke.fail(f"two sources named {name}")
        sources[name] = os.path.abspath(path)
    for name, path in sources.items():
        print(f"{name}: {path}")
    libs = build(sources)
    run = run_matvec if args.kernel == "matvec" else run_reduction
    run(torch, libs, args.rounds, card)


if __name__ == "__main__":
    main()
