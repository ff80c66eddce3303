"""The metrics that read the program's own ranges: the card's idle time split
by what the host was doing, and the launches of the rollout's env step."""

import types

import pytest
import torch

from esbench import loader, phases
from esbench import trace as tr
from esbench.tests.test_esbench_trace import MATVEC, Ev

METRICS = ("rollout_idle_pct", "boundary_idle_pct", "step_launches_per_step")


def metric(name):
    return loader.load_metric(name)


def ctx_of(events, horizon=2, chunks=1, generations=1):
    t = tr.read_events(events)
    return types.SimpleNamespace(trace=t, horizon=horizon, chunks=chunks,
                                 generations=list(range(generations)))


def rng(name, start, end, corr):
    return Ev(name, "CPU", start, end, corr=corr)


def generation():
    """One generation on one clock (no runtime calls, so the offset is 0):
    the host in sample 10–100, eval 100–600 (two env steps, each a
    forward and a step), rank 600–650, update 650–800, all inside
    dispatch 0–900; the card busy 130–290, 330–470, 620–640, 660–720."""
    return [
        Ev(tr.WINDOW, "CPU", 0, 1000),
        rng("estorch.dispatch", 0, 900, 1),
        rng("estorch.sample", 10, 100, 2),
        rng("estorch.eval", 100, 600, 3),
        rng("estorch.forward", 110, 200, 4),
        rng("estorch.step", 200, 300, 5),
        rng("estorch.forward", 300, 400, 6),
        rng("estorch.step", 400, 500, 7),
        rng("estorch.rank", 600, 650, 8),
        rng("estorch.update", 650, 800, 9),
        Ev("aten::mm", "CPU", 120, 125, corr=20),
        Ev("gemm", "CUDA", 130, 260, corr=40, linked=20),
        Ev("aten::where", "CPU", 210, 212, corr=21),
        Ev("where_kernel", "CUDA", 260, 280, corr=41, linked=21),
        Ev("aten::add_", "CPU", 220, 222, corr=22),
        Ev("add_kernel", "CUDA", 280, 290, corr=42, linked=22),
        Ev("aten::mm", "CPU", 310, 312, corr=23),
        Ev("gemm", "CUDA", 330, 450, corr=43, linked=23),
        Ev("aten::where", "CPU", 410, 412, corr=24),
        Ev("where_kernel", "CUDA", 450, 470, corr=44, linked=24),
        Ev("aten::sort", "CPU", 610, 612, corr=25),
        Ev("sort_kernel", "CUDA", 620, 640, corr=45, linked=25),
        Ev("aten::mul", "CPU", 655, 657, corr=26),
        Ev("mul_kernel", "CUDA", 660, 700, corr=46, linked=26),
        Ev("aten::copy_", "CPU", 690, 692, corr=27),
        Ev("Memcpy DtoH", "CUDA", 700, 720, corr=47, linked=27),
    ]


def test_the_idle_time_splits_by_what_the_host_was_doing():
    ctx = ctx_of(generation())
    assert ctx.trace.offset == 0
    idle = metric("device_idle_pct").read(ctx)
    rollout = metric("rollout_idle_pct").read(ctx)
    boundary = metric("boundary_idle_pct").read(ctx)
    # idle 0–130, 290–330, 470–620, 720–1000: 620 of 1000 ns
    assert idle == pytest.approx(62.0, abs=1e-9)
    # inside eval: 100–130, 290–330, 470–600
    assert rollout == pytest.approx(20.0, abs=1e-9)
    # 0–100 (dispatch, sample), 600–620 (rank), 720–1000 (update, after dispatch)
    assert boundary == pytest.approx(42.0, abs=1e-9)
    assert abs(rollout + boundary - idle) <= 1e-9


@pytest.mark.parametrize("phase,rollout", [("estorch.sample", 0.0), ("estorch.eval", 30.0),
                                           ("estorch.update", 0.0)])
def test_a_gap_counts_where_the_host_was(phase, rollout):
    """One gap of 300 ns, 400–700, the host in ``phase`` all through it;
    an eval range elsewhere, so the metrics read."""
    ctx = ctx_of([
        Ev(tr.WINDOW, "CPU", 0, 1000),
        rng("estorch.eval", 0, 390, 1),
        rng(phase, 395, 705, 2),
        Ev("aten::mul", "CPU", 10, 12, corr=3),
        Ev("k", "CUDA", 0, 400, corr=4, linked=3),
        Ev("aten::mul", "CPU", 700, 702, corr=5),
        Ev("k", "CUDA", 700, 1000, corr=6, linked=5),
    ])
    assert metric("rollout_idle_pct").read(ctx) == pytest.approx(rollout, abs=1e-9)
    assert metric("boundary_idle_pct").read(ctx) == pytest.approx(30.0 - rollout, abs=1e-9)
    assert metric("device_idle_pct").read(ctx) == pytest.approx(30.0, abs=1e-9)


@pytest.mark.parametrize("skew", [0, 8, -15])
def test_the_eval_range_moves_onto_the_devices_clock(skew):
    """The runtime's clock runs ``skew`` ns ahead of the CPU ops'; an eval
    range of 100–500 on the CPU's clock covers 100 + skew – 500 + skew of
    the device's, and the split still sums to the whole."""
    ctx = ctx_of([
        Ev(tr.WINDOW, "CPU", 0, 1000),
        rng("estorch.eval", 100, 500, 1),
        Ev("aten::mul", "CPU", 50, 50, corr=2),  # a launch at an instant: the offset exactly
        Ev("cudaLaunchKernel", "CPU", 50 + skew, 51 + skew, corr=3),
        Ev("k", "CUDA", 60 + skew, 300, corr=3, linked=2),
    ])
    assert ctx.trace.offset == skew
    # idle 300–1000; inside eval 300–500 + skew
    assert metric("rollout_idle_pct").read(ctx) == pytest.approx(20.0 + skew / 10, abs=1e-9)
    total = metric("rollout_idle_pct").read(ctx) + metric("boundary_idle_pct").read(ctx)
    assert abs(total - metric("device_idle_pct").read(ctx)) <= 1e-9


def test_step_launches_count_the_kernels_launched_inside_a_step():
    # where_kernel, add_kernel (step 1), where_kernel (step 2): the gemms
    # are the forward's, the copy no kernel, sort and mul outside eval
    ctx = ctx_of(generation())
    assert metric("step_launches_per_step").read(ctx) == pytest.approx(3 / 2)
    assert metric("step_launches_per_step").read(ctx_of(generation(), chunks=3)) == \
        pytest.approx(3 / 6)


def test_a_program_without_the_ranges_gives_nothing():
    """An older program opens no range: the metrics read None, not 0."""
    events = [e for e in generation() if not e.name().startswith("estorch.")]
    ctx = ctx_of(events)
    assert metric("device_idle_pct").read(ctx) == pytest.approx(62.0, abs=1e-9)
    for name in METRICS:
        assert metric(name).read(ctx) is None


@pytest.mark.parametrize("inner", [True, False])
def test_a_ctypes_launch_keeps_its_function_span(inner):
    """A launch through ``ctypes`` is under no torch op: the profiler links
    its kernel to the innermost range open at the launch.  With the
    wrapper's own ``estorch.noise_matvec`` range that lies inside the
    injected span of ``population_noise_matvec``; linked to the enclosing
    ``estorch.eval`` range it would start before the span, and the call
    would lose its kernel."""
    linked = 5 if inner else 3
    t = tr.read_events([
        Ev(tr.WINDOW, "CPU", 0, 1000),
        rng("estorch.eval", 50, 900, 3),
        Ev(MATVEC, "CPU", 100, 200),
        rng("estorch.noise_matvec", 150, 198, 5),
        Ev("cudaLaunchKernelExC", "CPU", 190, 195, corr=7),
        Ev("noise_matvec_wide", "CUDA", 300, 400, corr=7, linked=linked),
    ], [MATVEC])
    got = [[d.name for d in ops] for ops in t.calls(MATVEC)]
    assert got == ([["noise_matvec_wide"]] if inner else [[]])


def test_a_cpu_run_of_a_humanoid_cell_reports_the_three():
    """On the CPU no op runs on a device: the whole window is idle, split
    between the rollout and the rest, and no kernel is launched."""
    from esbench import run

    out = run.run_cell("humanoid_mlp256_pop10k.streamed", 2**31 + 11, 0.0, True,
                       device="cpu",
                       config_override={"population_size": 4, "horizon": 2,
                                        "table_size": 1 << 21})
    got = out["result"]["metrics"]
    assert set(METRICS) <= set(got)
    rollout, boundary = got["rollout_idle_pct"]["value"], got["boundary_idle_pct"]["value"]
    assert 0.0 < rollout < 100.0 and 0.0 < boundary < 100.0
    assert rollout + boundary == pytest.approx(100.0, abs=1e-9)
    assert got["step_launches_per_step"] == {"value": 0.0, "unit": "launches"}


@pytest.mark.cuda
def test_one_streamed_generation_on_the_card_keeps_its_attribution():
    """One traced streamed generation with the kernel update: the ranges
    are on the CPU's timeline and none on the device's, and the injected
    spans of the two kernels' wrappers find 3 × horizon calls and 1, each
    with its device ops."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    import estorch_tpu_torch as tt

    horizon = 20
    es = tt.ES(tt.MLPPolicy, tt.DeviceAgent(tt.Pendulum(), horizon=horizon), tt.adam,
               population_size=256, sigma=0.05, device="cuda", table_size=1 << 20,
               policy_kwargs={"action_dim": 1, "hidden": (64, 64), "discrete": False,
                              "action_scale": 2.0},
               optimizer_kwargs={"learning_rate": 1e-2}, streamed=True, noise_kernel=True,
               telemetry=False)
    es.train(1, verbose=False)
    sums = "estorch_tpu_torch.ops.noise_kernels:weighted_noise_sum"
    t = tr.capture(lambda: (es.train(1, verbose=False), torch.cuda.synchronize()),
                   [MATVEC, sums])
    ranges = {n for n, _, _ in t.op_names.values() if n.startswith("estorch.")}
    assert {"estorch.sample", "estorch.eval", "estorch.rank", "estorch.update",
            "estorch.forward", "estorch.step", "estorch.noise_matvec", "estorch.noise_sum",
            "estorch.dispatch", "estorch.device", "estorch.host_sync",
            "estorch.record"} <= ranges
    assert not [d.name for d in t.device if d.name.startswith("estorch.")]
    matvec, reduction = t.calls(MATVEC), t.calls(sums)
    assert len(matvec) == 3 * horizon and all(matvec)
    assert len(reduction) == 1 and all(reduction)
    ctx = types.SimpleNamespace(trace=t, horizon=horizon, chunks=1, generations=[0])
    idle = metric("device_idle_pct").read(ctx)
    split = metric("rollout_idle_pct").read(ctx) + metric("boundary_idle_pct").read(ctx)
    assert abs(split - idle) <= 1e-9
    assert metric("step_launches_per_step").read(ctx) > 0
