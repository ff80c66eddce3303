"""Device time is given to a layer by the program's function that was
running when the launch was made."""

import pytest
import torch

from esbench import trace as tr


class Ev:
    def __init__(self, name, dev, start, end, corr=0, linked=0):
        self._v = dict(name=name, device_type=f"DeviceType.{dev}", start_ns=start,
                       end_ns=end, correlation_id=corr, linked_correlation_id=linked)

    def __getattr__(self, k):
        return lambda: self._v[k]


MATVEC = "estorch_tpu_torch.ops.noise_kernels:population_noise_matvec"
FWD = "estorch_tpu_torch.envs.rollout:member_params_apply"


def events(skew=0):
    """A window with a launch through ctypes inside a call of MATVEC, and
    an aten op's inside a call of FWD; the runtime calls' clock runs
    ``skew`` ns ahead of the CPU ops'."""
    return [
        Ev(tr.WINDOW, "CPU", 0, 1000),
        Ev(MATVEC, "CPU", 100, 200),
        Ev(MATVEC, "CUDA", 300, 400),  # an annotation's copy on the device's timeline
        Ev("cudaLaunchKernelExC", "CPU", 190 + skew, 195 + skew, corr=7),
        Ev("some_kernel", "CUDA", 300, 400, corr=7),
        Ev(FWD, "CPU", 480, 560),
        Ev("aten::bmm", "CPU", 500, 520, corr=42),
        Ev("cudaLaunchKernel", "CPU", 515 + skew, 518 + skew, corr=8, linked=42),
        Ev("gemm", "CUDA", 600, 700, corr=8, linked=42),
        Ev("Memcpy DtoH", "CUDA", 650, 800, corr=9),
    ]


@pytest.mark.parametrize("skew", [0, 8, -15])
def test_ops_are_given_to_the_function_running_at_their_launch(skew):
    t = tr.read_events(events(skew), [MATVEC, FWD])
    # the one aten launch (at 515 + skew, inside an op of 500–520) bounds it
    assert skew - 5 <= t.offset <= skew + 15
    assert [d.name for d in t.under([MATVEC])] == ["some_kernel"]
    assert [d.name for d in t.under([FWD])] == ["gemm"]
    assert [d.name for d in t.under([MATVEC, FWD])] == ["some_kernel", "gemm"]
    assert [[d.name for d in ops] for ops in t.calls(MATVEC)] == [["some_kernel"]]
    assert t.calls("no_such_entry") == []
    assert len(t.kernels()) == 2


def test_busy_is_the_union_and_gaps_are_labelled():
    t = tr.read_events(events(), [MATVEC, FWD])
    assert abs(t.window_s - 1000e-9) < 1e-15
    assert abs(t.busy_s() - 300e-9) < 1e-15  # 300-400 and 600-800
    gaps = dict(t.idle_gaps())
    assert abs(gaps["cudaLaunchKernelExC"] - 300e-9) < 1e-15
    assert abs(gaps["aten::bmm"] - 200e-9) < 1e-15
    assert abs(gaps["(end of window)"] - 200e-9) < 1e-15


def test_spans_wrap_the_calls_of_the_entries_alone():
    from estorch_tpu_torch.ops import noise_kernels as nk

    table = torch.randn(4096)
    offsets = torch.tensor([0, 0, 64, 64], dtype=torch.int32)

    def work():
        for _ in range(3):
            nk.population_noise_matvec(table, offsets, torch.ones(4), torch.ones(4, 8), 0, 8, 4)
        nk.weighted_noise_sum(table, offsets, torch.ones(4), 16)

    t = tr.capture(work, [MATVEC, "estorch_tpu_torch.ops.noise_kernels:no_such_function"])
    assert len(t.spans[MATVEC]) == 3
    assert tr.resolve("estorch_tpu_torch.ops.noise_kernels:no_such_function") is None
    assert tr.resolve("no_such_module:f") is None
