"""The benchmark's FLOP and byte counts against hand counts."""

import pytest

from esbench import costs

MLP = {"policy": {"kind": "mlp", "hidden": [256, 256], "action_dim": 17},
       "population_size": 10240, "mirrored": True}
CNN = {"policy": {"kind": "nature_cnn", "action_dim": 3, "use_vbn": True},
       "population_size": 5000, "mirrored": True}


def test_mlp_member_step():
    # 376·256 + 256·256 + 256·17 multiply-adds (biases and tanh not counted)
    assert costs.member_step_macs(MLP, (376,)) == 96_256 + 65_536 + 4_352 == 166_144


def test_nature_cnn_conv_by_conv():
    layers = costs.nature_cnn_layers((84, 84, 4), 3)
    # 20×20 positions of an 8×8×4 patch into 32 channels, 9×9 of 4×4×32 into
    # 64, 7×7 of 3×3×64 into 64, then 3136 → 512 and 512 → 3
    assert [lay["positions"] * lay["d"] * lay["h"] for lay in layers] == [
        20 * 20 * 8 * 8 * 4 * 32, 9 * 9 * 4 * 4 * 32 * 64, 7 * 7 * 3 * 3 * 64 * 64,
        7 * 7 * 64 * 512, 512 * 3]
    assert costs.member_step_macs(CNN, (84, 84, 4)) == 9_344_512


def test_generation_flops_adds_the_sample_and_the_update():
    dim = 166_673
    steps = 10240 * 400
    assert costs.generation_flops(MLP, (376,), dim, steps) == (
        2 * 166_144 * steps + 2 * 2 * 5120 * dim)


@pytest.mark.parametrize("starts,length,size,want", [
    ([0, 5, 100], 10, 1000, 25),  # two overlapping, one apart
    ([7, 7, 7], 10, 1000, 10),  # mirrored pairs share one row
    ([995, -3], 10, 1000, 20),  # clamped to [0, size − length]
    ([], 10, 1000, 0),
])
def test_distinct_floats(starts, length, size, want):
    assert costs.distinct_floats(starts, length, size) == want


def test_bounds_take_the_larger_of_bytes_and_flops():
    # one row of 1000 floats: 4 kB of table beats 2 kFLOP
    assert costs.reduction_bound_s([0], 1000, 10_000) == pytest.approx(
        (1000 + 1 + 1000) * 4 / costs.HBM_PEAK_BYTES_PER_S + 4 / costs.HBM_PEAK_BYTES_PER_S)
    t = costs.matvec_bound_s([0, 0], 0, 4, 8, 8, 1000)
    assert t == pytest.approx(((64 + 4 * (8 + 8 + 1)) * 4 + 4 * 4) / costs.HBM_PEAK_BYTES_PER_S)
