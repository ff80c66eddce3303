"""The plain reference against the port, and the comparison against the
control and the faults, on the CPU at small sizes."""

import pytest
import torch

from esbench import control, loader, run
from esbench.reference import compare
from esbench.reference.es import tf32

CELLS = ["humanoid_mlp256_pop10k.streamed", "naturecnn_vbn_pop5k.standard",
         "humanoid_mlp256_pop10k.standard"]


def small(cell, population=8, horizon=3):
    table = 1 << 21 if cell.startswith("naturecnn") else 1 << 20
    return {"population_size": population, "horizon": horizon, "table_size": table}


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_agrees_with_the_reference(cell):
    out = run.run_cell(cell, 2**33 + 7, 0.0, False, device="cpu", config_override=small(cell))
    assert out["result"]["correct"], out["checks"]
    for name, check in out["checks"].items():
        assert check["value"] < (1e-6 if name != "steps_gap" else 1)
    assert out["checks"]["steps_gap"]["value"] == 0


# sizes a CPU run holds at which the TF32 control's rounding shows (the
# Nature CNN's: seed 12 flips one action at population 64, horizon 30)
CONTROL_SIZES = {"humanoid_mlp256_pop10k.streamed": (64, 20, 11),
                 "naturecnn_vbn_pop5k.standard": (64, 30, 12),
                 "humanoid_mlp256_pop10k.standard": (64, 20, 11)}


@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_and_the_half_batch_fault_are_not_correct(cell):
    population, horizon, seed = CONTROL_SIZES[cell]
    readings = control.seed_readings(cell, seed, "cpu", True,
                                     small(cell, population, horizon))
    limits = {k: v for k, v in loader.load_workload(cell)["limits"].items() if k != "steps_gap"}
    assert compare.verdict(readings["lower"], limits)[0]
    assert not compare.verdict(readings["control"], limits)[0], readings["control"]
    assert not compare.verdict(readings["half_batch"], limits)[0], readings["half_batch"]


def _broken_run(cell):
    return run.run_cell(cell, 5, 0.0, False, device="cpu", config_override=small(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_keeps_its_state_is_not_correct(cell, monkeypatch):
    from estorch_tpu_torch.parallel import engine

    def unchanged(self, state, grad, probe_states=None):
        return state, torch.linalg.vector_norm(grad)

    monkeypatch.setattr(engine.ESEngine, "_finish_update", unchanged)
    out = _broken_run(cell)
    assert not out["result"]["correct"]
    assert out["checks"]["grad_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_moves_adam_but_not_the_params_is_not_correct(cell, monkeypatch):
    from estorch_tpu_torch.parallel import engine

    finish = engine.ESEngine._finish_update

    def frozen(self, state, grad, probe_states=None):
        new, gnorm = finish(self, state, grad, probe_states)
        return new._replace(params_flat=state.params_flat), gnorm

    monkeypatch.setattr(engine.ESEngine, "_finish_update", frozen)
    out = _broken_run(cell)
    assert not out["result"]["correct"]
    # Adam's moments moved as they should: the gradient alone reads sound
    assert out["checks"]["grad_gap"]["value"] < 1e-6
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_the_replay_counts_the_members_whose_actions_the_reference_would_not_take():
    from esbench import envs
    from esbench.reference.es import ReferenceES

    cell = "naturecnn_vbn_pop5k.standard"
    config = {**loader.load_config("naturecnn_vbn_pop5k"), **small(cell, 8, 4)}
    env = envs.make_env(config["env"])
    own = ReferenceES(config, 9, env).generation(0)
    assert own["flip_share"] == 0.0 and own["action_gap"] == 0.0
    given = own["actions"].clone()
    given[3, 2] = (given[3, 2] + 1) % env.action_dim
    replayed = ReferenceES(config, 9, env).generation(0, given)
    assert replayed["flip_share"] == pytest.approx(1 / 8)
    assert replayed["action_gap"] > 0.0


@pytest.mark.parametrize("cell", CELLS)
def test_an_update_over_half_the_batch_is_not_correct(cell, monkeypatch):
    from estorch_tpu_torch.parallel import engine

    ranks = engine.centered_rank_safe

    def half(fitness):
        k = fitness.shape[0] // 2
        w, n_valid = ranks(fitness[:k])
        return torch.cat([2.0 * w, torch.zeros_like(w)]), n_valid

    monkeypatch.setattr(engine, "centered_rank_safe", half)
    assert not _broken_run(cell)["result"]["correct"]


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-11, 1.0 + 3 * 2**-11, -(1.0 + 2**-10 + 2**-12), 3.0])
    # ties to even, then plain rounding; the sign is kept
    assert tf32(x).tolist() == [1.0, 1.0 + 2**-9, -(1.0 + 2**-10), 3.0]
