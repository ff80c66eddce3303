"""The standard forward's pair form against its member form.

A mirrored chunk's dense layers run as one shared product over the chunk
plus one batched product a pair (``models/policies.py`` ``pair_members`` /
``pair_linear``); every other leaf, and every chunk that cannot take the
pair form (unmirrored, a chunk splitting a pair, bf16, recurrent), is
formed per member, θ_i = θ + c_i·ε_i, as the member form always was.  The
member form here is written out in the test (``_member_form_fitness``),
so a fallback is held to it bit for bit and the pair form to it within
float32 reassociation: rtol 1e-4, atol 1e-5, the tolerance of the same
rewrite in ``tests/test_torch_noise_kernels.py``
(``test_matches_port_decomposed_apply``).
"""

import pytest
import torch

from estorch_tpu_torch import (ES, DeviceAgent, MLPPolicy, NatureCNN, Pendulum, RecurrentPolicy,
                               adam)
from estorch_tpu_torch.envs.rollout import map_carry, member_params_apply
from estorch_tpu_torch.models import capture_reference_stats
from estorch_tpu_torch.models.policies import PairKernel, pair_members
from estorch_tpu_torch.ops.noise import gather_rows, pair_signs
from estorch_tpu_torch.ops.params import make_param_spec

from test_torch_sharded_conv import PixelShift

PENDULUM_POLICY = {"action_dim": 1, "hidden": (8, 8), "discrete": False, "action_scale": 2.0}
CNN_POLICY = {"action_dim": 2, "use_vbn": True}


def _pendulum_es(policy=MLPPolicy, policy_kwargs=PENDULUM_POLICY, **over):
    kw = dict(population_size=16, sigma=0.05, seed=3, policy_kwargs=policy_kwargs,
              optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 16, telemetry=True)
    kw.update(over)
    return ES(policy, DeviceAgent(Pendulum(), horizon=12), adam, device="cpu", **kw)


def _cnn_es(**over):
    kw = dict(population_size=8, sigma=0.05, seed=5, policy_kwargs=CNN_POLICY,
              optimizer_kwargs={"learning_rate": 1e-2}, table_size=1 << 18, telemetry=True)
    kw.update(over)
    return ES(NatureCNN, DeviceAgent(PixelShift(), horizon=3), adam, device="cpu", **kw)


def _members(n, seed):
    """n mirrored members' scales c_i = σ·s_i and a generator for their noise."""
    g = torch.Generator().manual_seed(seed)
    return 0.05 * pair_signs(n), g


@pytest.mark.parametrize("episodes", [1, 3], ids=["one_row", "three_rows"])
def test_mlp_pair_form_matches_member_form(episodes):
    """A tanh MLP (5 → 16 → 12 → 3), 8 members of ``episodes`` rows each:
    the pair form against each member's θ_i = θ + c_i·ε_j formed; the
    biases, formed per member in both, are equal bit for bit."""
    module = MLPPolicy(3, hidden=(16, 12), discrete=False)
    c, g = _members(8, 0)
    flat, spec = make_param_spec(module.init_params(5, g))
    flat = flat + 0.1 * torch.randn(spec.dim, generator=g)
    noise = torch.randn(4, spec.dim, generator=g)
    x = torch.randn(8, episodes, 5, generator=g)
    theta = flat + c[:, None] * noise.repeat_interleave(2, 0)
    want = member_params_apply(module, spec.unravel(theta), x)
    tree = pair_members(module.layers(), spec.unravel(flat), spec.unravel(noise), c)
    assert all(isinstance(tree[n]["kernel"], PairKernel) for n in ("dense_0", "dense_1", "head"))
    for name in ("dense_0", "dense_1", "head"):
        assert torch.equal(tree[name]["bias"], spec.unravel(theta)[name]["bias"])
    got = member_params_apply(module, tree, x)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_naturecnn_pair_form_matches_member_form():
    """NatureCNN with VBN on (36, 36, 4) pixels, 6 members: ``fc`` and
    ``head`` in pair form, the convolutions and VBN formed per member (bit
    for bit the member form's leaves); logits within float32
    reassociation."""
    module = NatureCNN(2, use_vbn=True)
    c, g = _members(6, 1)
    flat, spec = make_param_spec(module.init_params((36, 36, 4), g))
    module.vbn_stats = capture_reference_stats(module, spec.unravel(flat),
                                               torch.rand(16, 36, 36, 4, generator=g))
    noise = torch.randn(3, spec.dim, generator=g)
    obs = torch.rand(6, 1, 36, 36, 4, generator=g)
    theta = spec.unravel(flat + c[:, None] * noise.repeat_interleave(2, 0))
    want = module.population_apply(module.population_layout(theta), obs)
    tree = pair_members(module.layers(), spec.unravel(flat), spec.unravel(noise), c)
    assert [n for n in tree if isinstance(tree[n].get("kernel"), PairKernel)] == ["fc", "head"]
    for name in ("conv_0", "conv_1", "conv_2", "vbn_0", "vbn_1", "vbn_2"):
        for leaf, v in tree[name].items():
            assert torch.equal(v, theta[name][leaf]), (name, leaf)
    got = module.population_apply(module.population_layout(tree), obs)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def _member_form_fitness(es, sample):
    """Each chunk's members' θ_i = θ + c_i·ε_i formed once, then the
    module's member-batched forward each step: the standard forward's
    member form, written out, for the engine's chunks and rollout."""
    eng, state = es.engine, es.state
    e = eng.config.episodes_per_member
    offs, signs, states = eng._members(sample)
    fits = []
    for lo in range(0, eng.members_local, eng.eval_chunk):
        hi = lo + eng.eval_chunk
        k = hi - lo
        c = state.sigma * signs[lo:hi]
        theta = state.params_flat + c[:, None] * gather_rows(eng.table.data, offs[lo:hi],
                                                             eng.spec.dim)
        members = eng.spec.unravel(theta.to(eng._dtype))
        states0 = states[lo:hi].reshape(k * e, -1)
        obs0 = eng.env.observe(states0)
        if eng.recurrent:
            layout = es.module.population_layout(members)
            carry0 = eng._episode_carry(members, k, e, eng._dtype)

            def apply(obs, carry, layout=layout, k=k):
                out, h = es.module.population_apply(
                    layout, obs.to(eng._dtype).reshape(k, e, -1),
                    map_carry(lambda t: t.reshape(k, e, -1), carry))
                return (out.reshape(k * e, -1).float(),
                        map_carry(lambda t: t.reshape(k * e, -1), h))
        elif hasattr(es.module, "population_layout"):
            carry0 = None

            def apply(obs, layout=es.module.population_layout(members), k=k):
                x = obs.to(eng._dtype).reshape(k, e, -1)
                return es.module.population_apply(layout, x).reshape(k * e, -1).float()
        else:
            carry0 = None

            def apply(obs, members=members, k=k):
                x = obs.to(eng._dtype).reshape(k, e, -1)
                return member_params_apply(es.module, members, x).reshape(k * e, -1).float()
        res = eng._rollout(apply, states0, obs0, carry0)
        fits.append(res.total_reward.view(k, e).mean(dim=1))
    return torch.cat(fits)


FALLBACKS = {
    "unmirrored": {"mirrored": False},
    "chunk_splits_a_pair": {"population_size": 20, "eval_chunk": 5},
    "bf16": {"compute_dtype": "bfloat16"},
    "recurrent": {"policy": RecurrentPolicy,
                  "policy_kwargs": {"action_dim": 1, "hidden": (8,), "gru_size": 8,
                                    "discrete": False, "action_scale": 2.0}},
}


@pytest.mark.parametrize("over", list(FALLBACKS.values()), ids=list(FALLBACKS))
def test_fallbacks_take_the_member_form_bit_for_bit(over):
    es = _pendulum_es(**over)
    eng = es.engine
    assert eng._pair_layers == 0
    if over.get("eval_chunk"):
        assert eng.eval_chunk == 5
    sample = eng.sample(es.state)
    got = eng.evaluate(es.state, sample).fitness
    assert torch.equal(got, _member_form_fitness(es, sample))
    assert es.obs.counters.get("forward_pair_layers") == 0


@pytest.mark.parametrize("make", [_pendulum_es, _cnn_es], ids=["mlp", "naturecnn_vbn"])
def test_generation_step_pair_form_matches_member_form(make):
    """One generation, the pair form against the member form on the same
    draws, at ``tests/test_torch_paths.py``'s tolerance against the JAX
    engine: fitness rtol 1e-4 / atol 1e-3, params atol 2e-5."""
    pair, member = make(), make()
    member.engine._pair_layers = 0
    assert pair.engine._pair_layers
    sample = pair.engine.sample(pair.state)
    torch.testing.assert_close(pair.engine.evaluate(pair.state, sample).fitness,
                               _member_form_fitness(member, sample), rtol=1e-4, atol=1e-3)
    new_p, mp = pair.engine.generation_step(pair.state, sample)
    new_m, mm = member.engine.generation_step(member.state, sample)
    torch.testing.assert_close(mp["fitness"], mm["fitness"], rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(new_p.params_flat, new_m.params_flat, rtol=0, atol=2e-5)
    assert int(mp["steps"]) == int(mm["steps"])


@pytest.mark.parametrize("make, chunks, want", [
    (_pendulum_es, 1, (3, 0)),
    (_pendulum_es, 2, (6, 0)),
    (_cnn_es, 1, (2, 3)),
], ids=["mlp", "mlp_two_chunks", "naturecnn_vbn"])
def test_forward_layer_counters(make, chunks, want):
    """One generation: each chunk adds its dense layers run in pair form
    and its layers run in member form (the convolutions)."""
    es = make()
    es.engine.eval_chunk //= chunks
    es.train(1, verbose=False)
    c = es.obs.counters
    assert (c.get("forward_pair_layers"), c.get("forward_member_layers")) == want


@pytest.mark.parametrize("over", [{"streamed": True, "noise_kernel": True}, {"mirrored": False}],
                         ids=["streamed", "unmirrored"])
def test_other_forwards_run_no_pair_layer(over):
    es = _pendulum_es(**over)
    es.train(1, verbose=False)
    assert es.obs.counters.get("forward_pair_layers") == 0
