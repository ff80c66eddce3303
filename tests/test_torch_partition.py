"""The port's partition rules and 2-D mesh shapes (``parallel/mesh.py``)
against the JAX package's, on the CPU, with no processes: the rules resolve
from the axis sizes alone.  The counterpart of ``tests/test_sharded.py``'s
``TestPartitionRules``, plus the JSON crossing both ways, the mesh shape's
defaults and errors, and each rank's exact state bytes at (1, 2) for the
JAX sharded headline row's policy (376 → 768 → 768 → 17).

The JAX side builds its ``(pop, model)`` mesh with ``Auto`` axes itself:
under jax 0.9.0 ``jax.make_mesh`` (the JAX package's ``hyperscale_mesh``)
makes ``Explicit`` ones (ROADMAP F4).
"""

from __future__ import annotations

import json
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import AxisType, Mesh
from jax.sharding import PartitionSpec as JP

from estorch_tpu.models import MLPPolicy as JMLPPolicy
from estorch_tpu.models import NatureCNN as JNatureCNN
from estorch_tpu.models import RecurrentPolicy as JRecurrentPolicy
from estorch_tpu.parallel import mesh as jmesh
from estorch_tpu_torch import MLPPolicy, NatureCNN, RecurrentPolicy, SyntheticEnv, adam
from estorch_tpu_torch.parallel import mesh as tmesh
from estorch_tpu_torch.parallel.mesh import DEFAULT_PARTITION_RULES, MODEL_AXIS, P

SIZES = {"pop": 2, "model": 4}


def jax_mesh(pop: int, model: int) -> Mesh:
    devs = np.asarray(jax.devices()[:pop * model]).reshape(pop, model)
    return Mesh(devs, (jmesh.POP_AXIS, jmesh.MODEL_AXIS), axis_types=(AxisType.Auto,) * 2)


def jax_rules(rules):
    return tuple((pat, JP(*spec)) for pat, spec in rules)


def port_trees() -> dict:
    gen = torch.Generator().manual_seed(0)
    return {
        "mlp": MLPPolicy(action_dim=4, hidden=(64, 64)).init_params(8, gen),
        "recurrent": RecurrentPolicy(action_dim=2, hidden=(32,), gru_size=16).init_params(8, gen),
        "cnn": NatureCNN(action_dim=6).init_params((84, 84, 4), gen),
    }


def jax_trees() -> dict:
    key = jax.random.PRNGKey(0)
    rec = JRecurrentPolicy(action_dim=2, hidden=(32,), gru_size=16)
    return {
        "mlp": jax.eval_shape(JMLPPolicy(action_dim=4, hidden=(64, 64)).init, key,
                              jnp.zeros((8,)))["params"],
        "recurrent": jax.eval_shape(rec.init, key, jnp.zeros((8,)), rec.carry_init())["params"],
        "cnn": jax.eval_shape(JNatureCNN(action_dim=6).init, key,
                              jnp.zeros((84, 84, 4)))["params"],
    }


@pytest.mark.parametrize("pop,model", [(2, 4), (1, 2), (4, 2), (1, 8)])
@pytest.mark.parametrize("name", ["mlp", "recurrent", "cnn"])
def test_default_rules_match_jax_on_demo_policies(name, pop, model):
    """Every leaf of the three demo policies resolves to JAX's spec, the
    big kernels over ``model``."""
    tree = port_trees()[name]
    got = tmesh.sharding_summary(
        tree, tmesh.match_partition_rules(DEFAULT_PARTITION_RULES, tree,
                                          {"pop": pop, "model": model}))
    jtree = jax_trees()[name]
    want = jmesh.sharding_summary(
        jtree, jmesh.match_partition_rules(jmesh.DEFAULT_PARTITION_RULES, jtree,
                                           jax_mesh(pop, model)))
    assert got == want
    assert any(MODEL_AXIS in spec for spec in got.values()), got


def test_unmatched_leaf_raises_as_jax():
    rules = ((r"kernel$", P(None, MODEL_AXIS)),)  # no catch-all
    tree = {"dense": {"kernel": torch.zeros((8, 8)), "bias": torch.zeros((8,))}}
    with pytest.raises(ValueError, match="dense/bias") as got:
        tmesh.match_partition_rules(rules, tree, SIZES)
    jtree = {"dense": {"kernel": jnp.zeros((8, 8)), "bias": jnp.zeros((8,))}}
    with pytest.raises(ValueError) as want:
        jmesh.match_partition_rules(jax_rules(rules), jtree, jax_mesh(2, 4))
    assert str(got.value) == str(want.value)


def test_scalars_always_replicate():
    specs = tmesh.match_partition_rules(((r".*", P(MODEL_AXIS)),),
                                        {"count": torch.tensor(0.0), "one": torch.zeros((1,))},
                                        SIZES)
    assert specs == {"count": P(), "one": P()}


def test_divisibility_fallback_replicates():
    tree = {"head": {"kernel": torch.zeros((16, 17)), "bias": torch.zeros((68,))}}
    specs = tmesh.match_partition_rules(DEFAULT_PARTITION_RULES, tree, SIZES)
    assert specs["head"]["kernel"] == P(None, None)  # 17 % 4 != 0
    assert specs["head"]["bias"] == P(MODEL_AXIS)  # 68 % 4 == 0
    jtree = {"head": {"kernel": jnp.zeros((16, 17)), "bias": jnp.zeros((68,))}}
    want = jmesh.sharding_summary(jtree, jmesh.match_partition_rules(
        jmesh.DEFAULT_PARTITION_RULES, jtree, jax_mesh(2, 4)))
    assert tmesh.sharding_summary(tree, specs) == want


class ScaleByAdamState(NamedTuple):  # optax's field names, so the paths agree
    count: torch.Tensor
    mu: dict
    nu: dict


def test_optimizer_state_resolves_through_the_same_rules():
    """Adam's moments embed the param tree under the same leaf names: one
    rule set covers both, as in JAX (the same paths and specs as optax's
    state tree)."""
    params = {"dense": {"kernel": torch.zeros((8, 16)), "bias": torch.zeros((16,))}}
    tree = (ScaleByAdamState(torch.zeros((), dtype=torch.int32), params, params), ())
    got = tmesh.sharding_summary(tree, tmesh.match_partition_rules(
        DEFAULT_PARTITION_RULES, tree, SIZES))
    jparams = {"dense": {"kernel": jnp.zeros((8, 16)), "bias": jnp.zeros((16,))}}
    jopt = jax.eval_shape(optax.adam(1e-2).init, jparams)
    want = jmesh.sharding_summary(jopt, jmesh.match_partition_rules(
        jmesh.DEFAULT_PARTITION_RULES, jopt, jax_mesh(2, 4)))
    assert got == want
    assert got["0/mu/dense/kernel"] == str(P(None, MODEL_AXIS)) and got["0/count"] == str(P())


def test_rules_json_crosses_both_ways():
    """The port's JSON is JAX's format: each package reads the other's."""
    rules = DEFAULT_PARTITION_RULES + ((r"odd$", P((jmesh.POP_AXIS, MODEL_AXIS), None)),)
    data = tmesh.partition_rules_to_json(rules)
    jdata = jmesh.partition_rules_to_json(jax_rules(rules))
    assert json.dumps(data) == json.dumps(jdata)
    back = tmesh.partition_rules_from_json(json.loads(json.dumps(jdata)))
    assert back == rules and all(isinstance(s, P) for _, s in back)
    jback = jmesh.partition_rules_from_json(json.loads(json.dumps(data)))
    assert [(p, tuple(s)) for p, s in jback] == [(p, tuple(s)) for p, s in rules]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("pop,model", [(None, None), (None, 2), (2, None), (1, None), (2, 2),
                                       (4, 2), (3, None)])
def test_mesh_shape_resolves_as_jax(n, pop, model):
    """``hyperscale_mesh``'s defaults (model spans every rank, pop the
    co-factor) and its shape errors, against JAX's on n devices."""
    try:
        m = jmesh.hyperscale_mesh(pop, model, jax.devices()[:n])
        want = tuple(int(s) for s in m.devices.shape)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tmesh.hyperscale_shape(pop, model, n)
        assert str(got.value) == str(e)
        return
    assert tmesh.hyperscale_shape(pop, model, n) == want


def test_one_process_mesh_and_its_refusals():
    """Without a group the mesh is (1, 1) over one device; several devices
    in one process raise with the launch recipe; a shape that needs more
    ranks raises."""
    mesh = tmesh.hyperscale_mesh(devices="cpu")
    assert (mesh.shape, mesh.rank, mesh.devices.size, str(mesh.device)) == (
        {"pop": 1, "model": 1}, 0, 1, "cpu")
    assert mesh.devices.shape == (1, 1) and mesh.axis_names == ("pop", "model")
    with pytest.raises(ValueError, match="one rank a process"):
        tmesh.hyperscale_mesh(devices=["cpu", "cpu"])
    with pytest.raises(ValueError, match=r"mesh shape \(0, 2\) needs 0 devices, got 1"):
        tmesh.hyperscale_mesh(model_shards=2, devices="cpu")
    with pytest.raises(ValueError, match="needs its process groups"):
        tmesh.HyperscaleMesh(1, 2, 0, "cpu")


def _rank_mesh(pop: int, model: int, rank: int):
    """A rank's view of a (pop, model) mesh for layouts alone (no
    collective runs, so no groups are joined)."""
    return tmesh.HyperscaleMesh(pop, model, rank, "cpu", groups=(None, None, None))


def test_per_rank_state_bytes_at_1x2():
    """The JAX sharded row's policy (376 → 768 → 768 → 17, dim 893,201) at
    (1, 2): each rank holds half of every sharded leaf and the whole
    (768, 17) head and its bias (17 is odd): (440,064 + 13,073) floats of
    params, the same again for each Adam moment, 0.507× world 1's."""
    from estorch_tpu_torch.ops.params import make_param_spec
    from estorch_tpu_torch.parallel.engine import EngineConfig
    from estorch_tpu_torch.parallel.sharded import ShardedESEngine

    env = SyntheticEnv()
    module = MLPPolicy(action_dim=17, hidden=(768, 768), discrete=False)
    flat, spec = make_param_spec(module.init_params(env.obs_dim,
                                                    torch.Generator().manual_seed(0)))
    assert spec.dim == 893_201
    cfg = EngineConfig(population_size=64, sigma=0.05, horizon=100, eval_chunk=8)
    held = []
    for rank in range(2):
        eng = ShardedESEngine(env, module, spec, None, adam(1e-2), cfg, _rank_mesh(1, 2, rank))
        state = eng.init_state(flat, seed=0)
        facts = eng.memory_facts(state)
        assert facts["local_dim"] == 440_064 + 13_073
        assert facts["param_bytes"] == 4 * 453_137
        assert facts["opt_state_bytes"] == 2 * 4 * 453_137
        assert round(facts["local_dim"] / spec.dim, 3) == 0.507
        report = eng.sharding_report()
        assert report["head/kernel"] == str(P(None, None))
        assert report["dense_1/kernel"] == str(P(None, MODEL_AXIS))
        held.append(state.params_local)
    # the replicated head is held whole by both; the sharded leaves split
    lf = eng.layout.leaves[[lf.path for lf in eng.layout.leaves].index(("head", "kernel"))]
    sl = slice(lf.local_offset, lf.local_offset + lf.local_size)
    assert torch.equal(held[0][sl], held[1][sl])
    assert not torch.equal(held[0][:1000], held[1][:1000])


@pytest.mark.parametrize("pop,model", [(1, 1), (1, 2), (2, 1), (2, 2), (1, 4)])
def test_layout_scatter_covers_every_element_once(pop, model):
    """The model ranks' local elements of each leaf partition it: every
    element held by exactly one model rank (sharded) or by all (whole)."""
    from estorch_tpu_torch.ops.params import make_param_spec
    from estorch_tpu_torch.parallel.sharded import ShardLayout

    gen = torch.Generator().manual_seed(1)
    flat, spec = make_param_spec(MLPPolicy(action_dim=2, hidden=(16, 8)).init_params(4, gen))
    specs_tree = tmesh.match_partition_rules(DEFAULT_PARTITION_RULES,
                                             spec.unravel(flat), {"pop": pop, "model": model})
    specs = []
    for path in spec.paths:
        node = specs_tree
        for k in path:
            node = node[k]
        specs.append(node)
    seen = torch.zeros(spec.dim, dtype=torch.int64)
    for rank in range(pop * model):
        layout = ShardLayout(spec, specs, _rank_mesh(pop, model, rank), "cpu")
        local = layout.scatter(flat)
        for lf in layout.leaves:
            got = local[lf.local_offset:lf.local_offset + lf.local_size]
            idx = lf.elements + lf.flat_offset
            assert torch.equal(got, flat[idx])
            if rank // model == 0:
                seen[idx] += 1 if lf.shard_dim is not None or rank % model == 0 else 0
    assert torch.equal(seen, torch.ones_like(seen))
