"""Long-run parity: the port's Cheetah2D training curve against the JAX
package's over 30 generations, on the CPU.  Marked ``slow`` (about two
minutes), so it is not part of tier-1:

    JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_longrun.py

Both sides run the ``cheetah2d_device`` recipe's policy and optimizer
(MLP 64x64, σ 0.08, Adam 2e-2) at population 32, horizon 100, the port
from the JAX side's table, initial params and per-generation draws
(``es_pair``/``step_both`` of ``tests/test_torch_envs.py``).  The planar
physics is chaotic and XLA fuses multiply-adds that torch rounds apart, so
the curves cannot stay bit-close; the tolerance is JAX's own sensitivity:
a second JAX run whose initial params differ in one weight by one ulp.  The
port's distance from JAX must stay within 3 times that run's distance
(plus 1e-3 of the curve's scale).

The curve alone would let a small fault in the update pass (an lr a few
percent off), so the first ``EARLY`` generations, before the chaos takes
over, also hold each generation's parameter change to JAX's, by the same
measure: the port's relative error on its norm, and its 1 − cosine, within
3 times the twin's (plus 1e-6).  Measured on the CPU: the norm 1.3e-8,
1.8e-4, 6.6e-3 off for the port and 8.5e-9, 1.8e-4, 6.6e-3 for the twin;
1 − cosine 0.026, 0.015, 0.046 for both, alike to 1e-8 (Adam's first steps
are ±lr in each weight, so a weight whose gradient is zero in one run and
a rounding in the other flips whole steps).
"""

import jax.numpy as jnp
import numpy as np
import pytest

import estorch_tpu.envs as jenvs
import estorch_tpu_torch.envs as tenvs
from test_torch_envs import es_pair, step_both

pytestmark = pytest.mark.slow

GENERATIONS, POPULATION, HORIZON = 30, 32, 100
EARLY = 3


def test_cheetah2d_reward_curve_tracks_jax_over_30_generations():
    policy_kwargs = {"action_dim": 6, "hidden": (64, 64), "discrete": False,
                     "action_scale": 1.0}
    over = dict(population_size=POPULATION, sigma=0.08, table_size=1 << 18,
                optimizer_kwargs={"learning_rate": 2e-2})
    jes, tes = es_pair(jenvs.Cheetah2D(), tenvs.Cheetah2D(), policy_kwargs, HORIZON, **over)
    twin, _ = es_pair(jenvs.Cheetah2D(), tenvs.Cheetah2D(), policy_kwargs, HORIZON, **over)
    p = twin.state.params_flat
    # the largest weight: the next float after a zero bias is a subnormal, which XLA
    # flushes to 0
    i = int(jnp.argmax(jnp.abs(p)))
    twin.state = twin.state._replace(params_flat=p.at[i].set(jnp.nextafter(p[i], jnp.inf)))
    jax_curve, port_curve, twin_curve = [], [], []
    step_err = {"port": [], "twin": []}  # (norm rel err, 1 - cosine) a generation
    for g in range(GENERATIONS):
        jp0 = np.array(jes.state.params_flat, np.float64)
        tp0 = tes.state.params_flat.numpy().astype(np.float64)
        wp0 = np.array(twin.state.params_flat, np.float64)
        _, jm, tm = step_both(jes, tes)
        twin.state, wm = twin.engine.generation_step(twin.state)
        if g < EARLY:
            dj = np.asarray(jes.state.params_flat, np.float64) - jp0
            for who, d in (("port", tes.state.params_flat.numpy().astype(np.float64) - tp0),
                           ("twin", np.asarray(twin.state.params_flat, np.float64) - wp0)):
                nd, nj = np.linalg.norm(d), np.linalg.norm(dj)
                step_err[who].append((abs(nd / nj - 1), 1 - float(d @ dj) / (nd * nj)))
        jax_curve.append(float(np.mean(np.asarray(jm["fitness"]))))
        port_curve.append(float(tm["fitness"].mean()))
        twin_curve.append(float(np.mean(np.asarray(wm["fitness"]))))
    jax_curve, port_curve, twin_curve = map(np.asarray, (jax_curve, port_curve, twin_curve))
    scale = float(np.abs(jax_curve).max())
    port_gap = float(np.abs(port_curve - jax_curve).max())
    twin_gap = float(np.abs(twin_curve - jax_curve).max())
    print(f"Cheetah2D pop {POPULATION} h{HORIZON}, {GENERATIONS} generations: reward mean "
          f"{jax_curve[0]:.3f} -> {jax_curve[-1]:.3f} (JAX), {port_curve[-1]:.3f} (port); "
          f"max |port - JAX| {port_gap:.3g}, max |JAX 1-ulp twin - JAX| {twin_gap:.3g}, "
          f"scale {scale:.3g}; first {EARLY} parameter changes (norm rel err, 1 - cosine): "
          f"port {np.array(step_err['port'])}, twin {np.array(step_err['twin'])}")
    port_step, twin_step = np.array(step_err["port"]), np.array(step_err["twin"])
    assert np.all(port_step <= 3 * twin_step + 1e-6), (port_step, twin_step)
    assert np.all(np.isfinite(port_curve))
    assert port_gap <= 3 * twin_gap + 1e-3 * scale
