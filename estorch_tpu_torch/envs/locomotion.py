"""Batched planar locomotion: articulated chains with soft joints and contact.

Counterpart of ``estorch_tpu/envs/locomotion.py``: maximal coordinates
(every body a rod with position, angle and their rates), joints as stiff
spring-dampers between anchor points, ground contact as a penalty spring
with regularized Coulomb friction, semi-implicit Euler at a small physics
``dt`` with an action frame-skip.  The chain constants, the reward, the
termination and the gait metrics are the JAX package's; the JAX envs step
one member's dict of arrays, these step the whole population at once.

State layout (:class:`PlanarLayout`): one float32 row of ``6·B + 1`` per
member, B bodies —

    [ q: (x, y, θ) of body 0, 1, …, B−1 | q̇: (ẋ, ẏ, ω) of each body | t ]

so the engine's ``(n, state_dim)`` states, the rollout's freeze and the
probe carry it as they carry Pendulum's.  The JAX dict's ``pos``, ``theta``,
``vel``, ``omega`` and ``t`` are views of it (``t`` is a float32 step
count, exact below 2^24).

One physics step works on ``(n, B, 3)`` tensors.  Each float is computed
with the same operations in the same order as in JAX's ``_physics_step``,
constants included (``inertia = mass·(2·half)²/12 + 1e-6``, ``tanh(v/0.1)``
as a division), so the two differ only where their ``sin``, ``cos`` and
``tanh`` round differently.  The joint forces reach the bodies through
fixed incidence slots, not a scatter: each body adds its contributions as
a parent in joint order, then as a child, one plain add after another,
which is the order a serial scatter-add applies them in.  There are no
atomics, so a step gives the same bits on every run (``index_add_`` on a
CUDA tensor would not: its atomic sums land in any order).

Under a scenario draw (``step_p``), the chain's mass, gravity, friction
and gear constants are scaled per member: the constants that depend on
them (``m_eff``, ``i_red`` from the scaled masses' inertias, ``acc0``,
``div``, ``mass2``, ``gear``) are built as ``(n, ·)`` tensors once an env
step, outside the ``frame_skip`` loop, and the physics step broadcasts them
as it broadcasts the cached ``(·)`` ones of the plain ``step``.

``PositionOnly`` and ``DeceptiveValley`` wrap the runners as in JAX (and,
as there, have no ``step_p``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class _Chain:
    """Static description of a planar articulated chain (tuples of Python
    floats; see the JAX package's ``_Chain`` for what each constant does)."""

    # per body
    mass: tuple
    half_len: tuple
    init_pos: tuple  # (x, y) world
    init_angle: tuple
    # per joint: (parent, child) body indices and which end of each
    parent: tuple
    child: tuple
    parent_end: tuple  # +1 → tip (+half_len side), -1 → tail
    child_end: tuple
    rest_angle: tuple  # child minus parent rest angle
    limit_lo: tuple
    limit_hi: tuple
    gear: tuple  # motor angular authority per joint (torque = gear·action·I_red)
    # world
    gravity: float = -9.81
    ground: bool = True
    k_joint: float = 4000.0
    c_joint: float = 60.0
    k_limit: float = 8000.0
    c_limit: float = 100.0
    joint_damping: float = 30.0
    k_contact: float = 3000.0
    c_contact: float = 30.0
    friction: float = 1.0
    drag: float = 0.0  # linear drag (swimmer's fluid); 0 on land
    angular_drag: float = 0.0
    dt: float = 0.002
    frame_skip: int = 8

    @property
    def n_bodies(self):
        return len(self.mass)

    @property
    def n_joints(self):
        return len(self.parent)


def _solve_init_positions(chain: _Chain) -> tuple:
    """Init positions with every joint's anchors coincident: the root's
    position and each body's angle are kept, the rest follows from the joint
    graph (joints listed parent before child).  Float64 NumPy, as in JAX."""
    pos = [np.asarray(p, np.float64) for p in chain.init_pos]
    ang = [float(a) for a in chain.init_angle]

    def end_off(i, end):
        return np.array([np.cos(ang[i]), np.sin(ang[i])]) * end * chain.half_len[i]

    for j in range(chain.n_joints):
        p, c = chain.parent[j], chain.child[j]
        anchor = pos[p] + end_off(p, chain.parent_end[j])
        pos[c] = anchor - end_off(c, chain.child_end[j])
    return tuple((float(p[0]), float(p[1])) for p in pos)


@dataclasses.dataclass(frozen=True)
class PlanarLayout:
    """The packed state of a B-body chain: (n, 6·B + 1) float32 rows."""

    n_bodies: int

    def q(self, states: torch.Tensor) -> torch.Tensor:
        """(n, B, 3) view: x, y, θ."""
        return states[:, :3 * self.n_bodies].view(-1, self.n_bodies, 3)

    def qd(self, states: torch.Tensor) -> torch.Tensor:
        """(n, B, 3) view: ẋ, ẏ, ω."""
        return states[:, 3 * self.n_bodies:6 * self.n_bodies].view(-1, self.n_bodies, 3)

    def t(self, states: torch.Tensor) -> torch.Tensor:
        """(n,) view: the step count."""
        return states[:, 6 * self.n_bodies]

    def pos(self, states: torch.Tensor) -> torch.Tensor:
        return self.q(states)[..., :2]

    def theta(self, states: torch.Tensor) -> torch.Tensor:
        return self.q(states)[..., 2]

    def vel(self, states: torch.Tensor) -> torch.Tensor:
        return self.qd(states)[..., :2]

    def omega(self, states: torch.Tensor) -> torch.Tensor:
        return self.qd(states)[..., 2]

    def pack(self, q: torch.Tensor, qd: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        n = q.shape[0]
        return torch.cat([q.reshape(n, -1), qd.reshape(n, -1), t.reshape(n, 1)], dim=1)

    def pack_fields(self, pos, theta, vel, omega, t) -> torch.Tensor:
        """Rows from the JAX state's fields, batched: pos (n, B, 2), theta
        (n, B), vel (n, B, 2), omega (n, B), t (n,)."""
        q = torch.cat([pos, theta[..., None]], dim=-1)
        qd = torch.cat([vel, omega[..., None]], dim=-1)
        return self.pack(q, qd, t.to(q.dtype))


class _Consts(NamedTuple):
    """A chain's constant tensors on one device, float32 (indices int64)."""

    anchor_body: torch.Tensor  # (A,) the body of each anchor: joint parents,
    # joint children, then (ground only) every body's -1 end and +1 end
    anchor_lx: torch.Tensor  # (A,) the anchor's end·half_len along the rod
    pj: torch.Tensor  # (J,) parent body of each joint
    cj: torch.Tensor  # (J,) child body of each joint
    m_eff: torch.Tensor  # (J,)
    i_red: torch.Tensor  # (J,) the joint's reduced inertia
    rest: torch.Tensor  # (J,)
    lo: torch.Tensor  # (J,)
    hi: torch.Tensor  # (J,)
    gear: torch.Tensor  # (J,)
    slots: torch.Tensor  # (B, K) rows of [parent terms; child terms; zero]
    # each body adds, in order (the zero row pads bodies with fewer)
    acc0: torch.Tensor  # (B, 3) force and torque before any term: (0, m·g, 0)
    div: torch.Tensor  # (B, 3) (m, m, I): the Euler step's divisors
    mass2: torch.Tensor  # (2B,) each body's mass, for its two ends
    two_half: torch.Tensor  # (B,) rod length 2·half_len
    two_half_cubed: torch.Tensor  # (B,) (2·half_len)³, as x·(x·x)
    perp: torch.Tensor  # (2,) (-1, +1): ω × (x, y) = (-ω·y, ω·x)


def _make_consts(ch: _Chain, device: torch.device) -> _Consts:
    def f32(x):
        return torch.tensor(x, dtype=torch.float32)

    n_b, n_j = ch.n_bodies, ch.n_joints
    mass, half = f32(ch.mass), f32(ch.half_len)
    two_half = 2 * half
    inertia = mass * two_half**2 / 12.0 + 1e-6  # rod about its center
    pj = torch.tensor(ch.parent, dtype=torch.int64)
    cj = torch.tensor(ch.child, dtype=torch.int64)
    body = [pj, cj]
    lx = [f32(ch.parent_end) * half[pj], f32(ch.child_end) * half[cj]]
    if ch.ground:
        ends = torch.arange(n_b)
        body += [ends, ends]
        lx += [-1.0 * half, 1.0 * half]
    # slot rows index the stack [parent terms (J); child terms (J); zeros]
    rows = [[j for j in range(n_j) if ch.parent[j] == b]
            + [n_j + j for j in range(n_j) if ch.child[j] == b] for b in range(n_b)]
    width = max(len(r) for r in rows)
    slots = torch.tensor([r + [2 * n_j] * (width - len(r)) for r in rows], dtype=torch.int64)
    zeros = torch.zeros_like(mass)
    consts = _Consts(
        anchor_body=torch.cat(body), anchor_lx=torch.cat(lx), pj=pj, cj=cj,
        m_eff=torch.minimum(mass[pj], mass[cj]),
        i_red=inertia[pj] * inertia[cj] / (inertia[pj] + inertia[cj]),
        rest=f32(ch.rest_angle), lo=f32(ch.limit_lo), hi=f32(ch.limit_hi), gear=f32(ch.gear),
        slots=slots, acc0=torch.stack([zeros, mass * ch.gravity, zeros], dim=1),
        div=torch.stack([mass, mass, inertia], dim=1), mass2=torch.cat([mass, mass]),
        two_half=two_half, two_half_cubed=two_half * (two_half * two_half),
        perp=f32((-1.0, 1.0)),
    )
    return _Consts(*(t.to(device) for t in consts))


def _scaled_consts(ch: _Chain, k: _Consts, params) -> tuple[_Consts, object]:
    """``k`` with the members' drawn scales applied, and the friction
    coefficient's negation: each constant that a drawn scale reaches
    becomes an ``(n, ·)`` tensor, computed as the JAX package's
    ``_scenario_chain`` + ``_physics_step`` compute it (the inertia from
    the scaled masses: it is not linear in the scale)."""
    mass_s = params.get("mass_scale")
    grav_s = params.get("gravity_scale")
    fric_s = params.get("friction_scale")
    gear_s = params.get("gear_scale")
    mass = k.div[:, 0]
    if mass_s is not None:
        mass = mass * mass_s[:, None]
        inertia = mass * k.two_half**2 / 12.0 + 1e-6  # rod about its center
        ip, ic = inertia[:, k.pj], inertia[:, k.cj]
        k = k._replace(m_eff=torch.minimum(mass[:, k.pj], mass[:, k.cj]),
                       i_red=ip * ic / (ip + ic),
                       div=torch.stack([mass, mass, inertia], dim=-1),
                       mass2=torch.cat([mass, mass], dim=-1))
    if mass_s is not None or grav_s is not None:
        gravity = ch.gravity if grav_s is None else (ch.gravity * grav_s)[:, None]
        weight = mass * gravity
        zeros = torch.zeros_like(weight)
        k = k._replace(acc0=torch.stack([zeros, weight, zeros], dim=-1))
    if gear_s is not None:
        k = k._replace(gear=k.gear * gear_s[:, None])
    neg_friction = -ch.friction if fric_s is None else -(ch.friction * fric_s)[:, None]
    return k, neg_friction


def _physics_step(ch: _Chain, k: _Consts, q: torch.Tensor, qd: torch.Tensor,
                  t_act: torch.Tensor, neg_friction=None):
    """One semi-implicit Euler step of every member's chain: q, qd (n, B, 3),
    the joints' motor torques ``t_act`` (n, J), ``neg_friction`` the
    friction coefficient negated (a Python float, by default the chain's, or
    (n, 1) per member).
    The constants in ``k`` are the chain's ``(·)`` tensors or, under a
    scenario draw, ``(n, ·)`` ones.  Returns the new (q, qd)."""
    n_j = k.pj.shape[0]
    n_b = q.shape[1]
    if neg_friction is None:
        neg_friction = -ch.friction
    theta, omega = q[..., 2], qd[..., 2]
    cs = torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)  # (n, B, 2)

    # force (x, y) and torque of each body, accumulated in JAX's order:
    # gravity, drag, joint terms as parent, as child, contact at end -1, +1
    if ch.drag:
        # anisotropic rod drag: the normal component resisted ~30x the axial
        vel = qd[..., :2]
        v_ax = torch.sum(vel * cs, dim=-1, keepdim=True) * cs
        v_nrm = vel - v_ax
        drag = torch.cat([ch.drag * (0.1 * v_ax + 3.0 * v_nrm) * k.two_half[:, None],
                          (ch.angular_drag * omega * k.two_half_cubed)[..., None]], dim=-1)
        acc = k.acc0 - drag
    else:
        acc = k.acc0

    # every anchor: world point w = pos + R(θ)·(lx, 0), lever r = w − pos,
    # world velocity v = vel + ω × r
    qa = q[:, k.anchor_body]
    qda = qd[:, k.anchor_body]
    pos_a = qa[..., :2]
    w = pos_a + cs[:, k.anchor_body] * k.anchor_lx[:, None]
    r = w - pos_a
    v = qda[..., :2] + torch.flip(r, dims=(-1,)) * qda[..., 2:] * k.perp

    # joints: a spring-damper pulling the anchors together, then the limit,
    # motor and damping torques, equal and opposite on the pair
    a_w, b_w = w[:, :n_j], w[:, n_j:2 * n_j]
    a_r, b_r = r[:, :n_j], r[:, n_j:2 * n_j]
    f_j = (-ch.k_joint * (a_w - b_w) - ch.c_joint * (v[:, :n_j] - v[:, n_j:2 * n_j])) \
        * k.m_eff[..., None]
    qj = qa[:, n_j:2 * n_j, 2] - qa[:, :n_j, 2] - k.rest
    qdot = qda[:, n_j:2 * n_j, 2] - qda[:, :n_j, 2]
    t_lim = (
        ch.k_limit * (torch.clamp(k.lo - qj, min=0.0) - torch.clamp(qj - k.hi, min=0.0))
        - ch.c_limit * qdot * ((qj < k.lo) | (qj > k.hi))
    ) * k.i_red
    t_damp = -ch.joint_damping * qdot * k.i_red
    t_pair = t_lim + t_act + t_damp
    fx, fy = f_j[..., 0], f_j[..., 1]
    cross_a = a_r[..., 0] * fy - a_r[..., 1] * fx
    cross_b = b_r[..., 0] * (-fy) - b_r[..., 1] * (-fx)
    terms = torch.cat([
        torch.stack([fx, fy, cross_a - t_pair], dim=-1),
        torch.stack([-fx, -fy, cross_b + t_pair], dim=-1),
        torch.zeros((q.shape[0], 1, 3), dtype=q.dtype, device=q.device),
    ], dim=1)[:, k.slots]  # (n, B, K, 3)
    for slot in range(terms.shape[2]):
        acc = acc + terms[:, :, slot]

    # ground contact at both rod ends (penalty + regularized friction)
    if ch.ground:
        w_g, r_g, v_g = w[:, 2 * n_j:], r[:, 2 * n_j:], v[:, 2 * n_j:]
        depth = torch.clamp(w_g[..., 1], max=0.0)  # ≤ 0 when penetrating
        pen = depth < 0
        fn = (-ch.k_contact * depth - ch.c_contact * v_g[..., 1] * pen) * k.mass2
        fn = torch.clamp(fn, min=0.0) * pen
        ft = neg_friction * fn * torch.tanh(v_g[..., 0] / 0.1)
        # force += (ft, fn); torque += r_x·fn, then −= r_y·ft
        plus = torch.stack([ft, fn, r_g[..., 0] * fn], dim=-1)
        minus = r_g[..., 1] * ft
        for end in (slice(0, n_b), slice(n_b, 2 * n_b)):
            acc = acc + plus[:, end]
            acc[..., 2] -= minus[:, end]

    # semi-implicit Euler
    qd = qd + ch.dt * acc / k.div
    q = q + ch.dt * qd
    return q, qd


class _PlanarBase:
    """Shared plumbing over a ``_Chain``; subclasses define the chain and set
    the obs/reward knobs below (or override ``_obs``, as the swimmer does).

    Class-level knobs: ``upright_offset`` (torso rest angle, subtracted in
    the obs and the lean reference for termination), ``alive_bonus`` and
    ``ctrl_cost`` (reward shaping), ``min_height`` / ``max_lean`` (falling
    termination; ``None`` → never terminates).
    """

    chain: _Chain
    discrete: bool = False
    action_bound: float = 1.0
    upright_offset: float = 0.0
    alive_bonus: float = 0.0
    ctrl_cost: float = 1e-3
    min_height = None
    max_lean = None
    # stricter than max_lean: ~20° of lean is a standing or walking posture
    upright_lean: float = 0.35

    # the chain's constants are per-body and per-joint tuples tuned together
    # for the integrator's stability, so a scenario draws multiplicative
    # scales of them (default 1.0), as in the JAX package
    SCENARIO_FIELDS = ("gravity_scale", "mass_scale", "friction_scale", "gear_scale")

    def scenario_defaults(self) -> dict:
        return {n: 1.0 for n in self.SCENARIO_FIELDS}

    def _finalize_chain(self, chain: _Chain):
        """Snap init positions to the joint graph and install the chain."""
        chain = dataclasses.replace(chain, init_pos=_solve_init_positions(chain))
        object.__setattr__(self, "chain", chain)
        object.__setattr__(self, "layout", PlanarLayout(chain.n_bodies))
        object.__setattr__(self, "_consts_by_device", {})

    def _consts(self, device: torch.device) -> _Consts:
        cache = self._consts_by_device
        if device not in cache:
            cache[device] = _make_consts(self.chain, device)
        return cache[device]

    @property
    def control_dt(self):
        return self.chain.dt * self.chain.frame_skip

    def _obs(self, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
        """Standard runner observation: torso height and lean, joint angles,
        torso velocity and spin, joint rates (the MuJoCo runner layout)."""
        return torch.cat([
            q[:, 0, 1:2],
            q[:, 0, 2:3] - self.upright_offset,
            _joint_angles(self, q),
            qd[:, 0, :2] * 0.3,
            qd[:, 0, 2:3] * 0.1,
            _joint_rates(self, qd) * 0.1,
        ], dim=1)

    def observe(self, states: torch.Tensor) -> torch.Tensor:
        return self._obs(self.layout.q(states), self.layout.qd(states))

    def reset(self, generator: torch.Generator, n: int):
        """The chain's init pose; θ += 0.01·N(0, 1) and vel = 0.01·N(0, 1)
        per body (MuJoCo-style reset noise), ω = 0, t = 0."""
        ch, dev = self.chain, generator.device
        b = ch.n_bodies
        theta = torch.tensor(ch.init_angle, dtype=torch.float32, device=dev) + 0.01 * torch.randn(
            (n, b), generator=generator, dtype=torch.float32, device=dev)
        vel = 0.01 * torch.randn((n, b, 2), generator=generator, dtype=torch.float32, device=dev)
        pos = torch.tensor(ch.init_pos, dtype=torch.float32, device=dev).expand(n, b, 2)
        states = self.layout.pack_fields(pos, theta, vel, torch.zeros_like(theta),
                                         torch.zeros((n,), device=dev))
        return states, self.observe(states)

    def step(self, states: torch.Tensor, actions: torch.Tensor):
        return self.step_p(None, states, actions)

    def step_p(self, params, states: torch.Tensor, actions: torch.Tensor):
        """One dynamics definition for both forms: ``params`` None (the
        chain's cached constants) or each member's drawn scales, applied
        once here, outside the ``frame_skip`` loop."""
        ch, lay = self.chain, self.layout
        k = self._consts(states.device)
        neg_friction = -ch.friction
        if params is not None and any(name in params for name in self.SCENARIO_FIELDS):
            k, neg_friction = _scaled_consts(ch, k, params)
        act = torch.clamp(actions.reshape(states.shape[0], -1), -1.0, 1.0)
        t_act = k.gear * act * k.i_red  # the same in every physics step
        q0, qd0 = lay.q(states), lay.qd(states)
        q, qd = q0, qd0
        for _ in range(ch.frame_skip):
            q, qd = _physics_step(ch, k, q, qd, t_act, neg_friction)
        new_states = lay.pack(q, qd, lay.t(states) + 1.0)
        reward, done = self._reward_done(q0, q, act)
        return new_states, self._obs(q, qd), reward, done

    def _reward_done(self, q_prev: torch.Tensor, q: torch.Tensor, act: torch.Tensor):
        vx = (q[:, 0, 0] - q_prev[:, 0, 0]) / self.control_dt
        reward = self.alive_bonus + vx - self.ctrl_cost * torch.sum(act**2, dim=1)
        if self.min_height is None:
            return reward, torch.zeros_like(reward, dtype=torch.bool)
        lean = torch.abs(q[:, 0, 2] - self.upright_offset)
        done = (q[:, 0, 1] < self.min_height) | (lean > self.max_lean)
        return reward, done

    def behavior(self, states: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
        """BC = final torso (x, y): where the gait carried the body."""
        return self.layout.pos(states)[:, 0]

    # ---- gait metrics: m/s and %-upright, not reward units ----

    @property
    def metric_names(self) -> tuple:
        return ("upright_fraction",)

    def step_metrics(self, states: torch.Tensor) -> torch.Tensor:
        """(n, 1) per-step gait accumulables, summed alive-masked by the
        rollout (``make_batched_rollout(with_env_metrics=True)``)."""
        if self.max_lean is None:
            # horizontal-body runners (swimmer, cheetah) have no upright
            # posture to lose: 1, so the fraction reads "n/a-upright"
            return torch.ones((states.shape[0], 1), dtype=torch.float32, device=states.device)
        lean = torch.abs(self.layout.theta(states)[:, 0] - self.upright_offset)
        return (lean < self.upright_lean).to(torch.float32)[:, None]

    def episode_metrics(self, bc, steps, sums) -> dict:
        """Episode gait summary from one episode's (bc, steps, metric sums):
        ``forward_velocity_mps`` is (final torso x − initial x) / alive
        time (reset noise leaves x alone), ``upright_fraction`` the alive
        steps' share with the torso within ``upright_lean``."""
        steps = max(int(steps), 1)
        t = steps * float(self.control_dt)
        x0 = float(self.chain.init_pos[0][0])
        return {
            "upright_fraction": float(sums[0]) / steps,
            "forward_velocity_mps": (float(bc[0]) - x0) / t,
        }


def _joint_angles(env: _PlanarBase, q: torch.Tensor) -> torch.Tensor:
    k = env._consts(q.device)
    theta = q[..., 2]
    return theta[:, k.cj] - theta[:, k.pj] - k.rest


def _joint_rates(env: _PlanarBase, qd: torch.Tensor) -> torch.Tensor:
    k = env._consts(qd.device)
    omega = qd[..., 2]
    return omega[:, k.cj] - omega[:, k.pj]


@dataclasses.dataclass(frozen=True)
class Swimmer2D(_PlanarBase):
    """3-link planar swimmer in a viscous medium (MuJoCo Swimmer-class):
    contact-free and gravity-free, propelled by anisotropic drag on the
    undulating chain.  Reward: head forward velocity − control cost."""

    n_links: int = 3
    obs_dim: int = 10  # 2·n_links angles/rates + head vel (2) + joint angles
    action_dim: int = 2  # n_links − 1
    default_horizon: int = 500
    bc_dim: int = 2

    def __post_init__(self):
        n = self.n_links
        hl = 0.5
        chain = _Chain(
            mass=(1.0,) * n,
            half_len=(hl,) * n,
            init_pos=tuple((-(2 * hl) * i, 0.0) for i in range(n)),
            init_angle=(0.0,) * n,
            parent=tuple(range(n - 1)),
            child=tuple(range(1, n)),
            parent_end=(-1.0,) * (n - 1),  # tail of parent…
            child_end=(1.0,) * (n - 1),  # …to tip of child
            rest_angle=(0.0,) * (n - 1),
            limit_lo=(-1.75,) * (n - 1),
            limit_hi=(1.75,) * (n - 1),
            gear=(300.0,) * (n - 1),
            gravity=0.0,
            ground=False,
            drag=4.0,
            angular_drag=2.0,
            c_joint=30.0,
            dt=0.002,
            frame_skip=10,
        )
        self._finalize_chain(chain)
        object.__setattr__(self, "obs_dim", 2 * (n - 1) + n + 2)
        object.__setattr__(self, "action_dim", n - 1)

    ctrl_cost = 1e-4

    def _obs(self, q: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
        return torch.cat([
            _joint_angles(self, q),
            _joint_rates(self, qd) * 0.1,
            q[..., 2],  # absolute link angles (heading)
            qd[:, 0, :2] * 0.5,  # head velocity
        ], dim=1)


@dataclasses.dataclass(frozen=True)
class Hopper2D(_PlanarBase):
    """Planar one-legged hopper (MuJoCo Hopper-class): torso–thigh–shin–foot,
    ground contact and gravity, terminates when the torso falls.  Reward:
    alive bonus + forward velocity − control cost."""

    obs_dim: int = 11
    action_dim: int = 3
    default_horizon: int = 500
    bc_dim: int = 2

    def __post_init__(self):
        # bodies: 0 torso (upright rod), 1 thigh, 2 shin, 3 foot (horizontal)
        chain = _Chain(
            mass=(3.5, 1.0, 1.0, 0.6),
            half_len=(0.2, 0.2, 0.25, 0.13),
            init_pos=((0.0, 1.05), (0.0, 0.65), (0.0, 0.2), (0.06, -0.05)),
            init_angle=(math.pi / 2, math.pi / 2, math.pi / 2, 0.0),
            parent=(0, 1, 2),
            child=(1, 2, 3),
            parent_end=(-1.0, -1.0, -1.0),
            child_end=(1.0, 1.0, -1.0),
            rest_angle=(0.0, 0.0, -math.pi / 2),
            limit_lo=(-0.3, -1.5, -0.6),
            limit_hi=(1.5, 0.1, 0.6),
            gear=(800.0, 800.0, 500.0),
            gravity=-9.81,
            ground=True,
            dt=0.002,
            frame_skip=8,
        )
        self._finalize_chain(chain)

    upright_offset = math.pi / 2
    alive_bonus = 1.0
    min_height = 0.6
    max_lean = 0.7


@dataclasses.dataclass(frozen=True)
class Walker2D(_PlanarBase):
    """Planar biped walker (MuJoCo Walker2d-class): torso + two hopper legs,
    7 bodies, 6 actuated joints, terminates when the torso falls.  Reward:
    alive bonus + forward velocity − control cost."""

    obs_dim: int = 17
    action_dim: int = 6
    default_horizon: int = 500
    bc_dim: int = 2

    def __post_init__(self):
        # bodies: 0 torso (upright); 1-3 left thigh/shin/foot; 4-6 right.
        chain = _Chain(
            mass=(3.5, 1.0, 1.0, 0.6, 1.0, 1.0, 0.6),
            half_len=(0.2, 0.2, 0.25, 0.13, 0.2, 0.25, 0.13),
            init_pos=((0.0, 1.05),) + ((0.0, 0.0),) * 6,
            init_angle=(
                math.pi / 2,
                math.pi / 2 + 0.08, math.pi / 2 - 0.16, 0.0,
                math.pi / 2 - 0.08, math.pi / 2 - 0.02, 0.0,
            ),
            parent=(0, 1, 2, 0, 4, 5),
            child=(1, 2, 3, 4, 5, 6),
            parent_end=(-1.0, -1.0, -1.0, -1.0, -1.0, -1.0),
            child_end=(1.0, 1.0, -1.0, 1.0, 1.0, -1.0),
            rest_angle=(0.0, 0.0, -math.pi / 2, 0.0, 0.0, -math.pi / 2),
            limit_lo=(-1.0, -1.5, -0.6, -1.0, -1.5, -0.6),
            limit_hi=(1.0, 0.1, 0.6, 1.0, 0.1, 0.6),
            gear=(800.0, 800.0, 500.0, 800.0, 800.0, 500.0),
            gravity=-9.81,
            ground=True,
            dt=0.002,
            frame_skip=8,
        )
        self._finalize_chain(chain)

    upright_offset = math.pi / 2
    alive_bonus = 1.0
    min_height = 0.7
    max_lean = 1.0


@dataclasses.dataclass(frozen=True)
class Humanoid2D(_PlanarBase):
    """Planar humanoid (Humanoid-class stand-in): 11 bodies, 10 joints —
    pelvis, two legs, abdomen to torso, neck to head, two free-swinging
    arms.  Terminates when the pelvis drops or the body leans past ~57°.
    Reward: alive + forward velocity − control cost."""

    obs_dim: int = 25
    action_dim: int = 10
    default_horizon: int = 500
    bc_dim: int = 2

    def __post_init__(self):
        # bodies: 0 pelvis, 1 torso, 2 head, 3 larm, 4 rarm,
        #         5 lthigh, 6 lshin, 7 lfoot, 8 rthigh, 9 rshin, 10 rfoot
        chain = _Chain(
            mass=(3.0, 3.0, 0.8, 0.8, 0.8, 1.0, 1.0, 0.6, 1.0, 1.0, 0.6),
            half_len=(0.15, 0.2, 0.08, 0.18, 0.18,
                      0.2, 0.25, 0.13, 0.2, 0.25, 0.13),
            init_pos=((0.0, 1.0),) + ((0.0, 0.0),) * 10,
            init_angle=(
                math.pi / 2, math.pi / 2, math.pi / 2,            # column
                math.pi / 2 + 0.1, math.pi / 2 - 0.1,             # arms
                math.pi / 2 + 0.08, math.pi / 2 - 0.16, 0.0,      # left leg
                math.pi / 2 - 0.08, math.pi / 2 - 0.02, 0.0,      # right leg
            ),
            #        abdomen neck  lshld rshld lhip  lknee lankl rhip rknee rankl
            parent=(0, 1, 1, 1, 0, 5, 6, 0, 8, 9),
            child=(1, 2, 3, 4, 5, 6, 7, 8, 9, 10),
            parent_end=(1.0, 1.0, 1.0, 1.0, -1.0,
                        -1.0, -1.0, -1.0, -1.0, -1.0),
            child_end=(-1.0, -1.0, 1.0, 1.0, 1.0, 1.0, -1.0, 1.0, 1.0, -1.0),
            rest_angle=(0.0, 0.0, 0.0, 0.0, 0.0, 0.0, -math.pi / 2,
                        0.0, 0.0, -math.pi / 2),
            limit_lo=(-0.5, -0.5, -1.5, -1.5, -1.0, -1.5, -0.6,
                      -1.0, -1.5, -0.6),
            limit_hi=(0.5, 0.5, 1.5, 1.5, 1.0, 0.1, 0.6, 1.0, 0.1, 0.6),
            gear=(400.0, 100.0, 200.0, 200.0, 800.0, 800.0, 500.0,
                  800.0, 800.0, 500.0),
            gravity=-9.81,
            ground=True,
            dt=0.002,
            frame_skip=8,
        )
        self._finalize_chain(chain)

    upright_offset = math.pi / 2
    alive_bonus = 1.0
    min_height = 0.75
    max_lean = 1.0


@dataclasses.dataclass(frozen=True)
class Cheetah2D(_PlanarBase):
    """Planar two-legged runner (MuJoCo HalfCheetah-class): 7 bodies, never
    terminates.  Reward: forward velocity − control cost."""

    obs_dim: int = 17
    action_dim: int = 6
    default_horizon: int = 500
    bc_dim: int = 2

    def __post_init__(self):
        # 0 torso (horizontal), 1 bthigh, 2 bshin, 3 bfoot, 4 fthigh,
        # 5 fshin, 6 ffoot; only the torso position is trusted, the legs'
        # are solved from the joint graph
        chain = _Chain(
            mass=(6.0, 1.5, 1.2, 0.8, 1.4, 1.1, 0.7),
            half_len=(0.5, 0.15, 0.15, 0.09, 0.13, 0.12, 0.07),
            init_pos=((0.0, 0.56),) + ((0.0, 0.0),) * 6,
            init_angle=(
                0.0,
                math.pi / 2 + 0.3, math.pi / 2 - 0.5, 0.1,
                math.pi / 2 - 0.3, math.pi / 2 + 0.4, 0.0,
            ),
            parent=(0, 1, 2, 0, 4, 5),
            child=(1, 2, 3, 4, 5, 6),
            parent_end=(-1.0, -1.0, -1.0, 1.0, -1.0, -1.0),
            child_end=(1.0, 1.0, -1.0, 1.0, 1.0, -1.0),
            rest_angle=(math.pi / 2 + 0.3, -0.8, 0.6 - math.pi / 2,
                        math.pi / 2 - 0.3, 0.7, -math.pi / 2 - 0.4),
            limit_lo=(-0.6, -0.8, -0.5, -0.8, -0.7, -0.5),
            limit_hi=(1.0, 0.8, 0.5, 0.8, 0.7, 0.5),
            gear=(700.0, 500.0, 300.0, 700.0, 500.0, 300.0),
            gravity=-9.81,
            ground=True,
            dt=0.002,
            frame_skip=8,
        )
        self._finalize_chain(chain)

    ctrl_cost = 0.05


class _Wrapper:
    """Static facts, reset, behavior and the layout forwarded to ``base``."""

    base: _PlanarBase

    @property
    def obs_dim(self):
        return self.base.obs_dim

    @property
    def action_dim(self):
        return self.base.action_dim

    @property
    def discrete(self):
        return self.base.discrete

    @property
    def bc_dim(self):
        return self.base.bc_dim

    @property
    def default_horizon(self):
        return self.base.default_horizon

    @property
    def action_bound(self):
        return self.base.action_bound

    @property
    def layout(self) -> PlanarLayout:
        return self.base.layout

    def behavior(self, states, obs):
        return self.base.behavior(states, obs)


@dataclasses.dataclass(frozen=True)
class PositionOnly(_Wrapper):
    """POMDP wrapper for the planar runners: every velocity channel of the
    observation (torso velocity, spin, joint rates) is zeroed, the
    positional half (height, lean, joint angles) kept; obs_dim unchanged.
    Dynamics, reward, termination and BC are the wrapped env's."""

    base: _PlanarBase

    def __post_init__(self):
        # the mask hard-codes the standard runner layout (_obs); an env
        # that overrides _obs (Swimmer2D) would get the wrong channels zeroed
        if type(self.base)._obs is not _PlanarBase._obs:
            raise ValueError(
                f"PositionOnly supports the standard runner observation "
                f"layout; {type(self.base).__name__} overrides _obs — "
                "build its POMDP mask explicitly"
            )
        n_pos = 2 + self.base.chain.n_joints  # height+lean, joint angles
        mask = np.zeros((self.base.obs_dim,), np.float32)
        mask[:n_pos] = 1.0
        object.__setattr__(self, "_mask", mask)
        object.__setattr__(self, "_mask_by_device", {})

    def _masked(self, obs: torch.Tensor) -> torch.Tensor:
        cache = self._mask_by_device
        if obs.device not in cache:
            cache[obs.device] = torch.from_numpy(self._mask).to(obs.device)
        return obs * cache[obs.device]

    def observe(self, states):
        return self._masked(self.base.observe(states))

    def reset(self, generator, n):
        states, obs = self.base.reset(generator, n)
        return states, self._masked(obs)

    def step(self, states, actions):
        nstates, obs, reward, done = self.base.step(states, actions)
        return nstates, self._masked(obs), reward, done


@dataclasses.dataclass(frozen=True)
class DeceptiveValley(_Wrapper):
    """Deceptive-reward wrapper for the planar runners: a reward valley along
    the progress axis (the 1-D form of the Conti et al. 2018 U-maze):

        φ(x) = x                                        x ≤ x_bait
             = x_bait − valley_slope·(x − x_bait)       x ≤ x_valley
             = φ(x_valley) + rise_slope·(x − x_valley)  beyond

    Per-step reward ``reward_scale·(φ(x_t) − φ(x_{t−1}))`` + the base's
    alive bonus − its control cost, so a return telescopes to
    ``reward_scale·(φ(x_T) − φ(x_0))`` plus the shaping.  Dynamics,
    observation, termination and BC are the wrapped env's.
    """

    base: _PlanarBase
    x_bait: float = 1.0
    x_valley: float = 3.0
    valley_slope: float = 1.5
    rise_slope: float = 4.0
    reward_scale: float = 1.0

    def __post_init__(self):
        if not (self.x_bait < self.x_valley):
            raise ValueError(
                f"need x_bait < x_valley, got {self.x_bait} >= {self.x_valley}"
            )
        if self.valley_slope <= 0 or self.rise_slope <= 0:
            raise ValueError("valley_slope and rise_slope must be positive "
                             "(a non-decreasing φ is not deceptive)")

    @property
    def control_dt(self):
        return self.base.control_dt

    def _phi(self, x: torch.Tensor) -> torch.Tensor:
        phi_valley_end = self.x_bait - self.valley_slope * (self.x_valley - self.x_bait)
        return torch.where(
            x <= self.x_bait,
            x,
            torch.where(
                x <= self.x_valley,
                self.x_bait - self.valley_slope * (x - self.x_bait),
                phi_valley_end + self.rise_slope * (x - self.x_valley),
            ),
        )

    def observe(self, states):
        return self.base.observe(states)

    def reset(self, generator, n):
        return self.base.reset(generator, n)

    def step(self, states, actions):
        nstates, obs, _, done = self.base.step(states, actions)
        act = torch.clamp(actions.reshape(states.shape[0], -1), -1.0, 1.0)
        pos = self.layout.pos
        dphi = self._phi(pos(nstates)[:, 0, 0]) - self._phi(pos(states)[:, 0, 0])
        reward = (
            self.base.alive_bonus
            + self.reward_scale * dphi
            - self.base.ctrl_cost * torch.sum(act**2, dim=1)
        )
        return nstates, obs, reward, done

    # gait metrics delegate: velocity and upright read dynamics, not reward
    @property
    def metric_names(self):
        return self.base.metric_names

    def step_metrics(self, states):
        return self.base.step_metrics(states)

    def episode_metrics(self, bc, steps, sums):
        return self.base.episode_metrics(bc, steps, sums)
