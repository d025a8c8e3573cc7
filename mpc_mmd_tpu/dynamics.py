"""Bicycle-kinematics rollouts under stochastic control noise.

Design notes
------------
* One flat rollout over time drives *all* rollout lanes at once
  (candidates x noise-samples x scenarios are a single leading batch axis),
  instead of the reference's vmap-of-per-candidate-scan
  (``synthetic_static_obs/optimizer/cem_helper.py:402-538``).  On the GPU it
  is one Pallas kernel (ops/rollout_triton.py); the plain form is a
  ``lax.scan`` whose step is a handful of fused element-wise ops.
* The state is a (B, 5) array [x, y, vx, vy, psi]; positions are accumulated
  into pre-laid-out (T, B) stacks by the scan (transposed once at the end),
  avoiding the reference's per-step ``.at[:, idx].set`` scatter pattern.
* Noise models mirror the reference semantics exactly
  (cem_helper.py:402-443): multiplicative gaussian sigma*|u|*N(0,1),
  beta sigma*(2*Beta(2|u|,5|u|)-1) with steer scaled by K_steer, plus a
  *shared* additive N(0,1) const-noise draw applied to both acc and steer
  (the same samples — a quirk of the reference we reproduce).

Reference behavior cites: cem_helper.py:380-400 (one-step kinematics),
402-464 (baseline rollouts), 466-538 (mother-set rollouts),
validation.py:21-40 (independent numpy oracle mirrored in tests).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from .config import NoiseConfig


def bicycle_step(x, y, vx, vy, psi, acc, steer, dt: float,
                 wheel_base: float):
    """One Euler step of bicycle kinematics on per-lane arrays; returns
    (x, y, vx, vy, psi) after the step.  Ref: cem_helper.py:380-400."""
    v = jnp.sqrt(vx * vx + vy * vy) + acc * dt
    psi_next = psi + v * jnp.tan(steer) / wheel_base * dt
    vx_next = v * jnp.cos(psi_next)
    vy_next = v * jnp.sin(psi_next)
    return (x + vx_next * dt, y + vy_next * dt, vx_next, vy_next, psi_next)


def step(acc: jnp.ndarray, steer: jnp.ndarray, state: jnp.ndarray,
         dt: float, wheel_base: float) -> jnp.ndarray:
    """One Euler step of bicycle kinematics for a batch of states.

    state: (B, 5) rows [x, y, vx, vy, psi]; acc/steer: (B,).
    """
    return jnp.stack(bicycle_step(*(state[:, i] for i in range(5)), acc,
                                  steer, dt, wheel_base), axis=1)


def rollout(acc: jnp.ndarray, steer: jnp.ndarray, state0: jnp.ndarray,
            dt: float, wheel_base: float) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Roll ``T`` steps for ``B`` lanes; returns x, y position stacks (B, T).

    acc, steer: (B, T) noisy control sequences.  state0: (B, 5) or (5,).
    The t-th output row records the state *before* applying controls[t]
    (matching the reference's record-then-step loop, cem_helper.py:451-461).
    Runs the implementation the kernel table (:mod:`mpc_mmd_tpu.ops`) picks
    for the platform: the Triton kernel on the GPU, :func:`rollout_scan` on
    the CPU.
    """
    from .ops import dispatch
    from .ops.rollout_triton import rollout_triton
    return dispatch("rollout", {
        "xla": partial(rollout_scan, dt=dt, wheel_base=wheel_base),
        "triton": partial(rollout_triton, dt=dt, wheel_base=wheel_base),
    }, acc, steer, state0)


def rollout_scan(acc: jnp.ndarray, steer: jnp.ndarray, state0: jnp.ndarray,
                 dt: float, wheel_base: float
                 ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Plain-XLA :func:`rollout`: one ``lax.scan`` over time."""
    if state0.ndim == 1:
        state0 = jnp.broadcast_to(state0[None, :], (acc.shape[0], state0.shape[0]))

    def body(state, ut):
        a_t, s_t = ut
        pos = state[:, 0:2]
        return step(a_t, s_t, state, dt, wheel_base), pos

    # scan over time-major controls: (T, B)
    _, pos_stack = lax.scan(body, state0, (acc.T, steer.T))
    # pos_stack: (T, B, 2) -> (B, T) x 2
    return pos_stack[:, :, 0].T, pos_stack[:, :, 1].T


# ---------------------------------------------------------------------------
# Noise models
# ---------------------------------------------------------------------------

def perturb_controls(key: jax.Array, acc: jnp.ndarray, steer: jnp.ndarray,
                     n_samples: int, noise: NoiseConfig
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Draw ``n_samples`` noisy variants of one (T,) control sequence.

    Returns (acc_noisy, steer_noisy), each (n_samples, T).  RNG consumption
    order matches the reference exactly (three key uses: acc noise, steer
    noise after one split, shared const noise after another split) so that
    solves are bit-comparable; see cem_helper.py:402-443.
    """
    T = acc.shape[-1]

    if noise.kind == "gaussian":
        eps_acc = jax.random.multivariate_normal(
            key, jnp.zeros(T), jnp.eye(T), (n_samples,))
        key, _ = jax.random.split(key)
        eps_steer = jax.random.multivariate_normal(
            key, jnp.zeros(T), jnp.eye(T), (n_samples,))
        acc_pert = noise.level * jnp.abs(acc) * eps_acc
        steer_pert = noise.level * jnp.abs(steer) * eps_steer
    else:  # beta
        # Beta(a|u|, b|u|) with a 1e-8 floor on |u|.  The reference's
        # unguarded form (cem_helper.py:427-436) only works by accident: its
        # linalg.solve projection leaves ~1e-8 boundary-constraint dirt, so
        # steer(0) is never EXACTLY zero and Beta(~1e-8, ~1e-8) degenerates
        # to a Bernoulli(a/(a+b)) coin flip on {0, 1} (pert = +-level).  Our
        # prefactored KKT elimination satisfies the boundary rows exactly,
        # making steer(0) == 0.0 for every candidate — Beta(0, 0) == NaN
        # would poison the whole solve.  The floor reproduces the
        # reference's de facto t=0 behavior instead of its latent NaN.
        a_g = jnp.abs(acc) + 1e-8
        s_g = jnp.abs(steer) + 1e-8
        b_acc = jax.random.beta(key, noise.beta_a * a_g,
                                noise.beta_b * a_g, (n_samples, T))
        key, _ = jax.random.split(key)
        b_steer = jax.random.beta(key, noise.beta_a * s_g,
                                  noise.beta_b * s_g, (n_samples, T))
        acc_pert = noise.level * (2.0 * b_acc - 1.0)
        steer_pert = noise.k_steer * noise.level * (2.0 * b_steer - 1.0)

    key, _ = jax.random.split(key)
    eps_const = jax.random.multivariate_normal(
        key, jnp.zeros(T), jnp.eye(T), (n_samples,))

    # Reference quirk: the SAME const-noise draw perturbs both channels.
    acc_noisy = acc + acc_pert + noise.acc_const * eps_const
    steer_noisy = steer + steer_pert + noise.steer_const * eps_const
    return acc_noisy, steer_noisy


def mother_product(acc_noisy: jnp.ndarray, steer_noisy: jnp.ndarray
                   ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Outer-product expansion: k acc-draws x k steer-draws -> k^2 pairs.

    Row m of the output pairs acc row m//k with steer row m%k, matching the
    reference's repeat/tile layout (cem_helper.py:510-511) so downstream
    reduced-set indices line up.
    """
    k = acc_noisy.shape[0]
    acc_m = jnp.repeat(acc_noisy, k, axis=0)
    steer_m = jnp.tile(steer_noisy, (k, 1))
    return acc_m, steer_m


def controls_from_trajectory(xdot: jnp.ndarray, ydot: jnp.ndarray,
                             xddot: jnp.ndarray, yddot: jnp.ndarray,
                             dt: float, wheel_base: float
                             ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Extract (acc, steer) along a differentially-flat trajectory batch.

    acc via forward finite-difference of speed (edge-padded), steer via
    curvature kappa = (ydd*xd - yd*xdd)/v^3 and steer = atan(kappa*L).
    Ref: cem_helper.py:540-551.  Inputs are (..., T).
    """
    v = jnp.sqrt(xdot ** 2 + ydot ** 2)
    v_ext = jnp.concatenate((v, v[..., -1:]), axis=-1)
    acc = jnp.diff(v_ext, axis=-1) / dt
    acc = jnp.concatenate((acc, acc[..., -1:]), axis=-1)[..., : v.shape[-1]]

    curvature = (yddot * xdot - ydot * xddot) / ((xdot ** 2 + ydot ** 2) ** 1.5)
    steer = jnp.arctan(curvature * wheel_base)
    return acc, steer


def constant_velocity_obstacles(x0: jnp.ndarray, y0: jnp.ndarray,
                                vx: jnp.ndarray, vy: jnp.ndarray,
                                psi: jnp.ndarray, tot_time: jnp.ndarray
                                ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Constant-velocity obstacle trajectory extrapolation.

    Ref: cem_helper.py:366-378.  Inputs (num_obs,), tot_time (num,);
    outputs (num_obs, num).
    """
    x_traj = x0[:, None] + vx[:, None] * tot_time[None, :]
    y_traj = y0[:, None] + vy[:, None] * tot_time[None, :]
    psi_traj = jnp.broadcast_to(psi[:, None], x_traj.shape)
    return x_traj, y_traj, psi_traj
