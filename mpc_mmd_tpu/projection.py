"""Alternating-minimization feasibility projection (batched QP).

Projects a batch of Bernstein-coefficient trajectories onto velocity,
acceleration and lane constraints (plus elliptical obstycle constraints in the
deterministic variant) using the polar reformulation d*[cos a, sin a] and an
augmented-Lagrangian multiplier update.

Design notes
------------
* Both KKT matrices are constant, so each AM iteration is two matmuls
  (the prefactored inverses from :mod:`mpc_mmd_tpu.qp`) plus element-wise
  trig — no per-iteration linear solves.
* The stochastic variant (the one every risk-aware mode uses) drops the
  obstacle penalty from the QP entirely; the reference still computes the
  full (batch, num*num_obs) obstacle polar decomposition each iteration even
  though its result never feeds back (``projection.py:52-121,193-274`` with
  the rho_obs rows commented out).  We skip that work — obstacle handling
  lives in the risk cost.  The deterministic baseline
  (``carla/optimizer/projection_det.py``) keeps the obstacle terms active
  and is selected by ``ProjectionConfig.with_obstacle_terms``.

Reference parity: synthetic_static_obs/optimizer/projection.py:5-323
(stochastic), carla/optimizer/projection_det.py:5-336 (deterministic).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from .config import ProblemConfig
from .qp import Workspace, kkt_solve


class ProjectionResult(NamedTuple):
    c_x: jnp.ndarray        # (batch, nvar)
    c_y: jnp.ndarray
    x: jnp.ndarray          # (batch, num)
    y: jnp.ndarray
    xdot: jnp.ndarray
    ydot: jnp.ndarray
    xddot: jnp.ndarray
    yddot: jnp.ndarray
    res_norm: jnp.ndarray   # (batch,) accel+vel+lane residual norm
    lamda_x: jnp.ndarray    # (batch, nvar) warm-started multipliers
    lamda_y: jnp.ndarray
    s_lane: jnp.ndarray     # (batch, 2*(num-1)) lane slack
    steering: jnp.ndarray   # (batch, num) Frenet steering (zeros off-path)
    kappa_interp: jnp.ndarray  # (batch, num) path curvature at x (zeros off-path)


def _polar_clip(wx, wy, rho, lo, hi, unwrap: bool):
    """Polar decomposition with radius clipping: w ~ d*[cos a, sin a].

    Returns (alpha, d).  Ref: projection.py:73-98 (init, with unwrap) and
    :215-243 (in-loop, without unwrap).
    """
    alpha = jnp.arctan2(wy, wx)
    if unwrap:
        alpha = jnp.unwrap(alpha, axis=-1)
    c1 = rho * (jnp.cos(alpha) ** 2 + jnp.sin(alpha) ** 2)
    c2 = rho * (wx * jnp.cos(alpha) + wy * jnp.sin(alpha))
    return alpha, jnp.clip(c2 / c1, lo, hi)


def _obs_geometry(cfg, x, y, x_obs, y_obs):
    """Per-obstacle displacement stacks flattened to (batch, num*num_obs).

    Ref layout: projection.py:56-63 (transpose(1,0,2) then reshape),
    i.e. obstacle-major blocks of length num.
    """
    nb = cfg.cem.num_batch
    # x: (batch, num); x_obs: (num_obs, num)
    wc = (x[None, :, :] - x_obs[:, None, :]).transpose(1, 0, 2).reshape(nb, -1)
    ws = (y[None, :, :] - y_obs[:, None, :]).transpose(1, 0, 2).reshape(nb, -1)
    return wc, ws


def _obs_polar(cfg, wc, ws, d_floor):
    """Obstacle polar step: alpha from the scaled ellipse, d >= d_floor.

    Ref: projection.py:65-70 and :206-213.
    """
    a, b = cfg.obstacles.a_obs, cfg.obstacles.b_obs
    rho = cfg.projection.rho_obs
    alpha = jnp.arctan2(ws * a, wc * b)
    c1 = rho * (a ** 2 * jnp.cos(alpha) ** 2 + b ** 2 * jnp.sin(alpha) ** 2)
    c2 = rho * (a * wc * jnp.cos(alpha) + b * ws * jnp.sin(alpha))
    return alpha, jnp.maximum(d_floor, c2 / c1)


def _shift_d_obs(cfg, d_obs):
    """Warm-start d_obs one timestep forward (leading 1).  Ref: projection.py:187-191."""
    nb = cfg.cem.num_batch
    blocks = d_obs.reshape(nb, cfg.obstacles.num_obs * cfg.obstacles.num_circles,
                           cfg.horizon.num)
    shifted = jnp.concatenate(
        (jnp.ones(blocks.shape[:2] + (1,)), blocks[:, :, :-1]), axis=2)
    return shifted.reshape(nb, -1)


def project(cfg: ProblemConfig, ws: Workspace,
            c_x_bar: jnp.ndarray, c_y_bar: jnp.ndarray,
            b_eq_x: jnp.ndarray, b_eq_y: jnp.ndarray,
            lamda_x: jnp.ndarray, lamda_y: jnp.ndarray,
            s_lane: jnp.ndarray,
            x_obs: jnp.ndarray, y_obs: jnp.ndarray,
            arc_vec: jnp.ndarray | None = None,
            kappa: jnp.ndarray | None = None) -> ProjectionResult:
    """Project guess coefficients onto the feasible set (AM iterations).

    Mirrors Projection.compute_projection (projection.py:277-323): one polar
    initialization (with multiplier pre-update), then ``maxiter`` AM rounds of
    [QP solve -> polar re-estimate -> multiplier update], with multipliers and
    lane slack warm-started across outer CEM iterations by the caller.

    Frenet mode (``arc_vec``/``kappa`` given — the CARLA-variant projection,
    carla/optimizer/projection.py:307-319): additionally interpolates the
    path curvature along each candidate's arc-length trajectory and outputs
    the curvature-coupled steering
    ``atan((kappa_f + kappa cos(a_v)/(1 - y kappa)) * L)`` where kappa_f is
    the Frenet-frame trajectory curvature ``d_a sin(a_a - a_v) / d_v^2``.
    """
    pj, veh, lane = cfg.projection, cfg.vehicle, cfg.lane
    nvar = cfg.horizon.nvar
    nb = cfg.cem.num_batch
    num = cfg.horizon.num
    with_obs = pj.with_obstacle_terms
    frenet_mode = arc_vec is not None

    # ---- initial polar estimates from the guess trajectory -----------------
    x_g = c_x_bar @ ws.P.T
    y_g = c_y_bar @ ws.P.T
    xdot_g = c_x_bar @ ws.Pdot.T
    ydot_g = c_y_bar @ ws.Pdot.T
    xddot_g = c_x_bar @ ws.Pddot.T
    yddot_g = c_y_bar @ ws.Pddot.T

    alpha_v, d_v = _polar_clip(xdot_g, ydot_g, pj.rho_ineq,
                               veh.v_min, veh.v_max, unwrap=True)
    alpha_a, d_a = _polar_clip(xddot_g, yddot_g, pj.rho_ineq,
                               0.0, veh.a_max, unwrap=True)

    res_vx = xdot_g - d_v * jnp.cos(alpha_v)
    res_vy = ydot_g - d_v * jnp.sin(alpha_v)
    res_ax = xddot_g - d_a * jnp.cos(alpha_a)
    res_ay = yddot_g - d_a * jnp.sin(alpha_a)

    # Multiplier pre-update (obstacle rows dropped in the stochastic variant;
    # active in det).  Ref: projection.py:115-119 / projection_det.py:115-121.
    lamda_x = lamda_x - pj.rho_ineq * (res_ax @ ws.Pddot) - pj.rho_ineq * (res_vx @ ws.Pdot)
    lamda_y = lamda_y - pj.rho_ineq * (res_ay @ ws.Pddot) - pj.rho_ineq * (res_vy @ ws.Pdot)

    if with_obs:
        wc, wsa = _obs_geometry(cfg, x_g, y_g, x_obs, y_obs)
        alpha_obs, d_obs = _obs_polar(cfg, wc, wsa, 1.0)
        res_ox = wc - cfg.obstacles.a_obs * d_obs * jnp.cos(alpha_obs)
        res_oy = wsa - cfg.obstacles.b_obs * d_obs * jnp.sin(alpha_obs)
        n_blk = cfg.obstacles.num_obs * cfg.obstacles.num_circles
        # A_obs^T r == P^T (sum of obstacle blocks of r)
        sum_ox = res_ox.reshape(nb, n_blk, num).sum(axis=1)
        sum_oy = res_oy.reshape(nb, n_blk, num).sum(axis=1)
        lamda_x = lamda_x - pj.rho_obs * (sum_ox @ ws.P)
        lamda_y = lamda_y - pj.rho_obs * (sum_oy @ ws.P)
    else:
        alpha_obs = jnp.zeros((nb, 0))
        d_obs = jnp.zeros((nb, 0))

    b_lane_ub = pj.gamma * lane.y_ub * jnp.ones((nb, num - 1))
    b_lane_lb = -pj.gamma * lane.y_lb * jnp.ones((nb, num - 1))
    b_lane = jnp.concatenate((b_lane_ub, b_lane_lb), axis=1)

    def am_iteration(carry, _):
        (lamda_x, lamda_y, alpha_v, d_v, alpha_a, d_a, alpha_obs, d_obs,
         s_lane, _unused) = carry

        # ---- x/y QP solve (constant KKT -> matmul) -------------------------
        b_lane_aug = b_lane - s_lane
        b_vx = d_v * jnp.cos(alpha_v)
        b_vy = d_v * jnp.sin(alpha_v)
        b_ax = d_a * jnp.cos(alpha_a)
        b_ay = d_a * jnp.sin(alpha_a)

        lincost_x = (-lamda_x - pj.rho_projection * c_x_bar
                     - pj.rho_ineq * (b_ax @ ws.Pddot)
                     - pj.rho_ineq * (b_vx @ ws.Pdot))
        lincost_y = (-lamda_y - pj.rho_projection * c_y_bar
                     - pj.rho_ineq * (b_ay @ ws.Pddot)
                     - pj.rho_ineq * (b_vy @ ws.Pdot)
                     - pj.rho_lane * (b_lane_aug @ ws.A_lane))

        if with_obs:
            a_o, b_o = cfg.obstacles.a_obs, cfg.obstacles.b_obs
            x_obs_flat = x_obs.reshape(-1)       # obstacle-major (num_obs*num,)
            y_obs_flat = y_obs.reshape(-1)
            b_obs_x = x_obs_flat[None, :] + d_obs * jnp.cos(alpha_obs) * a_o
            b_obs_y = y_obs_flat[None, :] + d_obs * jnp.sin(alpha_obs) * b_o
            n_blk = cfg.obstacles.num_obs * cfg.obstacles.num_circles
            sum_bx = b_obs_x.reshape(nb, n_blk, num).sum(axis=1)
            sum_by = b_obs_y.reshape(nb, n_blk, num).sum(axis=1)
            lincost_x = lincost_x - pj.rho_obs * (sum_bx @ ws.P)
            lincost_y = lincost_y - pj.rho_obs * (sum_by @ ws.P)

        rhs_x = jnp.concatenate((-lincost_x, b_eq_x), axis=1)
        rhs_y = jnp.concatenate((-lincost_y, b_eq_y), axis=1)
        sol_x = kkt_solve(ws.proj_kkt_x, ws.proj_kkt_x_inv, rhs_x, cfg.solve_strategy)
        sol_y = kkt_solve(ws.proj_kkt_y, ws.proj_kkt_y_inv, rhs_y, cfg.solve_strategy)
        c_x = sol_x[:, :nvar]
        c_y = sol_y[:, :nvar]

        x = c_x @ ws.P.T
        y = c_y @ ws.P.T
        xdot = c_x @ ws.Pdot.T
        ydot = c_y @ ws.Pdot.T
        xddot = c_x @ ws.Pddot.T
        yddot = c_y @ ws.Pddot.T

        lane_val = c_y @ ws.A_lane.T
        s_lane = jnp.maximum(0.0, -lane_val + b_lane)
        res_lane = lane_val - b_lane + s_lane

        # ---- polar re-estimation + residuals ------------------------------
        alpha_v, d_v = _polar_clip(xdot, ydot, pj.rho_ineq,
                                   veh.v_min, veh.v_max, unwrap=False)
        alpha_a, d_a = _polar_clip(xddot, yddot, pj.rho_ineq,
                                   0.0, veh.a_max, unwrap=False)

        res_vx = xdot - d_v * jnp.cos(alpha_v)
        res_vy = ydot - d_v * jnp.sin(alpha_v)
        res_ax = xddot - d_a * jnp.cos(alpha_a)
        res_ay = yddot - d_a * jnp.sin(alpha_a)

        res_norm = (jnp.linalg.norm(jnp.concatenate((res_ax, res_ay), axis=1), axis=1)
                    + jnp.linalg.norm(jnp.concatenate((res_vx, res_vy), axis=1), axis=1)
                    + jnp.linalg.norm(res_lane, axis=1))

        lamda_x = (lamda_x - pj.rho_ineq * (res_ax @ ws.Pddot)
                   - pj.rho_ineq * (res_vx @ ws.Pdot))
        lamda_y = (lamda_y - pj.rho_ineq * (res_ay @ ws.Pddot)
                   - pj.rho_ineq * (res_vy @ ws.Pdot)
                   - pj.rho_lane * (res_lane @ ws.A_lane))

        if with_obs:
            wc, wsa = _obs_geometry(cfg, x, y, x_obs, y_obs)
            d_floor = 1.0 + (1.0 - pj.gamma_obs) * (_shift_d_obs(cfg, d_obs) - 1.0)
            alpha_obs_n, d_obs_n = _obs_polar(cfg, wc, wsa, d_floor)
            res_ox = wc - cfg.obstacles.a_obs * d_obs_n * jnp.cos(alpha_obs_n)
            res_oy = wsa - cfg.obstacles.b_obs * d_obs_n * jnp.sin(alpha_obs_n)
            res_norm = res_norm + jnp.linalg.norm(
                jnp.concatenate((res_ox, res_oy), axis=1), axis=1)
            n_blk = cfg.obstacles.num_obs * cfg.obstacles.num_circles
            sum_ox = res_ox.reshape(nb, n_blk, num).sum(axis=1)
            sum_oy = res_oy.reshape(nb, n_blk, num).sum(axis=1)
            lamda_x = lamda_x - pj.rho_obs * (sum_ox @ ws.P)
            lamda_y = lamda_y - pj.rho_obs * (sum_oy @ ws.P)
            alpha_obs, d_obs = alpha_obs_n, d_obs_n

        if frenet_mode:
            # curvature-coupled steering (carla/optimizer/projection.py:307-319)
            kappa_interp = jnp.interp(
                jnp.clip(x, 0.0, arc_vec[-1]).reshape(-1), arc_vec, kappa
            ).reshape(nb, num)
            kappa_frenet = d_a * jnp.sin(alpha_a - alpha_v) / (d_v ** 2)
            steering = jnp.arctan(
                (kappa_frenet + kappa_interp * jnp.cos(alpha_v)
                 / (1.0 - y * kappa_interp)) * veh.wheel_base)
        else:
            kappa_interp = jnp.zeros((nb, num))
            steering = jnp.zeros((nb, num))

        out = (c_x, c_y, x, y, xdot, ydot, xddot, yddot, res_norm,
               steering, kappa_interp)
        return (lamda_x, lamda_y, alpha_v, d_v, alpha_a, d_a, alpha_obs,
                d_obs, s_lane, out), None

    zeros_out = (jnp.zeros((nb, nvar)), jnp.zeros((nb, nvar))) + tuple(
        jnp.zeros((nb, num)) for _ in range(6)) + (jnp.zeros(nb),) + tuple(
        jnp.zeros((nb, num)) for _ in range(2))
    carry0 = (lamda_x, lamda_y, alpha_v, d_v, alpha_a, d_a, alpha_obs, d_obs,
              s_lane, zeros_out)
    carry, _ = lax.scan(am_iteration, carry0, None, length=pj.maxiter)
    (lamda_x, lamda_y, _, _, _, _, _, _, s_lane, out) = carry
    (c_x, c_y, x, y, xdot, ydot, xddot, yddot, res_norm,
     steering, kappa_interp) = out

    return ProjectionResult(c_x, c_y, x, y, xdot, ydot, xddot, yddot,
                            res_norm, lamda_x, lamda_y, s_lane,
                            steering, kappa_interp)
