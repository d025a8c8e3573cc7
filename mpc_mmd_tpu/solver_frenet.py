"""Frenet-frame (on-road) variant of the CEM solver — the CARLA-equivalent.

Differences from the straight-road solver (:mod:`mpc_mmd_tpu.solver`),
mirroring ``carla/optimizer/cem.py``:

* per-rollout noisy initial states from a 2-parameter Gaussian perturbation
  of (x, y) keyed by the MPC step (cem.py:246-253, cem_helper.py:660-715);
* equality boundary conditions from the *mean* Frenet-converted init state;
* projection runs in the Frenet frame with path-curvature-coupled steering
  output (projection.py:307-319);
* rollouts integrate in the GLOBAL frame from the noisy init states, then
  convert pointwise to Frenet for the risk costs (cem.py:322-324);
* scalar cost adds centripetal-acceleration and desired-lane terms
  (cem_helper.py:522-556);
* ``det`` mode uses the obstacle-active projection with all risks zeroed
  (cem.py:633-754);
* returns (cx, cy, v_best, steering_best, mean, cov) — mean_param
  warm-starts the next receding-horizon step (main_carla.py:378-382).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from . import risk as risk_mod
from .config import ProblemConfig
from .dynamics import controls_from_trajectory
from .frenet import FrenetFrame, global_to_frenet_points, global_to_frenet_state
from .qp import Workspace, build_workspace, compute_guess, refit_coefficients
from .projection import project
from .reduced_set import select_reduced_set, select_reduced_set_batched
from .sampling import cem_update, initial_params, scalar_cost
from .solver import batched_rollouts


class FrenetSolveResult(NamedTuple):
    cx: jnp.ndarray
    cy: jnp.ndarray
    v_best: jnp.ndarray         # (num,) speed profile of the best candidate
    steering_best: jnp.ndarray  # (num,) curvature-coupled steering
    mean_param: jnp.ndarray
    cov_param: jnp.ndarray
    res: jnp.ndarray
    risk_obs: jnp.ndarray


def _noisy_init_states(cfg: ProblemConfig, idx_mpc, x0, y0, vx0, vy0,
                       n: int):
    """(x, y)-perturbed init states, PRNGKey(idx_mpc).
    Ref: carla/optimizer/cem_helper.py:660-678."""
    key = jax.random.PRNGKey(idx_mpc)
    key, _ = jax.random.split(key)
    eps = jax.random.multivariate_normal(key, jnp.zeros(4), jnp.eye(4), (n,))
    mu, sig = cfg.frenet.init_mu, cfg.frenet.init_sigma
    x = x0 + eps[:, 0] * sig[0] + mu[0]
    y = y0 + eps[:, 1] * sig[1] + mu[1]
    psi = jnp.arctan2(vy0, vx0)
    ones = jnp.ones(n)
    return x, y, vx0 * ones, vy0 * ones, psi * ones


def _frenet_scalar_cost(cfg: ProblemConfig, risk_des_lane, risk_obs, risk_lane,
                        y, res_norm, xdot, ydot, xddot, yddot, steering,
                        kappa_interp, v_des):
    """CARLA-variant scalarization (cem_helper.py:522-556): base trajectory
    cost + 0.01 desired-lane product + 0.1 centripetal penalty, risks added
    pre-weighted outside the parenthesis."""
    base = scalar_cost(cfg, jnp.zeros_like(risk_obs), jnp.zeros_like(risk_obs),
                       y, res_norm, xdot, ydot, xddot, yddot, steering, v_des)
    c1 = jnp.linalg.norm(y - cfg.lane.y_des_1, axis=1)
    c2 = jnp.linalg.norm(y - cfg.lane.y_des_2, axis=1)
    centr = jnp.abs((xdot ** 2) * kappa_interp)
    centr_cost = jnp.linalg.norm(
        jnp.maximum(0.0, centr - cfg.vehicle.a_centr), axis=1)
    return (base + cfg.frenet.weight_des_lane * c1 * c2
            + cfg.frenet.weight_centr * centr_cost
            + risk_obs + risk_lane + risk_des_lane)


def _gather(tree, idx):
    return jax.tree_util.tree_map(lambda a: a[idx], tree)


def _solve_frenet(cfg: ProblemConfig, ws: Workspace, idx_mpc,
                  init_state_global, mean_param, cov_param,
                  x_obs_traj, y_obs_traj, v_des,
                  frame: FrenetFrame) -> FrenetSolveResult:
    """Trace-time wrapper pinning cfg.matmul_precision for every entry
    point (FrenetSolver, sharded_frenet_sweep) — see solver._solve."""
    from .solver import with_matmul_precision
    fn = with_matmul_precision(partial(_solve_frenet_body, cfg, ws),
                               cfg.matmul_precision)
    return fn(idx_mpc, init_state_global, mean_param, cov_param,
              x_obs_traj, y_obs_traj, v_des, frame)


def _solve_frenet_body(cfg: ProblemConfig, ws: Workspace, idx_mpc,
                       init_state_global, mean_param, cov_param,
                       x_obs_traj, y_obs_traj, v_des,
                       frame: FrenetFrame) -> FrenetSolveResult:
    mode = cfg.risk.mode
    nb = cfg.cem.num_batch
    n_cost = cfg.cem.ellite_num_cost
    n_el = cfg.cem.ellite_num
    T = cfg.horizon.num_prime
    R = cfg.risk.num_reduced
    M = cfg.risk.num_mother
    dt = cfg.horizon.dt
    L = cfg.vehicle.wheel_base
    w_lane, w_obs = cfg.risk.weights()

    x_g, y_g, v_g, vdot_g, psi_g, psidot_g = [init_state_global[i]
                                              for i in range(6)]
    vx_g = v_g * jnp.cos(psi_g)
    vy_g = v_g * jnp.sin(psi_g)

    # noisy init ensemble size per mode (cem.py:250 / :667 / :699 / :680)
    n_init = {"mmd_opt": M, "det": 1}.get(mode, R)
    xs, ys, vxs, vys, psis = _noisy_init_states(cfg, idx_mpc, x_g, y_g,
                                                vx_g, vy_g, n_init)
    init_states_global = jnp.stack((xs, ys, vxs, vys, psis), axis=1)

    # Frenet boundary conditions from the mean converted state
    temps = jnp.stack([xs, ys, jnp.sqrt(vxs ** 2 + vys ** 2),
                       vdot_g * jnp.ones(n_init), psis,
                       psidot_g * jnp.ones(n_init)], axis=1)
    conv = jax.vmap(lambda s: global_to_frenet_state(frame, s))(temps)
    s_m, l_m, vs_m, vl_m, as_m, al_m = [c.mean() for c in conv[:6]]
    ones = jnp.ones((nb, 1))
    b_eq_x = jnp.concatenate((s_m * ones, vs_m * ones, as_m * ones), axis=1)
    b_eq_y = jnp.concatenate((l_m * ones, vl_m * ones, al_m * ones,
                              jnp.zeros((nb, 1))), axis=1)

    params0 = initial_params(cfg, mean_param, cov_param)
    x_obs_T = x_obs_traj[:, :T]
    y_obs_T = y_obs_traj[:, :T]

    uniform_beta = (1.0 / R) * jnp.ones((nb, R))
    uniform_sigma = 0.01 * jnp.ones(nb)

    def body(carry, idx):
        (res, lamda_x, lamda_y, params, mean, cov, s_lane) = carry
        key = jax.random.PRNGKey(3 * idx_mpc + 5 * idx + 7)

        cx_bar, cy_bar = compute_guess(cfg, ws, params, b_eq_x, b_eq_y)
        pr = project(cfg, ws, cx_bar, cy_bar, b_eq_x, b_eq_y,
                     lamda_x, lamda_y, s_lane, x_obs_traj, y_obs_traj,
                     arc_vec=frame.arc_vec, kappa=frame.kappa)

        order = jnp.argsort(pr.res_norm)
        bundle = (pr.x, pr.y, pr.xdot, pr.ydot, pr.xddot, pr.yddot,
                  pr.c_x, pr.c_y, pr.res_norm, params, pr.steering,
                  pr.kappa_interp)
        (x, y, xdot, ydot, xddot, yddot, c_x, c_y, res_p, params_p,
         steering, kappa_i) = _gather(bundle, order)

        acc, _ = controls_from_trajectory(xdot, ydot, xddot, yddot, dt, L)
        key, _sub = jax.random.split(key)
        acc_T = acc[:, :T]
        steer_T = steering[:, :T]

        if mode == "det":
            risk_obs = jnp.zeros(nb)
            beta = uniform_beta
            sigma = uniform_sigma
            s_roll = jnp.zeros((nb, R, T))
            l_roll = jnp.zeros((nb, R, T))
        else:
            if mode == "mmd_opt":
                xr, yr = batched_rollouts(cfg, key, acc_T, steer_T,
                                          init_states_global, mother=True)
                cxr, cyr = refit_coefficients(ws, xr.reshape(nb * M, T),
                                              yr.reshape(nb * M, T))
                if cfg.solve_strategy == "exact":
                    rs = jax.vmap(
                        lambda a, b, c, d: select_reduced_set(cfg, a, b, c, d)
                    )(cxr.reshape(nb, M, -1), cyr.reshape(nb, M, -1), xr, yr)
                else:
                    rs = select_reduced_set_batched(
                        cfg, cxr.reshape(nb, M, -1), cyr.reshape(nb, M, -1),
                        xr, yr)
                xg_roll, yg_roll = rs.x_red, rs.y_red
                beta, sigma = rs.beta, rs.sigma
            else:
                xg_roll, yg_roll = batched_rollouts(
                    cfg, key, acc_T, steer_T, init_states_global,
                    mother=False)
                beta, sigma = uniform_beta, uniform_sigma

            # global -> Frenet for the risk costs (cem.py:322-324)
            s_roll, l_roll = global_to_frenet_points(frame, xg_roll, yg_roll)

            if mode in ("mmd_opt", "mmd_random"):
                risk_obs = jax.vmap(
                    lambda b, sg, xr, yr: risk_mod.mmd_obs(
                        cfg, b, sg, xr, yr, x_obs_T, y_obs_T)
                )(beta, sigma, s_roll, l_roll)
            elif mode == "cvar":
                risk_obs = jax.vmap(
                    lambda xr, yr: risk_mod.cvar_obs(cfg, xr, yr,
                                                     x_obs_T, y_obs_T)
                )(s_roll, l_roll)
            else:
                risk_obs = jax.vmap(
                    lambda xr, yr: risk_mod.saa_obs(cfg, xr, yr,
                                                    x_obs_T, y_obs_T)
                )(s_roll, l_roll)

        order2 = jnp.argsort(risk_obs)[:n_cost]
        bundle2 = (risk_obs, x, y, xdot, ydot, xddot, yddot, c_x, c_y,
                   res_p, params_p, steering, kappa_i, l_roll, beta, sigma)
        (risk_obs_e, x_e, y_e, xdot_e, ydot_e, xddot_e, yddot_e, c_x_e,
         c_y_e, res_e, params_e, steer_e, kappa_e, l_roll_e, beta_e,
         sigma_e) = _gather(bundle2, order2)

        if mode == "mmd_opt" or mode == "mmd_random":
            risk_lane = jax.vmap(
                lambda b, sg, yr: risk_mod.mmd_lane(cfg, b, sg, yr)
            )(beta_e, sigma_e, l_roll_e)
        elif mode == "cvar":
            risk_lane = jax.vmap(lambda yr: risk_mod.cvar_lane(cfg, yr))(l_roll_e)
        elif mode == "saa":
            risk_lane = jax.vmap(lambda yr: risk_mod.saa_lane(cfg, yr))(l_roll_e)
        else:
            risk_lane = jnp.zeros(n_cost)

        w_des = cfg.risk.weight_lane_des
        if w_des != 0.0 and mode != "det":
            if mode in ("mmd_opt", "mmd_random"):
                risk_des = jax.vmap(
                    lambda b, sg, yr: risk_mod.mmd_lane_des(cfg, b, sg, yr)
                )(beta_e, sigma_e, l_roll_e)
            elif mode == "cvar":
                risk_des = jax.vmap(
                    lambda yr: risk_mod.cvar_lane_des(cfg, yr))(l_roll_e)
            else:
                risk_des = jax.vmap(
                    lambda yr: risk_mod.saa_lane_des(cfg, yr))(l_roll_e)
            risk_des = w_des * risk_des
        else:
            risk_des = jnp.zeros(n_cost)

        cost_batch = _frenet_scalar_cost(
            cfg, risk_des, w_obs * risk_obs_e, w_lane * risk_lane,
            y_e, res_e, xdot_e, ydot_e, xddot_e, yddot_e, steer_e, kappa_e,
            v_des)

        order3 = jnp.argsort(cost_batch)
        elite_idx = order3[:n_el]
        key, _ = jax.random.split(key)
        mean, cov, params_next = cem_update(cfg, key, params_e[elite_idx],
                                            cost_batch[elite_idx], mean, cov)

        idx_min = jnp.argmin(cost_batch[elite_idx])
        res = res.at[idx].set(jnp.min(cost_batch[elite_idx]))
        out = (c_x_e[idx_min], c_y_e[idx_min], steer_e[idx_min],
               risk_obs_e[idx_min])
        return (res, pr.lamda_x, pr.lamda_y, params_next, mean, cov,
                pr.s_lane), out

    nvar = cfg.horizon.nvar
    carry0 = (jnp.zeros(cfg.cem.maxiter_cem), jnp.zeros((nb, nvar)),
              jnp.zeros((nb, nvar)), params0, mean_param, cov_param,
              jnp.zeros((nb, 2 * (cfg.horizon.num - 1))))
    carry, outs = lax.scan(body, carry0, jnp.arange(cfg.cem.maxiter_cem))
    res = carry[0]
    mean_f, cov_f = carry[4], carry[5]
    cx_s, cy_s, steer_s, risk_s = outs

    cx_best, cy_best = cx_s[-1], cy_s[-1]
    xdot_b = ws.Pdot @ cx_best
    ydot_b = ws.Pdot @ cy_best
    v_best = jnp.sqrt(xdot_b ** 2 + ydot_b ** 2)

    return FrenetSolveResult(cx=cx_best, cy=cy_best, v_best=v_best,
                             steering_best=steer_s[-1], mean_param=mean_f,
                             cov_param=cov_f, res=res, risk_obs=risk_s[-1])


class FrenetSolver:
    """On-road solver over a smoothed local path (capability parity with
    carla/optimizer/cem.py compute_cem_mmd / _cvar / _det)."""

    def __init__(self, cfg: ProblemConfig, ws: Workspace | None = None):
        if cfg.risk.mode == "det" and not cfg.projection.with_obstacle_terms:
            import dataclasses
            cfg = cfg.replace(projection=dataclasses.replace(
                cfg.projection, with_obstacle_terms=True))
        self.cfg = cfg
        self.ws = ws if ws is not None else build_workspace(cfg)
        # cfg.matmul_precision is applied inside _solve_frenet itself
        self._solve = jax.jit(partial(_solve_frenet, cfg, self.ws))

    def solve(self, idx_mpc, init_state_global, mean_param, cov_param,
              x_obs_traj, y_obs_traj, v_des, frame: FrenetFrame
              ) -> FrenetSolveResult:
        return self._solve(idx_mpc, init_state_global, mean_param, cov_param,
                           x_obs_traj, y_obs_traj, v_des, frame)
