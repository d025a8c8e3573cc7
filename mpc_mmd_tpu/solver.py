"""Outer CEM solver: the full risk-aware MPC solve as one jitted program.

One implementation parameterized by ``RiskConfig.mode`` replaces the
reference's four near-identical 130-line solve methods
(``synthetic_static_obs/optimizer/cem.py:201-714``).  The whole 20-iteration
loop is a single ``lax.scan``; the only host<->device boundary is the jitted
call itself.

Pipeline per CEM iteration (ref cem.py:221-315):
  sample params -> guess QP -> AM projection -> sort by residual ->
  extract controls -> noisy rollouts (+ reduced-set selection for mmd_opt) ->
  obstacle risk -> sort, keep top ellite_num_cost -> lane risk ->
  scalar cost -> top-ellite_num elites -> CEM distribution update.

Design notes
------------
* All argsort+15-gather chains collapse to one argsort + a single stacked
  gather over a bundled pytree.
* RNG consumption (PRNGKey(3*idx_mpc + 5*idx + 7), split order, shared
  rollout key across candidates) mirrors the reference exactly so solves are
  comparable within float tolerance — see tests/test_parity.py.
* The returned "best" candidate reproduces the reference's indexing quirk:
  ``idx_min`` indexes the 5 sorted elite costs (hence is 0) and is applied to
  the risk-sorted top-20 arrays, selecting the minimum-obstacle-risk
  candidate of the final iteration (cem.py:308-315).
"""

from __future__ import annotations

import os
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from . import risk as risk_mod
from .config import ProblemConfig
from .dynamics import (controls_from_trajectory, mother_product,
                       perturb_controls, rollout)
from .qp import Workspace, boundary_vectors, build_workspace, compute_guess, \
    refit_coefficients
from .projection import project
from .reduced_set import select_reduced_set, select_reduced_set_batched
from .sampling import cem_update, initial_params, scalar_cost


class SolveResult(NamedTuple):
    """Per-solve outputs (mirrors cem.py:324-333 plus diagnostics)."""

    cx: jnp.ndarray          # (nvar,) best-candidate Bernstein x coefficients
    cy: jnp.ndarray
    risk_lane: jnp.ndarray   # () lane risk of the best candidate
    risk_obs: jnp.ndarray    # () obstacle risk of the best candidate
    beta: jnp.ndarray        # (num_reduced,) reduced-set weights (mmd_opt; else uniform)
    sigma: jnp.ndarray       # () kernel bandwidth (mmd_opt; else 0.01)
    res_beta: jnp.ndarray    # (beta_cem.maxiter,) inner-CEM residual (mmd_opt; else zeros)
    res: jnp.ndarray         # (maxiter_cem,) best scalar cost per iteration
    res_2: jnp.ndarray       # (maxiter_cem,) projection residual of best candidate
    mean_param: jnp.ndarray  # (8,) final CEM mean (warm-start for receding horizon)
    cov_param: jnp.ndarray   # (8, 8) final CEM covariance


def _gather(tree, idx):
    return jax.tree_util.tree_map(lambda a: a[idx], tree)


def with_matmul_precision(fn, precision: str):
    """Trace ``fn`` under ``jax.default_matmul_precision(precision)``.

    Precision is a trace-time property of each dot/einsum, so wrapping the
    traced body (not the jit call site) pins it into the compiled program.
    "default" returns ``fn`` unchanged (see ProblemConfig.matmul_precision).
    """
    if precision == "default":
        return fn

    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision(precision):
            return fn(*args, **kwargs)

    return wrapped


def batched_rollouts(cfg: ProblemConfig, key, acc_T, steer_T, state0,
                     mother: bool):
    """Noisy rollouts for all candidates as ONE flat-lane rollout call.

    acc_T, steer_T: (C, T).  state0: (5,) shared or (n_init, 5) per-rollout
    (Frenet noisy-init ensembles).  Returns x, y of shape (C, n, T) with
    n = num_mother (mother=True) or num_reduced.
    """
    C, T = acc_T.shape
    R = cfg.risk.num_reduced
    dt, L = cfg.horizon.dt, cfg.vehicle.wheel_base

    a_n, s_n = jax.vmap(
        lambda a, s: perturb_controls(key, a, s, R, cfg.noise))(acc_T, steer_T)
    if mother:
        a_l = jnp.repeat(a_n, R, axis=1)           # (C, R^2, T)
        s_l = jnp.tile(s_n, (1, R, 1))
    else:
        a_l, s_l = a_n, s_n
    n = a_l.shape[1]
    a_flat = a_l.reshape(C * n, T)
    s_flat = s_l.reshape(C * n, T)
    if state0.ndim == 1:
        s0 = jnp.broadcast_to(state0[None, :], (C * n, 5))
    else:
        s0 = jnp.broadcast_to(state0[None, :, :], (C, n, 5)).reshape(C * n, 5)

    x, y = rollout(a_flat, s_flat, s0, dt, L)
    return x.reshape(C, n, T), y.reshape(C, n, T)


def _candidate_spec(mesh):
    """Sharding spec for per-candidate heavy tensors (leading candidate axis)."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    return NamedSharding(mesh, P("candidates"))


def _solve(cfg: ProblemConfig, ws: Workspace, idx_mpc, init_state,
           mean_param, cov_param, x_obs_traj, y_obs_traj, v_des,
           candidate_mesh=None) -> SolveResult:
    """Trace-time wrapper: pins cfg.matmul_precision for the whole solve so
    EVERY jit entry point (Solver, solve_batch, the sharded sweeps in
    parallel/mesh.py, profile scripts) inherits it."""
    fn = with_matmul_precision(
        partial(_solve_body, cfg, ws, candidate_mesh=candidate_mesh),
        cfg.matmul_precision)
    return fn(idx_mpc, init_state, mean_param, cov_param, x_obs_traj,
              y_obs_traj, v_des)


def _solve_body(cfg: ProblemConfig, ws: Workspace, idx_mpc, init_state,
                mean_param, cov_param, x_obs_traj, y_obs_traj, v_des,
                candidate_mesh=None) -> SolveResult:
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

    params0 = initial_params(cfg, mean_param, cov_param)
    b_eq_x, b_eq_y = boundary_vectors(cfg, init_state)
    state0 = jnp.asarray([init_state[0], init_state[1], init_state[2],
                          init_state[3],
                          jnp.arctan2(init_state[3], init_state[2])])

    x_obs_T = x_obs_traj[:, :T]
    y_obs_T = y_obs_traj[:, :T]

    uniform_beta = (1.0 / R) * jnp.ones((nb, R))
    uniform_sigma = 0.01 * jnp.ones(nb)

    def body(carry, idx):
        (res, res_2, lamda_x, lamda_y, params, mean, cov, s_lane) = carry

        key = jax.random.PRNGKey(3 * idx_mpc + 5 * idx + 7)

        cx_bar, cy_bar = compute_guess(cfg, ws, params, b_eq_x, b_eq_y)
        pr = project(cfg, ws, cx_bar, cy_bar, b_eq_x, b_eq_y,
                     lamda_x, lamda_y, s_lane, x_obs_traj, y_obs_traj)

        # Full permutation by projection residual (ellite_num_projection ==
        # num_batch in the reference, cem.py:139).
        order = jnp.argsort(pr.res_norm)
        bundle = (pr.x, pr.y, pr.xdot, pr.ydot, pr.xddot, pr.yddot,
                  pr.c_x, pr.c_y, pr.res_norm, params)
        (x, y, xdot, ydot, xddot, yddot, c_x, c_y, res_p, params_p) = \
            _gather(bundle, order)

        acc, steer = controls_from_trajectory(xdot, ydot, xddot, yddot, dt, L)

        key, _ = jax.random.split(key)
        acc_T = acc[:, :T]
        steer_T = steer[:, :T]

        if candidate_mesh is not None:
            # Latency mode: shard the heavy per-candidate segment (rollouts,
            # reduced-set selection, risk) across the mesh.  Everything the
            # CEM shares across candidates (params, coefficients — all tiny)
            # stays replicated; XLA SPMD partitions the vmapped pipeline.
            spec = _candidate_spec(candidate_mesh)
            acc_T = jax.lax.with_sharding_constraint(acc_T, spec)
            steer_T = jax.lax.with_sharding_constraint(steer_T, spec)

        if mode == "mmd_opt":
            xr, yr = batched_rollouts(cfg, key, acc_T, steer_T, state0,
                                      mother=True)
            cxr, cyr = refit_coefficients(ws, xr.reshape(nb * M, T),
                                          yr.reshape(nb * M, T))
            cxr = cxr.reshape(nb, M, -1)
            cyr = cyr.reshape(nb, M, -1)
            if cfg.solve_strategy == "exact":
                # reference-parity path: per-candidate exact inner CEM
                rs = jax.vmap(
                    lambda a, b, c, d: select_reduced_set(cfg, a, b, c, d)
                )(cxr, cyr, xr, yr)
            else:
                # production path: one batched inner CEM over all candidates
                rs = select_reduced_set_batched(cfg, cxr, cyr, xr, yr)
            x_roll, y_roll = rs.x_red, rs.y_red
            beta, sigma, res_beta = rs.beta, rs.sigma, rs.res
            risk_obs = jax.vmap(
                lambda b, sg, xr2, yr2: risk_mod.mmd_obs(
                    cfg, b, sg, xr2, yr2, x_obs_T, y_obs_T)
            )(beta, sigma, x_roll, y_roll)
        else:
            x_roll, y_roll = batched_rollouts(cfg, key, acc_T, steer_T,
                                              state0, mother=False)
            beta, sigma = uniform_beta, uniform_sigma
            res_beta = jnp.zeros((nb, cfg.beta_cem.maxiter))
            if mode == "mmd_random":
                risk_obs = jax.vmap(
                    lambda b, sg, xr, yr: risk_mod.mmd_obs(
                        cfg, b, sg, xr, yr, x_obs_T, y_obs_T)
                )(beta, sigma, x_roll, y_roll)
            elif mode == "cvar":
                risk_obs = jax.vmap(
                    lambda xr, yr: risk_mod.cvar_obs(cfg, xr, yr, x_obs_T, y_obs_T)
                )(x_roll, y_roll)
            elif mode == "saa":
                risk_obs = jax.vmap(
                    lambda xr, yr: risk_mod.saa_obs(cfg, xr, yr, x_obs_T, y_obs_T)
                )(x_roll, y_roll)
            else:
                raise ValueError(f"unknown risk mode {mode!r}")

        if candidate_mesh is not None:
            # gather the small per-candidate outputs back to replicated for
            # the selection/update stages (risk scalars + reduced rollouts
            # are KB-sized; one all-gather across the mesh)
            from jax.sharding import NamedSharding, PartitionSpec as P
            rep = NamedSharding(candidate_mesh, P())
            risk_obs = jax.lax.with_sharding_constraint(risk_obs, rep)
            y_roll = jax.lax.with_sharding_constraint(y_roll, rep)
            beta = jax.lax.with_sharding_constraint(beta, rep)
            sigma = jax.lax.with_sharding_constraint(sigma, rep)

        # ---- keep top-n_cost by obstacle risk ------------------------------
        order2 = jnp.argsort(risk_obs)[:n_cost]
        bundle2 = (risk_obs, x, y, xdot, ydot, xddot, yddot, c_x, c_y,
                   res_p, params_p, steer, y_roll, beta, sigma, res_beta)
        (risk_obs_e, x_e, y_e, xdot_e, ydot_e, xddot_e, yddot_e, c_x_e,
         c_y_e, res_e, params_e, steer_e, y_roll_e, beta_e, sigma_e,
         res_beta_e) = _gather(bundle2, order2)

        if mode == "mmd_opt":
            risk_lane = jax.vmap(
                lambda b, sg, yr: risk_mod.mmd_lane(cfg, b, sg, yr)
            )(beta_e, sigma_e, y_roll_e)
        elif mode == "mmd_random":
            # Reference zeroes the lane MMD on the random path (cem.py:427).
            risk_lane = jnp.zeros(n_cost)
        elif mode == "cvar":
            risk_lane = jax.vmap(lambda yr: risk_mod.cvar_lane(cfg, yr))(y_roll_e)
        else:
            risk_lane = jax.vmap(lambda yr: risk_mod.saa_lane(cfg, yr))(y_roll_e)

        cost_batch = scalar_cost(cfg, w_obs * risk_obs_e, w_lane * risk_lane,
                                 y_e, res_e, xdot_e, ydot_e, xddot_e, yddot_e,
                                 steer_e, v_des)

        order3 = jnp.argsort(cost_batch)
        elite_idx = order3[:n_el]
        params_elite = params_e[elite_idx]
        cost_elite = cost_batch[elite_idx]

        key, _ = jax.random.split(key)
        mean, cov, params_next = cem_update(cfg, key, params_elite,
                                            cost_elite, mean, cov)

        # Reference's final-selection quirk (cem.py:308-315): argmin over the
        # *sorted* elite costs (always 0) applied to the risk-sorted arrays.
        idx_min = jnp.argmin(cost_elite)
        res = res.at[idx].set(jnp.min(cost_elite))
        res_2 = res_2.at[idx].set(res_e[idx_min])

        out = (c_x_e[idx_min], c_y_e[idx_min], risk_lane[idx_min],
               risk_obs_e[idx_min], beta_e[idx_min], sigma_e[idx_min],
               res_beta_e[idx_min])
        carry_next = (res, res_2, pr.lamda_x, pr.lamda_y, params_next,
                      mean, cov, pr.s_lane)
        return carry_next, out

    nvar = cfg.horizon.nvar
    carry0 = (jnp.zeros(cfg.cem.maxiter_cem), jnp.zeros(cfg.cem.maxiter_cem),
              jnp.zeros((nb, nvar)), jnp.zeros((nb, nvar)), params0,
              mean_param, cov_param, jnp.zeros((nb, 2 * (cfg.horizon.num - 1))))

    carry, outs = lax.scan(body, carry0, jnp.arange(cfg.cem.maxiter_cem))
    res, res_2 = carry[0], carry[1]
    mean_f, cov_f = carry[5], carry[6]
    (cx_s, cy_s, lane_s, obs_s, beta_s, sigma_s, res_beta_s) = outs

    return SolveResult(cx=cx_s[-1], cy=cy_s[-1], risk_lane=lane_s[-1],
                       risk_obs=obs_s[-1], beta=beta_s[-1], sigma=sigma_s[-1],
                       res_beta=res_beta_s[-1], res=res, res_2=res_2,
                       mean_param=mean_f, cov_param=cov_f)


class Solver:
    """Factory wrapper: builds the workspace once and jits the solve.

    Usage::

        solver = Solver(static_workload(mode="cvar"))
        result = solver.solve(seed, init_state, mean, cov, x_obs, y_obs, v_des)
    """

    def __init__(self, cfg: ProblemConfig, ws: Optional[Workspace] = None,
                 candidate_mesh=None, scenario_chunk: Optional[int] = None):
        """candidate_mesh: a 1-axis Mesh named "candidates" — shards one
        solve's heavy per-candidate pipeline across chips (latency mode;
        the num_batch axis must divide the mesh size evenly).

        scenario_chunk: how many scenarios run *concurrently* inside
        ``solve_batch`` (the rest pipeline sequentially via ``lax.map``
        within the same compiled program).  The mmd_opt inner CEM's
        selection intermediates scale with chunk x num_batch x S x k x M;
        the default is 1 (one scenario at a time, one dispatch).  The best
        value on the H100's 80 GB is not measured yet."""
        self.cfg = cfg
        self.ws = ws if ws is not None else build_workspace(cfg)
        # cfg.matmul_precision is applied inside _solve itself
        self._solve = jax.jit(partial(_solve, cfg, self.ws,
                                      candidate_mesh=candidate_mesh))
        if scenario_chunk is None:
            scenario_chunk = int(os.environ.get("MPC_MMD_SCENARIO_CHUNK", "1"))
        self.scenario_chunk = max(1, scenario_chunk)
        solve_fn = partial(_solve, cfg, self.ws)

        def batch(seeds, init_state, mean_param, cov_param, xts, yts, v_des):
            return lax.map(
                lambda sxy: solve_fn(sxy[0], init_state, mean_param,
                                     cov_param, sxy[1], sxy[2], v_des),
                (seeds, xts, yts), batch_size=self.scenario_chunk)

        self._solve_batch = jax.jit(batch)

    def solve(self, idx_mpc, init_state, mean_param, cov_param,
              x_obs_traj, y_obs_traj, v_des) -> SolveResult:
        return self._solve(idx_mpc, init_state, mean_param, cov_param,
                           x_obs_traj, y_obs_traj, v_des)

    def solve_batch(self, seeds, init_state, mean_param, cov_param,
                    x_obs_trajs, y_obs_trajs, v_des) -> SolveResult:
        """Solve a batch of scenarios in one XLA program (scenario-vmap)."""
        return self._solve_batch(seeds, init_state, mean_param, cov_param,
                                 x_obs_trajs, y_obs_trajs, v_des)
