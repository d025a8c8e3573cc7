"""Scenario generation: static obstacle grids and dynamic cut-in traffic.

De-triplicated, batched replacements for the reference's per-config host
loops:

* static grid — ``synthetic_static_obs/main_mpc.py:10-21`` (numpy RNG kept
  bit-compatible so sweeps reproduce the reference's 200 obstacle configs).
* dynamic cut-in — ``synthetic_dynamic_obs/obs_data_generate_dynamic.py`` +
  ``main_mpc.py:106-126``: obstacles spawn in the left lane (y=+1.75) with
  v ~ N(6, 0.1) and execute a velocity/offset-tracking QP toward the ego
  lane (y=-1.75).  The reference solves one QP per (config, obstacle) in a
  double Python loop; here one batched prefactored solve produces every
  obstacle trajectory of the whole sweep at once.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .basis import uniform_basis
from .config import ProblemConfig


class ScenarioBatch(NamedTuple):
    """A batch of S obstacle scenarios (trajectories over the full horizon)."""

    x_obs: jnp.ndarray       # (S, num_obs) initial positions
    y_obs: jnp.ndarray
    vx_obs: jnp.ndarray
    vy_obs: jnp.ndarray
    psi_obs: jnp.ndarray
    x_traj: jnp.ndarray      # (S, num_obs, num)
    y_traj: jnp.ndarray


# ---------------------------------------------------------------------------
# Static grid (ref: synthetic_static_obs/main_mpc.py:10-21)
# ---------------------------------------------------------------------------

_STATIC_X_GRID = np.array([35, 40, 45, 50, 55, 60, 65, 70, 75], dtype=np.float64)
_LANE_YS = np.array([-1.75, 1.75])


def static_grid(cfg: ProblemConfig, n_configs: int,
                seed0: int = 0) -> ScenarioBatch:
    """Random static obstacles on the 2-lane grid; config k uses numpy
    seed k (bit-compatible with the reference's compute_obs_data)."""
    n_obs = cfg.obstacles.num_obs
    num = cfg.horizon.num
    xs = np.zeros((n_configs, n_obs))
    ys = np.zeros((n_configs, n_obs))
    for k in range(n_configs):
        rng = np.random.RandomState(seed0 + k)
        xs[k] = rng.choice(_STATIC_X_GRID, (n_obs,), replace=False)
        ys[k] = rng.choice(_LANE_YS, (n_obs,))
    zeros = np.zeros_like(xs)
    x_traj = np.repeat(xs[:, :, None], num, axis=2)
    y_traj = np.repeat(ys[:, :, None], num, axis=2)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    return ScenarioBatch(f32(xs), f32(ys), f32(zeros), f32(zeros), f32(zeros),
                         f32(x_traj), f32(y_traj))


# ---------------------------------------------------------------------------
# Dynamic cut-in (ref: obs_data_generate_dynamic.py + dynamic main_mpc.py)
# ---------------------------------------------------------------------------

class _ObsGuessWorkspace(NamedTuple):
    P: jnp.ndarray
    kkt_x_inv: jnp.ndarray
    kkt_y_inv: jnp.ndarray
    g_vx: jnp.ndarray        # (nvar,): lincost_x = v_des * g_vx
    g_py: jnp.ndarray        # (nvar,): lincost_y = y_des * g_py


def _build_obs_guess_workspace(cfg: ProblemConfig) -> _ObsGuessWorkspace:
    """Full-horizon velocity/offset tracking QP (the obstacle behavior model).

    Same structure as the ego guess QP but with ONE segment spanning the
    horizon (ref obs_data_generate_dynamic.py:73-99: A_vd over all rows).
    """
    h = cfg.horizon
    basis = uniform_basis(h.order, h.t_fin, h.num)
    P, Pdot, Pddot = basis.P, basis.Pdot, basis.Pddot
    nvar = basis.nvar
    k_p_v, k_p = 2.0, 2.0
    w_smooth = 100.0
    rho_v, rho_off = 1.0, 1.0

    A_eq_x = np.vstack((P[0], Pdot[0], Pddot[0]))
    A_eq_y = np.vstack((P[0], Pdot[0], Pddot[0], Pdot[-1]))

    A_vd = Pddot - k_p_v * Pdot
    A_pd = Pddot - k_p * P
    cost_x = w_smooth * Pddot.T @ Pddot + rho_v * A_vd.T @ A_vd
    cost_y = w_smooth * Pddot.T @ Pddot + rho_off * A_pd.T @ A_pd

    def kkt(cost, A):
        m = A.shape[0]
        return np.block([[cost, A.T], [A, np.zeros((m, m))]])

    ones = np.ones(h.num)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    return _ObsGuessWorkspace(
        P=f32(P),
        kkt_x_inv=f32(np.linalg.inv(kkt(cost_x, A_eq_x))),
        kkt_y_inv=f32(np.linalg.inv(kkt(cost_y, A_eq_y))),
        g_vx=f32(rho_v * k_p_v * (A_vd.T @ ones)),
        g_py=f32(rho_off * k_p * (A_pd.T @ ones)),
    )


def dynamic_cutin(cfg: ProblemConfig, n_configs: int,
                  y_target: float = -1.75, seed0: int = 0) -> ScenarioBatch:
    """Cut-in traffic: obstacles at y=+1.75 with v~N(6,0.1) tracking
    y_target; positions/speeds drawn per config like the reference
    (obs_data_generate_dynamic.py:136-148, jax.random.choice grids), desired
    velocity keyed by PRNGKey(43k + 11t + 5) (dynamic main_mpc.py:122).
    """
    n_obs = cfg.obstacles.num_obs
    nvar = cfg.horizon.nvar
    ws = _build_obs_guess_workspace(cfg)

    x_grid = jnp.linspace(15.0, 45.0, 30)
    v_grid = jnp.linspace(0.5, 5.0, 15)

    def one_config(k):
        key = jax.random.PRNGKey(seed0 + k)
        x0 = jax.random.choice(key, x_grid, (n_obs,), replace=False)
        y0 = 1.75 * jnp.ones(n_obs)
        vx0 = jax.random.choice(key, v_grid, (n_obs,), replace=False)
        vy0 = jnp.zeros(n_obs)

        def one_obstacle(t, x, vx):
            vkey = jax.random.PRNGKey(43 * (seed0 + k) + 11 * t + 5)
            v_des = jax.random.normal(vkey, ()) * 0.1 + 6.0
            b_eq_x = jnp.stack([x, vx, jnp.float32(0.0)])
            b_eq_y = jnp.asarray([1.75, 0.0, 0.0, 0.0])
            # lincost = +k_p_v*v_des*(A_vd^T 1); the KKT rhs carries -lincost
            rhs_x = jnp.concatenate((-v_des * ws.g_vx, b_eq_x))
            rhs_y = jnp.concatenate((-y_target * ws.g_py, b_eq_y))
            cx = (ws.kkt_x_inv @ rhs_x)[:nvar]
            cy = (ws.kkt_y_inv @ rhs_y)[:nvar]
            return ws.P @ cx, ws.P @ cy

        xt, yt = jax.vmap(one_obstacle)(jnp.arange(n_obs), x0, vx0)
        return x0, y0, vx0, vy0, xt, yt

    x0, y0, vx0, vy0, xt, yt = jax.vmap(one_config)(jnp.arange(n_configs))
    psi = jnp.zeros_like(x0)
    return ScenarioBatch(x0, y0, vx0, vy0, psi, xt, yt)


def ego_initial_state(workload: str = "static") -> Tuple[jnp.ndarray, jnp.ndarray,
                                                         jnp.ndarray, float]:
    """(init_state, cem mean, cem cov, v_des) for a workload.

    Ref: static main_mpc.py:46-74 (ego at y=+1.75) vs dynamic main_mpc.py:38
    (ego at y=-1.75).
    """
    y0 = 1.75 if workload == "static" else -1.75
    init_state = jnp.asarray([0.0, y0, 5.0, 0.0, 0.0, 0.0])
    v_des = 15.0
    mean = jnp.asarray([v_des] * 4 + [0.0] * 4)
    cov = jnp.asarray(np.diag([20.0] * 4 + [100.0] * 4), jnp.float32)
    return init_state, mean, cov, v_des


def blocking_scenarios(tot_time: jnp.ndarray, S: int, n_obs: int = 2
                       ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Tie-free static obstacle scenarios (x_traj, y_traj), (S, n_obs, num).

    Obstacles sit in the ego's near-field path (pairs 9 m apart from
    x = 8 m, in-lane), so every candidate incurs a distinct non-zero
    obstacle cost and the CEM's argsorts meet no exact ties — which makes
    sharded and unsharded solves comparable to rtol 1e-3.
    """
    from .dynamics import constant_velocity_obstacles

    xts, yts = [], []
    for i in range(S):
        x0 = (np.resize([8.0 + 0.37 * i, 13.0 + 0.53 * i], n_obs)
              + np.repeat(np.arange((n_obs + 1) // 2) * 9.0, 2)[:n_obs])
        y0 = np.resize([1.75 - 0.11 * i, 0.6 + 0.13 * i], n_obs)
        z = jnp.zeros(n_obs)
        xt, yt, _ = constant_velocity_obstacles(jnp.asarray(x0),
                                                jnp.asarray(y0), z, z, z,
                                                tot_time)
        xts.append(xt)
        yts.append(yt)
    return jnp.stack(xts), jnp.stack(yts)
