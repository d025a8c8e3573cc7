"""Equality-constrained QP machinery: workspace precompute + guess QP.

Design notes
------------
* Every KKT system whose matrix is iteration-independent — the guess QP
  (ref ``cem_helper.py:216-223``), both projection QPs
  (``projection.py:145-168``) and the Bernstein re-fit
  (``cem_helper.py:553-564``) — is factored ONCE on the host in float64 and
  its inverse stored in the workspace.  Every per-iteration "solve" is then a
  single (n x n) @ (n x batch) matmul instead of the reference's
  repeated ``jnp.linalg.solve`` of the same matrix.
* The guess QP's linear cost collapses analytically: the tracking targets are
  constant-per-segment, so A_vd_i^T b_vd_i = -k_p_v * v_des_i * (A_vd_i^T 1).
  We precompute the 4 x nvar matrix of those column sums and replace eight
  (nvar x seg) @ (seg x batch) matmuls per iteration with one (batch x 4) @
  (4 x nvar) matmul.  Exact in real arithmetic.
* ``solve_strategy="exact"`` keeps the reference's ``jnp.linalg.solve`` path
  for bit-level parity experiments.

Reference parity targets: cem_helper.py:169-230 (guess QP), cem.py:55-56
(equality rows), cem.py:126-134 (lane-bound matrix).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
import numpy as np

from .basis import segment_slices, uniform_basis
from .config import ProblemConfig


class Workspace(NamedTuple):
    """Trace-time-constant arrays shared by all solver stages (float32)."""

    # Bernstein basis over the full horizon (num, nvar)
    P: jnp.ndarray
    Pdot: jnp.ndarray
    Pddot: jnp.ndarray
    # Basis over the rollout sub-horizon (num_prime, nvar)
    P_prime: jnp.ndarray
    Pdot_prime: jnp.ndarray
    Pddot_prime: jnp.ndarray
    # Equality constraint rows (3, nvar) / (4, nvar).  Ref cem.py:55-56.
    A_eq_x: jnp.ndarray
    A_eq_y: jnp.ndarray
    # Lane inequality matrix (2*(num-1), nvar).  Ref cem.py:126-134.
    A_lane: jnp.ndarray
    # Guess QP: KKT matrices and inverses; collapsed linear-cost generators.
    guess_kkt_x: jnp.ndarray        # (nvar+3, nvar+3)
    guess_kkt_y: jnp.ndarray        # (nvar+4, nvar+4)
    guess_kkt_x_inv: jnp.ndarray
    guess_kkt_y_inv: jnp.ndarray
    G_vx: jnp.ndarray               # (num_segments, nvar): lincost_x = V @ G_vx
    G_py: jnp.ndarray               # (num_segments, nvar): lincost_y = Y @ G_py
    # Projection QP KKT (+ inverses).
    proj_kkt_x: jnp.ndarray
    proj_kkt_y: jnp.ndarray
    proj_kkt_x_inv: jnp.ndarray
    proj_kkt_y_inv: jnp.ndarray
    # Bernstein least-squares re-fit over the sub-horizon.
    refit_inv: jnp.ndarray          # (nvar, nvar) == inv(P'^T P' + 0.05 I)
    # Time grid (num,)
    tot_time: jnp.ndarray


def _kkt(cost: np.ndarray, A_eq: np.ndarray) -> np.ndarray:
    m = A_eq.shape[0]
    return np.block([[cost, A_eq.T], [A_eq, np.zeros((m, m))]])


def build_workspace(cfg: ProblemConfig) -> Workspace:
    """Host-side float64 precompute of all constant solver matrices."""
    h, g, pj = cfg.horizon, cfg.guess, cfg.projection
    basis = uniform_basis(h.order, h.t_fin, h.num)
    P, Pdot, Pddot = basis.P, basis.Pdot, basis.Pddot
    nvar = basis.nvar

    t_prime = np.linspace(0.0, h.num_prime * h.dt, h.num_prime)
    basis_p = uniform_basis(h.order, float(t_prime[-1]), h.num_prime)

    # Equality rows: initial position/velocity/acceleration (+ final ydot = 0
    # on the y channel).  Ref cem.py:55-56.
    A_eq_x = np.vstack((P[0], Pdot[0], Pddot[0]))
    A_eq_y = np.vstack((P[0], Pdot[0], Pddot[0], Pdot[-1]))

    # Lane bound rows.  Ref cem.py:126-134 (gamma-discounted one-step form).
    gam = cfg.lane.gamma
    A_ub = P[1:] + (gam - 1.0) * P[:-1]
    A_lb = -P[1:] + (1.0 - gam) * P[:-1]
    A_lane = np.vstack((A_ub, A_lb))

    # ---- Guess QP ----------------------------------------------------------
    slices = segment_slices(h.num, g.num_segments)
    cost_sx = g.weight_smoothness_x * Pddot.T @ Pddot
    cost_sy = g.weight_smoothness_y * Pddot.T @ Pddot
    cost_gx = cost_sx.copy()
    cost_gy = cost_sy.copy()
    G_vx = np.zeros((g.num_segments, nvar))
    G_py = np.zeros((g.num_segments, nvar))
    for i, sl in enumerate(slices):
        A_vd = Pddot[sl] - g.k_p_v * Pdot[sl]
        A_pd = Pddot[sl] - g.k_p * P[sl]
        cost_gx += g.rho_v * A_vd.T @ A_vd
        cost_gy += g.rho_offset * A_pd.T @ A_pd
        ones = np.ones(sl.stop - sl.start)
        # lincost_x = -rho_v * A_vd^T b_vd with b_vd = -k_p_v * v_des * 1
        #           = +rho_v * k_p_v * v_des * (A_vd^T 1)
        G_vx[i] = g.rho_v * g.k_p_v * (A_vd.T @ ones)
        G_py[i] = g.rho_offset * g.k_p * (A_pd.T @ ones)

    guess_kkt_x = _kkt(cost_gx, A_eq_x)
    guess_kkt_y = _kkt(cost_gy, A_eq_y)

    # ---- Projection QP -----------------------------------------------------
    cost_px = (pj.rho_projection * np.eye(nvar)
               + pj.rho_ineq * (Pddot.T @ Pddot)
               + pj.rho_ineq * (Pdot.T @ Pdot))
    cost_py = cost_px + pj.rho_lane * (A_lane.T @ A_lane)
    if pj.with_obstacle_terms:
        # A_obs = tile(P, num_obs) so A_obs^T A_obs == num_obs * P^T P.
        # Ref: cem.py:65, projection_det.py:151-165.
        n_rows = cfg.obstacles.num_obs * cfg.obstacles.num_circles
        cost_px = cost_px + pj.rho_obs * n_rows * (P.T @ P)
        cost_py = cost_py + pj.rho_obs * n_rows * (P.T @ P)
    proj_kkt_x = _kkt(cost_px, A_eq_x)
    proj_kkt_y = _kkt(cost_py, A_eq_y)

    # ---- Bernstein re-fit --------------------------------------------------
    refit_mat = basis_p.P.T @ basis_p.P + 0.05 * np.eye(nvar)

    f32 = lambda a: jnp.asarray(a, dtype=jnp.float32)
    return Workspace(
        P=f32(P), Pdot=f32(Pdot), Pddot=f32(Pddot),
        P_prime=f32(basis_p.P), Pdot_prime=f32(basis_p.Pdot),
        Pddot_prime=f32(basis_p.Pddot),
        A_eq_x=f32(A_eq_x), A_eq_y=f32(A_eq_y), A_lane=f32(A_lane),
        guess_kkt_x=f32(guess_kkt_x), guess_kkt_y=f32(guess_kkt_y),
        guess_kkt_x_inv=f32(np.linalg.inv(guess_kkt_x)),
        guess_kkt_y_inv=f32(np.linalg.inv(guess_kkt_y)),
        G_vx=f32(G_vx), G_py=f32(G_py),
        proj_kkt_x=f32(proj_kkt_x), proj_kkt_y=f32(proj_kkt_y),
        proj_kkt_x_inv=f32(np.linalg.inv(proj_kkt_x)),
        proj_kkt_y_inv=f32(np.linalg.inv(proj_kkt_y)),
        refit_inv=f32(np.linalg.inv(refit_mat)),
        tot_time=f32(np.linspace(0.0, h.t_fin, h.num)),
    )


def kkt_solve(kkt: jnp.ndarray, kkt_inv: jnp.ndarray, rhs: jnp.ndarray,
              strategy: str) -> jnp.ndarray:
    """Solve KKT @ sol^T = rhs^T for a batch of right-hand sides (batch, n).

    prefactored: one matmul with the host-float64 inverse.
    exact: the reference's jnp.linalg.solve (projection.py:167-168).
    """
    if strategy == "prefactored":
        return rhs @ kkt_inv.T
    return jnp.linalg.solve(kkt, rhs.T).T


def compute_guess(cfg: ProblemConfig, ws: Workspace, params: jnp.ndarray,
                  b_eq_x: jnp.ndarray, b_eq_y: jnp.ndarray
                  ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Behavioral params (batch, 8) -> Bernstein coefficient guess (batch, nvar).

    params columns: [v_des_1..4, y_des_1..4].  Ref: cem_helper.py:169-230.
    """
    nvar = cfg.horizon.nvar
    nseg = cfg.guess.num_segments
    V = params[:, :nseg]
    Y = params[:, nseg:2 * nseg]

    lincost_x = V @ ws.G_vx          # (batch, nvar)
    lincost_y = Y @ ws.G_py

    rhs_x = jnp.concatenate((-lincost_x, b_eq_x), axis=1)
    rhs_y = jnp.concatenate((-lincost_y, b_eq_y), axis=1)

    sol_x = kkt_solve(ws.guess_kkt_x, ws.guess_kkt_x_inv, rhs_x, cfg.solve_strategy)
    sol_y = kkt_solve(ws.guess_kkt_y, ws.guess_kkt_y_inv, rhs_y, cfg.solve_strategy)
    return sol_x[:, :nvar], sol_y[:, :nvar]


def boundary_vectors(cfg: ProblemConfig, init_state: jnp.ndarray
                     ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Equality RHS replicated across the candidate batch.

    init_state: (6,) = [x, y, vx, vy, ax, ay].  Ref: cem_helper.py:152-167.
    """
    nb = cfg.cem.num_batch
    x0, y0, vx0, vy0, ax0, ay0 = [init_state[i] for i in range(6)]
    ones = jnp.ones((nb, 1))
    b_eq_x = jnp.concatenate((x0 * ones, vx0 * ones, ax0 * ones), axis=1)
    b_eq_y = jnp.concatenate((y0 * ones, vy0 * ones, ay0 * ones,
                              jnp.zeros((nb, 1))), axis=1)
    return b_eq_x, b_eq_y


def refit_coefficients(ws: Workspace, x: jnp.ndarray, y: jnp.ndarray
                       ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Ridge-regularized Bernstein LSQ fit of rollouts over the sub-horizon.

    x, y: (..., B, num_prime) -> coefficients (..., B, nvar).
    Ref: cem_helper.py:553-564 (0.05 ridge).
    """
    cx = (x @ ws.P_prime) @ ws.refit_inv.T
    cy = (y @ ws.P_prime) @ ws.refit_inv.T
    return cx, cy
