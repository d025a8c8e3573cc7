"""Frenet-frame toolkit: path splines, smoothing, global<->Frenet transforms.

Capability-parity port target: ``carla/optimizer/cem_helper.py:112-410``
(path spline, 300 m waypoint window, jerk-penalized AM path smoothing with a
precomputed KKT inverse, finite-difference path parameters + curvature,
state/obstacle/trajectory Frenet conversions with the velocity/acceleration
chain rule through kappa and kappa').

Design notes
------------
* Episode-level path fitting (the reference's scipy CubicSpline over the
  global route, host-side) stays on host at setup; everything per-MPC-step
  is jnp with static shapes.
* The reference converts rollout points to Frenet with a per-point
  ``lax.scan`` of argmin+interp (cem_helper.py:205-242); here the nearest-
  point search is one batched distance-matrix argmin over all rollout points
  at once — a single fused reduction instead of T sequential steps.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


class PathSpline(NamedTuple):
    """Host-side arclength-parameterized cubic spline of a global route."""

    arc_vec: np.ndarray
    arc_length: float
    cs_x: object
    cs_y: object
    cs_phi: object
    x_data: np.ndarray
    y_data: np.ndarray


class FrenetFrame(NamedTuple):
    """Per-MPC-step local path representation (static shapes, device)."""

    x_path: jnp.ndarray     # (num_path,) smoothed local path
    y_path: jnp.ndarray
    Fx_dot: jnp.ndarray     # path tangents (finite difference)
    Fy_dot: jnp.ndarray
    arc_vec: jnp.ndarray    # cumulative arc length
    kappa: jnp.ndarray      # signed curvature
    arc_length: jnp.ndarray


def fit_path_spline(x_path: np.ndarray, y_path: np.ndarray) -> PathSpline:
    """Arclength cubic-spline fit (host).  Ref: carla/optimizer/
    cem_helper.py:244-262."""
    from scipy.interpolate import CubicSpline

    x_diff = np.diff(x_path)
    y_diff = np.diff(y_path)
    phi = np.unwrap(np.arctan2(y_diff, x_diff))
    phi = np.hstack((phi[0], phi))
    arc = np.cumsum(np.sqrt(x_diff ** 2 + y_diff ** 2))
    arc_length = float(arc[-1])
    arc_vec = np.linspace(0, arc_length, x_path.shape[0])
    return PathSpline(arc_vec=arc_vec, arc_length=arc_length,
                      cs_x=CubicSpline(arc_vec, x_path),
                      cs_y=CubicSpline(arc_vec, y_path),
                      cs_phi=CubicSpline(arc_vec, phi),
                      x_data=np.asarray(x_path), y_data=np.asarray(y_path))


def waypoint_window(spline: PathSpline, x_ego: float, y_ego: float,
                    lookahead: float = 300.0, num_path: int = 600
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """300 m lookahead window of num_path points.  Ref: cem_helper.py:264-276."""
    idx = int(np.argmin(np.sqrt((x_ego - spline.x_data) ** 2
                                + (y_ego - spline.y_data) ** 2)))
    arc_curr = spline.arc_vec[idx]
    arc_look = np.linspace(arc_curr, arc_curr + lookahead, num_path)
    return (np.asarray(spline.cs_x(arc_look)),
            np.asarray(spline.cs_y(arc_look)),
            np.asarray(spline.cs_phi(arc_look)))


# ---------------------------------------------------------------------------
# AM path smoothing (ref cem_helper.py:112-129, 278-318, 390-410)
# ---------------------------------------------------------------------------

class SmootherWorkspace(NamedTuple):
    kkt_inv: jnp.ndarray     # (num_path+1, num_path+1)
    num_path: int
    maxiter: int


def build_smoother(num_path: int = 600, rho: float = 1.0,
                   jerk_weight: float = 20.0,
                   maxiter: int = 10) -> SmootherWorkspace:
    """Jerk-penalized proximal smoothing QP, KKT inverse precomputed on host
    (the reference also prefactors this one — cem_helper.py:129)."""
    I = np.eye(num_path)
    A_jerk = np.diff(np.diff(np.diff(I, axis=0), axis=0), axis=0)
    cost = jerk_weight * (A_jerk.T @ A_jerk) + rho * I
    A_eq = I[0:1]
    kkt = np.block([[cost, A_eq.T], [A_eq, np.zeros((1, 1))]])
    return SmootherWorkspace(kkt_inv=jnp.asarray(np.linalg.inv(kkt),
                                                 jnp.float32),
                             num_path=num_path, maxiter=maxiter)


def smooth_path(sw: SmootherWorkspace, x_wp: jnp.ndarray, y_wp: jnp.ndarray,
                threshold: float = 0.1) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Alternating proximal smoothing within ``threshold`` of the waypoints.

    Ref: custom_path_smoothing / compute_x_smoothing / compute_alpha_smoothing.
    """
    n = sw.num_path
    rho = 1.0

    def am_iter(carry, _):
        alpha, d, lam_x, lam_y = carry
        b_x = x_wp + d * jnp.cos(alpha)
        b_y = y_wp + d * jnp.sin(alpha)
        rhs_x = jnp.concatenate((lam_x + rho * b_x, x_wp[0:1]))
        rhs_y = jnp.concatenate((lam_y + rho * b_y, y_wp[0:1]))
        x_s = (sw.kkt_inv @ rhs_x)[:n]
        y_s = (sw.kkt_inv @ rhs_y)[:n]

        wc = x_s - x_wp
        wsn = y_s - y_wp
        alpha = jnp.arctan2(wsn, wc)
        d = jnp.minimum(wc * jnp.cos(alpha) + wsn * jnp.sin(alpha), threshold)
        res_x = wc - d * jnp.cos(alpha)
        res_y = wsn - d * jnp.sin(alpha)
        lam_x = lam_x - rho * res_x
        lam_y = lam_y - rho * res_y
        return (alpha, d, lam_x, lam_y), (x_s, y_s)

    carry0 = (jnp.zeros(n), threshold * jnp.ones(n), jnp.zeros(n), jnp.zeros(n))
    _, (xs, ys) = lax.scan(am_iter, carry0, None, length=sw.maxiter)
    return xs[-1], ys[-1]


# ---------------------------------------------------------------------------
# Path parameters + conversions (all jnp)
# ---------------------------------------------------------------------------

def path_parameters(x_path: jnp.ndarray, y_path: jnp.ndarray) -> FrenetFrame:
    """Finite-difference tangents, arc length, curvature.
    Ref: cem_helper.py:320-345."""
    Fx_dot = jnp.diff(x_path)
    Fy_dot = jnp.diff(y_path)
    Fx_dot = jnp.concatenate((Fx_dot[:1], Fx_dot))
    Fy_dot = jnp.concatenate((Fy_dot[:1], Fy_dot))
    Fx_ddot = jnp.diff(Fx_dot)
    Fy_ddot = jnp.diff(Fy_dot)
    Fx_ddot = jnp.concatenate((Fx_ddot[:1], Fx_ddot))
    Fy_ddot = jnp.concatenate((Fy_ddot[:1], Fy_ddot))
    arc = jnp.cumsum(jnp.sqrt(Fx_dot ** 2 + Fy_dot ** 2))
    arc_vec = jnp.concatenate((jnp.zeros(1), arc[:-1]))
    kappa = (Fy_ddot * Fx_dot - Fx_ddot * Fy_dot) / (
        (Fx_dot ** 2 + Fy_dot ** 2) ** 1.5)
    return FrenetFrame(x_path=x_path, y_path=y_path, Fx_dot=Fx_dot,
                       Fy_dot=Fy_dot, arc_vec=arc_vec, kappa=kappa,
                       arc_length=arc_vec[-1])


def _nearest(frame: FrenetFrame, x, y):
    """Nearest path index for scalar point (x, y)."""
    return jnp.argmin((frame.x_path - x) ** 2 + (frame.y_path - y) ** 2)


def global_to_frenet_state(frame: FrenetFrame, state) -> Tuple:
    """Full state conversion with velocity/acceleration chain rule.

    state: [x, y, v, vdot, psi, psidot] (global).
    Returns (s, l, vs, vl, as_, al, psi_rel, psi_fin, psidot_rel).
    Ref: cem_helper.py:347-388.
    """
    x_g, y_g, v_g, vdot_g, psi_g, psidot_g = [state[i] for i in range(6)]
    idx = _nearest(frame, x_g, y_g)
    cx, cy = frame.x_path[idx], frame.y_path[idx]
    s = frame.arc_vec[idx]

    kappa_i = jnp.interp(s, frame.arc_vec, frame.kappa)
    kappa_p = jnp.interp(s + 0.001, frame.arc_vec, frame.kappa)
    kappa_prime = (kappa_p - kappa_i) / 0.001

    tx = jnp.interp(s, frame.arc_vec, frame.Fx_dot)
    ty = jnp.interp(s, frame.arc_vec, frame.Fy_dot)
    normal = jnp.stack([-ty, tx])
    vec = jnp.stack([x_g - cx, y_g - cy])
    l = jnp.dot(normal, vec) / jnp.linalg.norm(normal)

    psi_rel = psi_g - jnp.arctan2(ty, tx)
    psi_rel = jnp.arctan2(jnp.sin(psi_rel), jnp.cos(psi_rel))

    vs = v_g * jnp.cos(psi_rel) / (1.0 - l * kappa_i)
    vl = v_g * jnp.sin(psi_rel)
    psidot_rel = psidot_g - kappa_i * vs

    al = vdot_g * jnp.sin(psi_rel) + v_g * jnp.cos(psi_rel) * psidot_rel
    as_p1 = vdot_g * jnp.cos(psi_rel) - v_g * jnp.sin(psi_rel) * psidot_rel
    as_p2 = -vl * kappa_i - l * kappa_prime * vs
    as_ = (as_p1 * (1.0 - l * kappa_i)
           - (v_g * jnp.cos(psi_rel)) * as_p2) / ((1.0 - l * kappa_i) ** 2)
    return s, l, vs, vl, as_, al, psi_rel, jnp.float32(0.0), psidot_rel


def global_to_frenet_obstacle(frame: FrenetFrame, x_o, y_o, vx_o, vy_o, psi_o):
    """Per-obstacle conversion.  Ref: cem_helper.py:170-200."""
    v_o = jnp.sqrt(vx_o ** 2 + vy_o ** 2)
    idx = _nearest(frame, x_o, y_o)
    cx, cy = frame.x_path[idx], frame.y_path[idx]
    s = frame.arc_vec[idx]
    kappa_i = jnp.interp(s, frame.arc_vec, frame.kappa)
    tx = jnp.interp(s, frame.arc_vec, frame.Fx_dot)
    ty = jnp.interp(s, frame.arc_vec, frame.Fy_dot)
    normal = jnp.stack([-ty, tx])
    vec = jnp.stack([x_o - cx, y_o - cy])
    l = jnp.dot(normal, vec) / jnp.linalg.norm(normal)
    psi_rel = psi_o - jnp.arctan2(ty, tx)
    psi_rel = jnp.arctan2(jnp.sin(psi_rel), jnp.cos(psi_rel))
    vs = v_o * jnp.cos(psi_rel) / (1.0 - l * kappa_i)
    vl = v_o * jnp.sin(psi_rel)
    return s, l, vs, vl, psi_rel


def global_to_frenet_points(frame: FrenetFrame, x: jnp.ndarray,
                            y: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Pointwise conversion of trajectory batches (..., T).

    One batched nearest-point reduction replaces the reference's per-point
    scan (cem_helper.py:205-242); values match (same argmin + normal
    projection).
    """
    shape = x.shape
    xf = x.reshape(-1)
    yf = y.reshape(-1)
    d2 = ((xf[:, None] - frame.x_path[None, :]) ** 2
          + (yf[:, None] - frame.y_path[None, :]) ** 2)
    idx = jnp.argmin(d2, axis=1)
    cx = frame.x_path[idx]
    cy = frame.y_path[idx]
    s = frame.arc_vec[idx]
    tx = jnp.interp(s, frame.arc_vec, frame.Fx_dot)
    ty = jnp.interp(s, frame.arc_vec, frame.Fy_dot)
    norm = jnp.sqrt(tx ** 2 + ty ** 2)
    l = (-(ty) * (xf - cx) + tx * (yf - cy)) / norm
    return s.reshape(shape), l.reshape(shape)


def frenet_to_global(frame: FrenetFrame, s: jnp.ndarray, l: jnp.ndarray
                     ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Frenet trajectory -> global via the path normal.
    Ref: cem_helper.py:153-168 + the interp calls in main_carla.py:388-392."""
    ref_x = jnp.interp(s, frame.arc_vec, frame.x_path)
    ref_y = jnp.interp(s, frame.arc_vec, frame.y_path)
    tx = jnp.interp(s, frame.arc_vec, frame.Fx_dot)
    ty = jnp.interp(s, frame.arc_vec, frame.Fy_dot)
    norm = jnp.sqrt(tx ** 2 + ty ** 2)
    gx = ref_x + l * (-ty / norm)
    gy = ref_y + l * (tx / norm)
    psi = jnp.arctan2(jnp.diff(gy), jnp.diff(gx))
    return gx, gy, psi
