"""Risk costs over noisy rollout ensembles.

Per candidate trajectory we reduce an ensemble of noisy rollouts to a scalar
risk: elliptical obstacle violation / lane violation "bars", then one of

* ``mmd``       — MMD^2 of the (reduced-set-weighted) violation samples
                  against the all-zeros ideal distribution (the paper's cost)
* ``cvar``      — CVaR_alpha tail mean of the violation samples
* ``saa``       — sample-average violation indicator fraction

Design note: the reference's per-candidate jitted vmaps
(``synthetic_static_obs/optimizer/costs.py:25-48``) become plain batched
expressions here — callers vmap once over the candidate axis; the CVaR
NaN-masking + ``lax.cond`` dance (costs.py:215-219) is replaced by an exactly
equivalent masked mean (no NaNs, vmap/pallas friendly).

Reference parity: costs.py:50-234.
"""

from __future__ import annotations

import jax.numpy as jnp

from .config import ProblemConfig
from .kernels import mmd_vs_zero


def f_bar_obs(cfg: ProblemConfig, x_roll: jnp.ndarray, y_roll: jnp.ndarray,
              x_obs: jnp.ndarray, y_obs: jnp.ndarray) -> jnp.ndarray:
    """Elliptical obstacle violation, max over time and obstacles.

    x_roll, y_roll: (R, T) rollouts; x_obs, y_obs: (num_obs, T).
    Returns (R,) violation magnitudes (0 when clear).
    Ref: costs.py:50-60 then the double max at :180.
    """
    dx = x_roll[:, None, :] - x_obs[None, :, :]          # (R, num_obs, T)
    dy = y_roll[:, None, :] - y_obs[None, :, :]
    cost = 1.0 - (dx ** 2) / cfg.obstacles.a_obs ** 2 - (dy ** 2) / cfg.obstacles.b_obs ** 2
    return jnp.max(jnp.maximum(cost, 0.0), axis=(1, 2))


def lane_bars(cfg: ProblemConfig, y_roll: jnp.ndarray):
    """Lane lower/upper violation, max over time.  Ref: costs.py:62-71,126-127."""
    lb = jnp.maximum(cfg.lane.y_lb - y_roll, 0.0)
    ub = jnp.maximum(y_roll - cfg.lane.y_ub, 0.0)
    return jnp.max(lb, axis=-1), jnp.max(ub, axis=-1)


def cvar_reduce(samples: jnp.ndarray, alpha: float) -> jnp.ndarray:
    """Mean of samples >= the alpha-quantile (masked mean, no NaNs).

    Equivalent to the reference's quantile + NaN-mask + cond
    (costs.py:215-219): the mask always contains the max, and the
    ``num_cvar > 0`` guard only matters in the measure-zero case reproduced
    here by the ``where``.
    """
    var_alpha = jnp.quantile(samples, alpha, axis=-1, keepdims=True)
    mask = samples >= var_alpha
    n = jnp.sum(mask, axis=-1)
    s = jnp.sum(jnp.where(mask, samples, 0.0), axis=-1)
    return jnp.where(n > 0, s / jnp.maximum(n, 1), 0.0)


def saa_reduce(samples: jnp.ndarray, num_reduced: int) -> jnp.ndarray:
    """Violation fraction.  Ref: costs.py:230-234 (note the fixed
    1/num_reduced normalization even for lane's two-sided sum)."""
    return jnp.sum(jnp.where(samples > 0.0, 1.0, 0.0), axis=-1) / num_reduced


# ---------------------------------------------------------------------------
# Per-candidate scalar risks (vmap these over the candidate axis).
# ---------------------------------------------------------------------------

def mmd_obs(cfg: ProblemConfig, beta: jnp.ndarray, sigma: jnp.ndarray,
            x_roll: jnp.ndarray, y_roll: jnp.ndarray,
            x_obs: jnp.ndarray, y_obs: jnp.ndarray) -> jnp.ndarray:
    """Ref: costs.py:173-186."""
    viol = f_bar_obs(cfg, x_roll, y_roll, x_obs, y_obs)
    return mmd_vs_zero(beta, viol, sigma, cfg.risk.ker_wt,
                       kind=cfg.risk.kernel)


def mmd_lane(cfg: ProblemConfig, beta: jnp.ndarray, sigma: jnp.ndarray,
             y_roll: jnp.ndarray) -> jnp.ndarray:
    """Ref: costs.py:121-135."""
    lb, ub = lane_bars(cfg, y_roll)
    return (mmd_vs_zero(beta, lb, sigma, cfg.risk.ker_wt,
                        kind=cfg.risk.kernel)
            + mmd_vs_zero(beta, ub, sigma, cfg.risk.ker_wt,
                          kind=cfg.risk.kernel))


def cvar_obs(cfg: ProblemConfig, x_roll: jnp.ndarray, y_roll: jnp.ndarray,
             x_obs: jnp.ndarray, y_obs: jnp.ndarray) -> jnp.ndarray:
    """Ref: costs.py:206-221."""
    viol = f_bar_obs(cfg, x_roll, y_roll, x_obs, y_obs)
    return cvar_reduce(viol, cfg.risk.alpha_quant)


def cvar_lane(cfg: ProblemConfig, y_roll: jnp.ndarray) -> jnp.ndarray:
    """Ref: costs.py:137-158."""
    lb, ub = lane_bars(cfg, y_roll)
    return (cvar_reduce(lb, cfg.risk.alpha_quant)
            + cvar_reduce(ub, cfg.risk.alpha_quant))


def saa_obs(cfg: ProblemConfig, x_roll: jnp.ndarray, y_roll: jnp.ndarray,
            x_obs: jnp.ndarray, y_obs: jnp.ndarray) -> jnp.ndarray:
    """Ref: costs.py:223-234."""
    viol = f_bar_obs(cfg, x_roll, y_roll, x_obs, y_obs)
    return saa_reduce(viol, cfg.risk.num_reduced)


def saa_lane(cfg: ProblemConfig, y_roll: jnp.ndarray) -> jnp.ndarray:
    """Ref: costs.py:160-171."""
    lb, ub = lane_bars(cfg, y_roll)
    return (saa_reduce(lb, cfg.risk.num_reduced)
            + saa_reduce(ub, cfg.risk.num_reduced))


# ---------------------------------------------------------------------------
# Desired-lane variants (zero-weighted in every reference config but part of
# the cost surface; ref costs.py:73-118).  The violation "bar" is the
# reference's exact (quirky) form: the product of the SCALAR Frobenius
# distances of the whole rollout block to each lane center, minus the margin,
# broadcast and reduced like the other bars.
# ---------------------------------------------------------------------------

def lane_des_bar(cfg: ProblemConfig, y_roll: jnp.ndarray) -> jnp.ndarray:
    c1 = jnp.linalg.norm(y_roll - cfg.lane.y_des_1)
    c2 = jnp.linalg.norm(y_roll - cfg.lane.y_des_2)
    cost = c1 * c2 - cfg.lane.gamma_lane_des
    bar = jnp.maximum(jnp.zeros_like(y_roll), cost)
    return jnp.max(bar, axis=-1)                       # (R,)


def mmd_lane_des(cfg: ProblemConfig, beta: jnp.ndarray, sigma: jnp.ndarray,
                 y_roll: jnp.ndarray) -> jnp.ndarray:
    """Ref: costs.py:73-87 (carla signature with per-candidate beta/sigma)."""
    return mmd_vs_zero(beta, lane_des_bar(cfg, y_roll), sigma,
                       cfg.risk.ker_wt, kind=cfg.risk.kernel)


def cvar_lane_des(cfg: ProblemConfig, y_roll: jnp.ndarray) -> jnp.ndarray:
    """Ref: costs.py:89-105."""
    return cvar_reduce(lane_des_bar(cfg, y_roll), cfg.risk.alpha_quant_lane)


def saa_lane_des(cfg: ProblemConfig, y_roll: jnp.ndarray) -> jnp.ndarray:
    """Ref: costs.py:107-118."""
    return saa_reduce(lane_des_bar(cfg, y_roll), cfg.risk.num_reduced)
