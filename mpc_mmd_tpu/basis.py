"""Bernstein polynomial basis over an arbitrary time interval.

Replacement for the reference's hardcoded order-10 closed forms
(``synthetic_static_obs/bernstein_coeff_order10_arbitinterval.py:13-103``).
Instead of 33 hand-derived expressions we evaluate the basis for *any* order
with the standard derivative recurrence

    d/dt B_{k,n}(t) = n * (B_{k-1,n-1}(t) - B_{k,n-1}(t))

in float64 on the host at setup time.  Basis matrices are trace-time
constants — they are baked into the jitted solver, so there is zero runtime
cost and full float64 accuracy feeding the float32 device math.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Tuple

import numpy as np
from scipy.special import binom


class BernsteinBasis(NamedTuple):
    """Basis matrices sampled at ``num`` time points.

    P      : (num, order+1)  positions
    Pdot   : (num, order+1)  first derivatives  (w.r.t. real time)
    Pddot  : (num, order+1)  second derivatives
    """

    P: np.ndarray
    Pdot: np.ndarray
    Pddot: np.ndarray

    @property
    def nvar(self) -> int:
        return self.P.shape[1]


def _bernstein_matrix(order: int, s: np.ndarray) -> np.ndarray:
    """All Bernstein polynomials of ``order`` at normalized s in [0, 1]."""
    k = np.arange(order + 1)
    # (num, order+1); 0**0 == 1 conventions hold for s in {0,1}
    with np.errstate(invalid="ignore"):
        out = binom(order, k)[None, :] * (s[:, None] ** k[None, :]) * (
            (1.0 - s[:, None]) ** (order - k)[None, :]
        )
    return np.nan_to_num(out)


def bernstein_basis(order: int, tmin: float, tmax: float,
                    t: np.ndarray) -> BernsteinBasis:
    """Evaluate basis + derivatives at times ``t`` within [tmin, tmax].

    Matches the reference's ``bernstein_coeff_order10_new`` (values agree to
    float64 round-off; verified by tests/test_basis.py against the hardcoded
    order-10 closed forms).
    """
    t = np.asarray(t, dtype=np.float64).reshape(-1)
    length = float(tmax) - float(tmin)
    s = (t - float(tmin)) / length

    P = _bernstein_matrix(order, s)

    # First derivative w.r.t. normalized coordinate: n*(B_{k-1,n-1}-B_{k,n-1})
    Pm1 = _bernstein_matrix(order - 1, s)                  # (num, order)
    D1 = np.zeros_like(P)
    D1[:, 1:] += order * Pm1
    D1[:, :-1] -= order * Pm1

    # Second derivative: n*(n-1)*(B_{k-2,n-2} - 2 B_{k-1,n-2} + B_{k,n-2})
    Pm2 = _bernstein_matrix(order - 2, s)                  # (num, order-1)
    D2 = np.zeros_like(P)
    c = order * (order - 1)
    D2[:, 2:] += c * Pm2
    D2[:, 1:-1] -= 2.0 * c * Pm2
    D2[:, :-2] += c * Pm2

    return BernsteinBasis(P=P, Pdot=D1 / length, Pddot=D2 / (length ** 2))


@lru_cache(maxsize=64)
def uniform_basis(order: int, t_fin: float, num: int) -> BernsteinBasis:
    """Basis over ``num`` uniform samples of [0, t_fin] (cached per shape)."""
    t = np.linspace(0.0, t_fin, num)
    return bernstein_basis(order, t[0], t[-1], t)


def segment_slices(num: int, num_segments: int) -> Tuple[slice, ...]:
    """Equal split of the horizon rows into segments.

    Ref: cem.py:97-112 splits 100 rows into 4 x 25 for the guess QP's
    per-segment tracking objectives.
    """
    if num % num_segments != 0:
        raise ValueError(f"num={num} not divisible by num_segments={num_segments}")
    step = num // num_segments
    return tuple(slice(i * step, (i + 1) * step) for i in range(num_segments))
