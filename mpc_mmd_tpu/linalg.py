"""Batched small-matrix linear algebra in pure jnp.

XLA lowers ``jnp.linalg.solve`` to LAPACK custom-calls on CPU and to
library calls on the GPU; for the huge batches of tiny systems this engine produces
(10k+ simultaneous (k+1)-dim reduced-set QPs per CEM iteration,
k = num_reduced <= ~16) that is the wrong tool.  These routines unroll
Cholesky + triangular substitution over the (static, small) dimension as
element-wise/vector ops, which XLA fuses into a handful of kernels with
no custom-call round trips — orders of magnitude faster for this regime and
identical math.

Used by :mod:`mpc_mmd_tpu.reduced_set` via block elimination of the
equality-constrained QP (the KKT matrix [[C, 1], [1^T, 0]] with C positive
definite reduces to two SPD solves — stable without pivoting).
"""

from __future__ import annotations

import jax.numpy as jnp


def cholesky_small(A: jnp.ndarray) -> jnp.ndarray:
    """Batched lower Cholesky factor of SPD matrices (..., n, n), n static.

    Unrolled Cholesky–Crout: n sequential steps of batched vector math.
    """
    n = A.shape[-1]
    L = jnp.zeros_like(A)
    for j in range(n):
        # d_j = sqrt(A_jj - sum_k L_jk^2)
        s = jnp.sum(L[..., j, :j] ** 2, axis=-1) if j else 0.0
        d = jnp.sqrt(A[..., j, j] - s)
        L = L.at[..., j, j].set(d)
        if j + 1 < n:
            # column below the diagonal
            if j:
                cross = jnp.einsum("...ik,...k->...i",
                                   L[..., j + 1:, :j], L[..., j, :j])
            else:
                cross = 0.0
            L = L.at[..., j + 1:, j].set(
                (A[..., j + 1:, j] - cross) / d[..., None])
    return L


def solve_lower(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Forward substitution: L y = b for batched lower-triangular L.

    L: (..., n, n); b: (..., n).
    """
    n = L.shape[-1]
    y = jnp.zeros_like(b)
    for i in range(n):
        s = jnp.einsum("...k,...k->...", L[..., i, :i], y[..., :i]) if i else 0.0
        y = y.at[..., i].set((b[..., i] - s) / L[..., i, i])
    return y


def solve_upper_t(L: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Backward substitution: L^T x = y (L lower-triangular, batched)."""
    n = L.shape[-1]
    x = jnp.zeros_like(y)
    for i in range(n - 1, -1, -1):
        if i + 1 < n:
            s = jnp.einsum("...k,...k->...", L[..., i + 1:, i], x[..., i + 1:])
        else:
            s = 0.0
        x = x.at[..., i].set((y[..., i] - s) / L[..., i, i])
    return x


def cho_solve_small(L: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve A x = b given the Cholesky factor L of SPD A (batched)."""
    return solve_upper_t(L, solve_lower(L, b))


def eq_qp_solve(C: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """min_b 1/2 b^T C b - r^T b  s.t.  sum(b) = 1, with C SPD (batched).

    Block elimination of the KKT system [[C, 1], [1^T, 0]]:
        z = C^{-1} r,  w = C^{-1} 1,
        mu = (1^T z - 1) / (1^T w),   b = z - mu * w.
    Equivalent to the reference's dense KKT ``jnp.linalg.solve``
    (compute_beta.py:74-81) but runs as fused vector ops.

    Returns (b, mu); the multiplier lets callers recover the quadratic form
    b^T C b = b^T r - mu without an O(n^2) contraction.
    """
    L = cholesky_small(C)
    ones = jnp.ones_like(r)
    z = cho_solve_small(L, r)
    w = cho_solve_small(L, ones)
    mu = (jnp.sum(z, axis=-1) - 1.0) / jnp.sum(w, axis=-1)
    return z - mu[..., None] * w, mu
