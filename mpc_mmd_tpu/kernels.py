"""Kernel Gram matrices and Maximum Mean Discrepancy.

Design notes
------------
* The Laplacian kernel exp(-||a-b||_1 / sigma) factors into a
  sigma-independent pairwise L1 *distance* matrix and a cheap per-sigma
  exp rescale.  The inner beta-CEM evaluates kernels of *row subsets of the
  same mother set* for 100 bandwidth samples x 20 iterations — the reference
  recomputes the full pairwise feature differences every time
  (``synthetic_static_obs/kernel_computation.py:58-65`` called from
  ``compute_beta.py:127``); we compute the (M, M) distance matrix ONCE per
  candidate and reduce every subsequent kernel evaluation to
  gather + exp.  This removes the dominant O(iters * samples * k * M * F)
  feature-difference traffic entirely.
* Distances are computed via broadcast |a_i - b_j| summed over features —
  one fused elementwise reduction.  Feature count here is 2*nvar = 22.

Reference parity: kernel_computation.py:20-87 (Laplace kernel + MMD with the
all-zeros target sample set and dropped third term); Gaussian and Matern
variants appear commented-out in the reference (:21-29, :41-53) and are
provided here as first-class options.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def pairwise_l1(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """(..., m, F) x (..., n, F) -> (..., m, n) pairwise L1 distances."""
    return jnp.sum(jnp.abs(A[..., :, None, :] - B[..., None, :, :]), axis=-1)


def pairwise_l2sq(A: jnp.ndarray, B: jnp.ndarray) -> jnp.ndarray:
    """Pairwise squared-L2 distances via the matmul expansion."""
    aa = jnp.sum(A * A, axis=-1)
    bb = jnp.sum(B * B, axis=-1)
    ab = jnp.einsum("...mf,...nf->...mn", A, B)
    return jnp.maximum(aa[..., :, None] + bb[..., None, :] - 2.0 * ab, 0.0)


def laplace_kernel(dists_l1: jnp.ndarray, sigma) -> jnp.ndarray:
    """exp(-d/sigma). Ref: kernel_computation.py:33-39."""
    return jnp.exp(-dists_l1 / sigma)


def gaussian_kernel(dists_l2sq: jnp.ndarray, sigma) -> jnp.ndarray:
    """exp(-d^2 / (2 sigma^2)). Ref (commented variant): kernel_computation.py:21-29."""
    return jnp.exp(-dists_l2sq / (2.0 * sigma ** 2))


def matern52_kernel(dists_l1: jnp.ndarray, dists_l2sq: jnp.ndarray,
                    sigma) -> jnp.ndarray:
    """Matern-5/2 with L1 radius (the reference's commented form,
    kernel_computation.py:41-53)."""
    r1 = jnp.sqrt(5.0) * dists_l1 / sigma
    return (1.0 + r1 + 5.0 * dists_l2sq / (3.0 * sigma ** 2)) * jnp.exp(-r1)


KERNEL_KINDS = ("laplace", "gaussian", "matern52")


def kernel_of(kind: str, sigma, d1=None, d2sq=None) -> jnp.ndarray:
    """Evaluate the configured kernel from precomputed distance tensors.

    The selectable-kernel plumbing (``RiskConfig.kernel``): every kernel in
    the family is a cheap elementwise map of iteration-constant pairwise
    distances, so callers cache d1 = pairwise L1 and (only when the kind
    needs it) d2sq = pairwise squared L2, and bandwidth sweeps reduce to
    this function.  ``sigma`` may be scalar or broadcast against the
    distance tensors.  Ref: kernel_computation.py:21-53 (the reference
    ships the Gaussian/Matern variants commented out; here they are
    config-reachable).
    """
    if kind == "laplace":
        return laplace_kernel(d1, sigma)
    if kind == "gaussian":
        return gaussian_kernel(d2sq, sigma)
    if kind == "matern52":
        return matern52_kernel(d1, d2sq, sigma)
    raise ValueError(f"unknown kernel kind {kind!r} (expected one of "
                     f"{KERNEL_KINDS})")


def blockwise_mmd_vs_zero(beta: jnp.ndarray, cost: jnp.ndarray, sigma,
                          ker_wt: float, block: int = 1024,
                          kind: str = "laplace") -> jnp.ndarray:
    """MMD-vs-zero for very large sample ensembles without materializing the
    (N, N) Gram matrix.

    The quadratic term beta^T K beta tiles over row blocks with on-chip
    accumulation — the same blockwise structure as flash/ring attention, which
    is this domain's honest "long-context analog" (SURVEY.md §5): the sample
    axis, not sequence, is what grows with the device count.  Peak memory
    O(block * N) instead of O(N^2).  Exact (no approximation).

    Accepts the same batched (..., N) beta/cost and scalar-or-batched sigma
    signatures as :func:`mmd_vs_zero`.  At large N this path is also the
    more accurate one under a reduced default matmul precision (TF32 on the
    GPU): its quadratic term is not one big contraction rounded at that
    precision (see ProblemConfig.matmul_precision).
    """
    if beta.shape != cost.shape:
        raise ValueError(f"beta {beta.shape} and cost {cost.shape} must "
                         "share a shape")
    if cost.ndim == 1 and jnp.ndim(sigma):
        # 1-D samples under a batch of bandwidths: mmd_vs_zero broadcasts
        # this to sigma's batch shape, so mirror it by lifting beta/cost to
        # the batch and taking the batched path below (the 1-D scan core
        # assumes a scalar sigma)
        batch = jnp.shape(jnp.asarray(sigma))
        beta = jnp.broadcast_to(beta, batch + beta.shape)
        cost = jnp.broadcast_to(cost, batch + cost.shape)
    if cost.ndim != 1:
        # batched (..., N): vmap the 1-D row-block core over the flattened
        # leading dims (sigma scalar or broadcastable to the batch shape),
        # matching mmd_vs_zero's accepted signatures
        batch = cost.shape[:-1]
        b2 = beta.reshape((-1, cost.shape[-1]))
        c2 = cost.reshape((-1, cost.shape[-1]))
        if jnp.ndim(sigma):
            s2 = jnp.broadcast_to(jnp.asarray(sigma), batch).reshape(-1)
            out = jax.vmap(lambda b, c, s: blockwise_mmd_vs_zero(
                b, c, s, ker_wt, block, kind))(b2, c2, s2)
        else:
            out = jax.vmap(lambda b, c: blockwise_mmd_vs_zero(
                b, c, sigma, ker_wt, block, kind))(b2, c2)
        return out.reshape(batch)
    n = cost.shape[-1]
    if n % block:
        pad = block - n % block
        # zero-weighted padding contributes nothing to either term
        beta = jnp.concatenate((beta, jnp.zeros(beta.shape[:-1] + (pad,))),
                               axis=-1)
        cost = jnp.concatenate((cost, jnp.zeros(cost.shape[:-1] + (pad,))),
                               axis=-1)
        n = n + pad
    nb = n // block
    beta_b = beta.reshape(nb, block)
    cost_b = cost.reshape(nb, block)

    def row_block(acc, i):
        ci = jax.lax.dynamic_index_in_dim(cost_b, i, keepdims=False)
        bi = jax.lax.dynamic_index_in_dim(beta_b, i, keepdims=False)
        d = jnp.abs(ci[:, None] - cost.reshape(-1)[None, :])
        K_rows = kernel_of(kind, sigma, d, d * d)
        return acc + bi @ (K_rows @ beta.reshape(-1)), None

    acc0 = jnp.zeros((), jnp.result_type(beta.dtype, cost.dtype))
    quad, _ = jax.lax.scan(row_block, acc0, jnp.arange(nb))
    d_ab = jnp.abs(cost)
    cross = jnp.sum(beta * kernel_of(kind, sigma, d_ab, d_ab * d_ab), axis=-1)
    return ker_wt * (quad - 2.0 * cross)


def mmd_vs_zero(beta: jnp.ndarray, cost: jnp.ndarray, sigma,
                ker_wt: float, kind: str = "laplace") -> jnp.ndarray:
    """MMD^2 cost of weighted samples ``cost`` against the all-zeros ideal set.

    mmd = ker_wt * (beta^T K_aa beta - 2 beta^T K_ab beta_uniform)
    with K_aa[i,j] = k(c_i, c_j) and — because the target set is identically
    zero — every column of K_ab equal to k(c_i, 0), so the cross term
    collapses to a dot product.  The target-target term is dropped exactly
    as in the reference (kernel_computation.py:82-84).  ``kind`` selects the
    kernel (RiskConfig.kernel): samples here are SCALAR violation values, so
    the L2^2 distance for the gaussian/matern52 variants is just the squared
    L1 distance.

    beta, cost: (..., k);  sigma scalar or (...,).  Returns (...).
    """
    d_aa = jnp.abs(cost[..., :, None] - cost[..., None, :])
    sig = jnp.asarray(sigma)[..., None, None] if jnp.ndim(sigma) else sigma
    K_aa = kernel_of(kind, sig, d_aa, d_aa * d_aa)
    quad = jnp.einsum("...i,...ij,...j->...", beta, K_aa, beta)
    sig1 = jnp.asarray(sigma)[..., None] if jnp.ndim(sigma) else sigma
    d_ab = jnp.abs(cost)
    cross = jnp.sum(beta * kernel_of(kind, sig1, d_ab, d_ab * d_ab), axis=-1)
    return ker_wt * (quad - 2.0 * cross)
