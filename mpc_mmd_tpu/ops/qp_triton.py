"""Pallas kernel (Triton route): batched tiny equality-constrained QP, one
problem per thread.

Solves  min_b 1/2 b^T C b - r^T b  s.t.  sum(b) = 1  for B independent SPD
(n x n) systems (n = num_reduced, B = candidates x CEM samples, about 10^4 per
inner-CEM iteration), by the same block elimination as
:func:`mpc_mmd_tpu.linalg.eq_qp_solve`:  z = C^-1 r,  w = C^-1 1,
mu = (1.z - 1) / 1.w,  b = z - mu w.

Each thread owns one problem: it reads the lower triangle of its C (55 floats
for n = 10) into registers, factors it by an unrolled Cholesky, runs the two
substitution pairs and writes b and mu once.  XLA's lowering of the unrolled
jnp chain instead materialises the (B, n, n) factor between its fusions.

Measured on an NVIDIA H100 80GB HBM3 at a 400 W power limit
(benchmarks/kernel_ab.py): alone at B = 10^4, k = 10, 0.19 ms vs 0.37 ms
for the XLA chain; inside the production mmd_opt solve with everything else
plain XLA, 22.3 vs 30.6 ms per solve at the fastrt budget and 111.4 vs
131.7 ms at the reference budget.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_BATCH_BLOCK = 64
_NUM_WARPS = 2       # one problem per thread


def _qp_kernel(c_ref, r_ref, b_ref, mu_ref, *, B: int, n: int):
    start = pl.program_id(0) * _BATCH_BLOCK
    rows = pl.ds(start, _BATCH_BLOCK)
    mask = start + jnp.arange(_BATCH_BLOCK) < B

    def load_c(i, j):
        # masked-out problems read the identity, so they stay SPD
        return plgpu.load(c_ref.at[rows, i, j], mask=mask,
                          other=1.0 if i == j else 0.0)

    L = [[None] * n for _ in range(n)]
    inv_diag = [None] * n
    for j in range(n):
        s = load_c(j, j)
        for p in range(j):
            s = s - L[j][p] * L[j][p]
        inv_d = jax.lax.rsqrt(s)
        inv_diag[j] = inv_d
        for i in range(j + 1, n):
            t = load_c(i, j)
            for p in range(j):
                t = t - L[i][p] * L[j][p]
            L[i][j] = t * inv_d

    def fwd(vec):
        y = []
        for i in range(n):
            s = vec[i]
            for p in range(i):
                s = s - L[i][p] * y[p]
            y.append(s * inv_diag[i])
        return y

    def bwd(y):
        x = [None] * n
        for i in range(n - 1, -1, -1):
            s = y[i]
            for p in range(i + 1, n):
                s = s - L[p][i] * x[p]
            x[i] = s * inv_diag[i]
        return x

    r = [plgpu.load(r_ref.at[rows, i], mask=mask, other=0.0) for i in range(n)]
    z = bwd(fwd(r))
    w = bwd(fwd([jnp.ones_like(r[0])] * n))
    sum_z, sum_w = z[0], w[0]
    for i in range(1, n):
        sum_z = sum_z + z[i]
        sum_w = sum_w + w[i]
    mu = (sum_z - 1.0) / sum_w
    for i in range(n):
        plgpu.store(b_ref.at[rows, i], z[i] - mu * w[i], mask=mask)
    plgpu.store(mu_ref.at[rows], mu, mask=mask)


@functools.partial(jax.jit, static_argnames=("interpret",))
def eq_qp_solve_triton(C: jnp.ndarray, r: jnp.ndarray,
                       interpret: bool = False):
    """Same contract as :func:`mpc_mmd_tpu.linalg.eq_qp_solve` (C SPD).

    C: (..., n, n); r: (..., n).  Returns (b (..., n), mu (...)).
    """
    batch_shape = C.shape[:-2]
    n = C.shape[-1]
    B = 1
    for d in batch_shape:
        B *= d
    b, mu = pl.pallas_call(
        functools.partial(_qp_kernel, B=B, n=n),
        grid=(pl.cdiv(B, _BATCH_BLOCK),),
        out_shape=[jax.ShapeDtypeStruct((B, n), C.dtype),
                   jax.ShapeDtypeStruct((B,), C.dtype)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="eq_qp_triton",
    )(C.reshape(B, n, n), r.reshape(B, n))
    return b.reshape(batch_shape + (n,)), mu.reshape(batch_shape)
