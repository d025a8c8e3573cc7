"""Hot-path ops and the one table that picks their implementation.

Each op has a plain XLA form (the reference, and the CPU test path) and may
have a Pallas kernel for the GPU.  :data:`KERNELS` maps a platform to the
implementation each op takes there, and :func:`dispatch` applies it for the
platform a program is lowered for.  A backend missing from the table is an
error, never a silent fallback.

The GPU entries are the winners of an end-to-end A/B inside the production
mmd_opt solve (benchmarks/kernel_ab.py, interleaved rounds in one process;
NVIDIA H100 80GB HBM3 at a 400 W power limit; median ms per solve at the
fastrt / reference budget):

* all plain XLA: 30.6 / 131.7
* QP kernel only (ops/qp_triton.py): 22.3 / 111.4
* rollout kernel only (ops/rollout_triton.py): 25.7 / 131.9
* both kernels (the table below): 17.6 / 101.6

The rollout kernel alone is a tie at the reference budget but takes
9.8 ms off the QP-kernel solve there, so both stay.  A Triton row kernel
for top-k lost to XLA's own ``lax.top_k`` (32.7 vs 30.8 ms at fastrt,
135.9 vs 132.9 ms at the reference budget, an earlier run on the same card
type), so :func:`topk` is plain XLA everywhere.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

KERNELS = {
    "gpu": {"qp": "triton", "rollout": "triton"},
    "cpu": {"qp": "xla", "rollout": "xla"},
}
# the platform names jax.lax.platform_dependent lowers for
_LOWERING_PLATFORM = {"gpu": "cuda", "cpu": "cpu"}


def kernel_for(op: str) -> str:
    """Implementation of ``op`` on JAX's default backend."""
    platform = jax.default_backend()
    if platform not in KERNELS:
        raise ValueError(f"no kernel table for platform {platform!r} "
                         f"(supported: {sorted(KERNELS)})")
    return KERNELS[platform][op]


def dispatch(op: str, impls: dict, *args):
    """Call ``impls[KERNELS[platform][op]](*args)`` for the platform the
    program is lowered for, so one traced function compiles to the Triton
    kernel on the GPU and to the plain form on the CPU (e.g. a CPU
    reference run inside a GPU process).  Raises on a backend missing from
    the table."""
    kernel_for(op)
    return jax.lax.platform_dependent(*args, **{
        _LOWERING_PLATFORM[p]: impls[table[op]]
        for p, table in KERNELS.items()})


def topk(x: jnp.ndarray, k: int, absolute: bool = False,
         slice_to: int | None = None) -> jnp.ndarray:
    """Top-k indices along the last axis (descending; ties -> first index;
    NaN ranks last), over the first ``slice_to`` lanes of |x| or x."""
    y = x if slice_to is None else x[..., :slice_to]
    if absolute:
        y = jnp.abs(y)
    return jax.lax.top_k(jnp.where(jnp.isnan(y), -jnp.inf, y), k)[1]


def eq_qp_solve(C: jnp.ndarray, r: jnp.ndarray):
    """Batched equality-constrained QP (see :func:`linalg.eq_qp_solve`)."""
    from ..linalg import eq_qp_solve as eq_qp_solve_xla
    from .qp_triton import eq_qp_solve_triton
    return dispatch("qp", {"xla": eq_qp_solve_xla,
                           "triton": eq_qp_solve_triton}, C, r)
