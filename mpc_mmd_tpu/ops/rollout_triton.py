"""Pallas kernel (Triton route): bicycle-kinematics rollout, one lane per thread.

XLA:GPU runs the rollout ``lax.scan`` (:func:`mpc_mmd_tpu.dynamics.rollout_scan`)
as a while loop that launches the step body once per time step: T = 50
launches per rollout, for every outer-CEM iteration and for the MC validator.
Here the whole time loop runs inside one launch.  Each program owns a block of
lanes; each thread carries its lane's 5-state [x, y, vx, vy, psi] in registers
across all T steps, reads that step's controls and writes that step's x, y.
Lanes are independent, so no state crosses a block.

Layout: controls and positions are time-major (T, L) inside the kernel, so each
step's loads and stores are contiguous across the lanes of a warp.

Measured on an NVIDIA H100 80GB HBM3 at a 400 W power limit
(benchmarks/kernel_ab.py): alone at 10^4 lanes x T = 50, 0.20 ms vs 0.81 ms
for the scan.  Inside the production mmd_opt solve with the QP kernel on,
17.6 vs 22.3 ms per solve at the fastrt budget and 101.6 vs 111.4 ms at the
reference budget; with everything else plain XLA, 25.7 vs 30.6 ms at fastrt
and a tie (131.9 vs 131.7 ms) at the reference budget.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..dynamics import bicycle_step

_LANE_BLOCK = 64     # lanes per program: 10^4 lanes -> 157 programs on 132 SMs
_NUM_WARPS = 2       # one lane per thread


def _rollout_kernel(acc_ref, steer_ref, s0_ref, x_ref, y_ref, *, L: int,
                    T: int, dt: float, wheel_base: float, shared: bool):
    start = pl.program_id(0) * _LANE_BLOCK
    lanes = pl.ds(start, _LANE_BLOCK)
    mask = start + jnp.arange(_LANE_BLOCK) < L
    if shared:
        zero = jnp.zeros((_LANE_BLOCK,), s0_ref.dtype)
        state = tuple(zero + plgpu.load(s0_ref.at[i]) for i in range(5))
    else:
        state = tuple(plgpu.load(s0_ref.at[i, lanes], mask=mask, other=0.0)
                      for i in range(5))

    def body(t, carry):
        x, y, vx, vy, psi = carry
        plgpu.store(x_ref.at[t, lanes], x, mask=mask)
        plgpu.store(y_ref.at[t, lanes], y, mask=mask)
        a_t = plgpu.load(acc_ref.at[t, lanes], mask=mask, other=0.0)
        s_t = plgpu.load(steer_ref.at[t, lanes], mask=mask, other=0.0)
        return bicycle_step(x, y, vx, vy, psi, a_t, s_t, dt, wheel_base)

    jax.lax.fori_loop(jnp.int32(0), jnp.int32(T), body, state)


@functools.partial(jax.jit, static_argnames=("dt", "wheel_base", "interpret"))
def rollout_triton(acc: jnp.ndarray, steer: jnp.ndarray, state0: jnp.ndarray,
                   dt: float, wheel_base: float,
                   interpret: bool = False) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Same contract as :func:`mpc_mmd_tpu.dynamics.rollout_scan`.

    acc, steer: (L, T) noisy control sequences; state0: (L, 5) or (5,).
    Returns x, y position stacks (L, T); row t is recorded before applying
    controls[t] (cem_helper.py:451-461).
    """
    L, T = acc.shape
    shared = state0.ndim == 1
    s0 = state0 if shared else state0.T                  # (5,) or (5, L)
    kernel = functools.partial(_rollout_kernel, L=L, T=T, dt=dt,
                               wheel_base=wheel_base, shared=shared)
    x_t, y_t = pl.pallas_call(
        kernel,
        grid=(pl.cdiv(L, _LANE_BLOCK),),
        out_shape=[jax.ShapeDtypeStruct((T, L), acc.dtype),
                   jax.ShapeDtypeStruct((T, L), acc.dtype)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="rollout_triton",
    )(acc.T, steer.T, s0)
    return x_t.T, y_t.T
