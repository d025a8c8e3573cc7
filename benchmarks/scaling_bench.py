"""Scaling-efficiency benchmark: scenario-sharded sweep over an n-device mesh.

Weak scaling: each device solves a fixed number of scenarios
(``--per-device``), the mesh grows 1 -> N devices, and efficiency is
T(1) / T(N) (ideal 1.0 — per-device time constant while total throughput
grows N-fold).  This is the BASELINE.md "scaling efficiency at 1 chip /
1 host / N hosts" measurement; the reference has no multi-device support at
all (SURVEY.md §2.4), so there is no reference number to compare.

On a multi-GPU host run as-is (devices = real cards; multi-host via
``initialize_distributed`` first).  On a development machine run with
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8
which exercises the identical shard_map path, but NOTE: virtual CPU devices
share physical cores, so CPU "efficiency" measures sharding overhead only,
not genuine parallel speedup.

Output: one JSON line per mesh size to stdout.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-device", type=int, default=2,
                    help="scenarios per device (weak scaling)")
    ap.add_argument("--num-reduced", type=int, default=4)
    ap.add_argument("--num-prime", type=int, default=20)
    ap.add_argument("--mode", default="mmd_opt")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--mesh-sizes", type=int, nargs="*", default=None,
                    help="default: 1, 2, 4, ... up to device_count")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mpc_mmd_tpu import static_workload
    from mpc_mmd_tpu.dynamics import constant_velocity_obstacles
    from mpc_mmd_tpu.parallel.mesh import (SCENARIO_AXIS, make_mesh,
                                           sharded_sweep)
    from mpc_mmd_tpu.qp import build_workspace

    n_avail = len(jax.devices())
    sizes = args.mesh_sizes
    if not sizes:
        sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_avail]

    cfg = static_workload(num_reduced=args.num_reduced, num_obs=2,
                          num_prime=args.num_prime, mode=args.mode)
    ws = build_workspace(cfg)
    num_obs = cfg.obstacles.num_obs

    init_state = jnp.asarray([0.0, 1.75, 5.0, 0.0, 0.0, 0.0])
    mean = jnp.asarray([15.0] * 4 + [0.0] * 4)
    cov = jnp.asarray(np.diag([20.0] * 4 + [100.0] * 4), jnp.float32)
    rng = np.random.default_rng(0)

    t1 = None
    for n in sizes:
        S = n * args.per_device
        mesh = make_mesh(n)
        sweep = sharded_sweep(cfg, ws, mesh)

        grid = np.array([35, 45, 55, 65, 75], dtype=np.float64)
        x0 = jnp.asarray(np.stack([rng.choice(grid, num_obs, replace=False)
                                   for _ in range(S)]))
        y0 = jnp.asarray(rng.choice(np.array([-1.75, 1.75]), (S, num_obs)))
        zeros = jnp.zeros((S, num_obs))
        xt, yt, _ = jax.vmap(
            lambda a, b, c, d, e: constant_velocity_obstacles(
                a, b, c, d, e, ws.tot_time))(x0, y0, zeros, zeros, zeros)

        sh = NamedSharding(mesh, P(SCENARIO_AXIS))
        seeds = jax.device_put(jnp.arange(S, dtype=jnp.int32), sh)
        xt = jax.device_put(xt, sh)
        yt = jax.device_put(yt, sh)

        out = sweep(seeds, init_state, mean, cov, xt, yt, 15.0)
        out.cx.block_until_ready()          # compile + warm
        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = sweep(seeds, init_state, mean, cov, xt, yt, 15.0)
        out.cx.block_until_ready()
        dt = (time.perf_counter() - t0) / args.reps

        if t1 is None:
            t1 = dt
        print(json.dumps({
            "devices": n, "scenarios": S, "time_s": round(dt, 4),
            "solves_per_s": round(S / dt, 3),
            "weak_scaling_efficiency": round(t1 / dt, 3),
        }), flush=True)


if __name__ == "__main__":
    main()
