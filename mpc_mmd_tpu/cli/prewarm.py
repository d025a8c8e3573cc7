"""Prewarm the persistent XLA compilation cache for the promoted presets.

Cold start is the operational weak spot of a 0.15 s real-time engine: the
mmd_opt solve cold-compiles in about a minute on an H100.  This tool
compiles the production programs into the persistent cache
(``$JAX_COMPILATION_CACHE_DIR`` or ``<repo>/.jax_cache``) ahead of use, so
the first *serving* process on a machine pays seconds, not minutes:

    python -m mpc_mmd_tpu.cli.prewarm                 # bench/serving trio
    python -m mpc_mmd_tpu.cli.prewarm --presets fastrt --num_reduced 10 \
        --num_obs 6 --num_prime 50 --modes mmd_opt cvar

Each (preset, mode) pair is compiled by running ONE solve on the target
device (compile + a single execution; the execution is tens of ms next to
a minutes-scale compile and verifies the cached program end to end).
Prints one JSON line per program with the wall time, and a final summary
line; re-running on a warm cache shows hit-speed timings, which is the
check `bench.py`'s ``warmup_s`` field records for the official run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


PRESETS = ("fastrt", "default", "realtime", "fast")


def _make_cfg(preset: str, mode: str, num_reduced: int, num_obs: int,
              num_prime: int, noise: str, noise_level: float):
    from ..config import (fast_workload, fastrt_workload, realtime_workload,
                          static_workload)
    make = {"fastrt": fastrt_workload, "default": static_workload,
            "realtime": realtime_workload, "fast": fast_workload}[preset]
    return make(num_reduced=num_reduced, num_obs=num_obs,
                num_prime=num_prime, mode=mode, noise=noise,
                noise_level=noise_level)


def prewarm(presets, modes, num_reduced, num_obs, num_prime, noise,
            noise_level) -> float:
    import jax.numpy as jnp

    from ..dynamics import constant_velocity_obstacles
    from ..solver import Solver

    init_state = jnp.asarray([0.0, 1.75, 5.0, 0.0, 0.0, 0.0])
    mean = jnp.asarray([15.0] * 4 + [0.0] * 4)
    cov = jnp.asarray(np.diag([20.0] * 4 + [100.0] * 4), jnp.float32)
    total = 0.0
    for preset in presets:
        for mode in modes:
            cfg = _make_cfg(preset, mode, num_reduced, num_obs, num_prime,
                            noise, noise_level)
            solver = Solver(cfg)
            x0 = jnp.linspace(35.0, 75.0, num_obs)
            y0 = jnp.resize(jnp.asarray([-1.75, 1.75]), (num_obs,))
            z = jnp.zeros(num_obs)
            xt, yt, _ = constant_velocity_obstacles(x0, y0, z, z, z,
                                                    solver.ws.tot_time)
            t0 = time.perf_counter()
            out = solver.solve(0, init_state, mean, cov, xt, yt, 15.0)
            np.asarray(out.cx)          # value-fetch fence (CLAUDE.md)
            dt = time.perf_counter() - t0
            total += dt
            print(json.dumps({"preset": preset, "mode": mode,
                              "compile_or_hit_s": round(dt, 1)}))
            sys.stdout.flush()
    return total


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--presets", nargs="+", default=["fastrt", "default",
                                                    "realtime"],
                   choices=PRESETS)
    p.add_argument("--modes", nargs="+", default=["mmd_opt"])
    p.add_argument("--num_reduced", type=int, default=10)
    p.add_argument("--num_obs", type=int, default=6)
    p.add_argument("--num_prime", type=int, default=50)
    p.add_argument("--noise", default="gaussian")
    p.add_argument("--noise_level", type=float, default=0.1)
    args = p.parse_args(argv)

    from ..utils.compilation_cache import enable_persistent_cache
    cache_dir = enable_persistent_cache()
    print(f"prewarm: jax compilation cache -> {cache_dir or 'disabled'}",
          file=sys.stderr)
    total = prewarm(args.presets, args.modes, args.num_reduced, args.num_obs,
                    args.num_prime, args.noise, args.noise_level)
    print(json.dumps({"prewarmed": len(args.presets) * len(args.modes),
                      "total_s": round(total, 1)}))


if __name__ == "__main__":
    main()
