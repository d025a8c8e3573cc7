"""A/B of each GPU kernel against its plain-XLA form, inside the full solve.

For every variant of the kernel table (``mpc_mmd_tpu.ops.KERNELS["gpu"]``)
the production mmd_opt solve is compiled at the certified fastrt budget and at
the reference budget, and the variants are timed in interleaved rounds in one
process on one card (block_until_ready around each solve).  Before that, each
kernel is checked against its reference (chip_smoke.phase_kernels) and timed
alone at the production shape.

    python benchmarks/kernel_ab.py [--rounds 3] [--reps 5]

Prints one line per measurement with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (also keeps the CPU backend available)
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

XLA = {"qp": "xla", "rollout": "xla"}
VARIANTS = {
    "xla": XLA,
    "qp=triton": {**XLA, "qp": "triton"},
    "rollout=triton": {**XLA, "rollout": "triton"},
    "qp+rollout=triton": {"qp": "triton", "rollout": "triton"},
}


def median_call_ms(fn, args, n: int = 50) -> float:
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def micro(card: str) -> None:
    from mpc_mmd_tpu.dynamics import rollout_scan
    from mpc_mmd_tpu.linalg import eq_qp_solve
    from mpc_mmd_tpu.ops.qp_triton import eq_qp_solve_triton
    from mpc_mmd_tpu.ops.rollout_triton import rollout_triton

    rng = np.random.default_rng(1)
    for k in (10, 15):
        C, r = (jnp.asarray(a) for a in chip_smoke.qp_problems(rng, 10_000, k))
        for name, f in (("xla unrolled", jax.jit(eq_qp_solve)),
                        ("triton", jax.jit(eq_qp_solve_triton))):
            print(f"micro qp B=10^4 k={k} {name}: "
                  f"{median_call_ms(f, (C, r)):.4f} ms ({card})", flush=True)
    for per_lane in (False, True):
        a, s, s0 = (jnp.asarray(v) for v in chip_smoke.rollout_input(
            rng, 10_000, 50, per_lane))
        for name, f in (("scan", rollout_scan), ("triton", rollout_triton)):
            g = jax.jit(lambda a, s, s0, f=f: f(a, s, s0, 0.15, 2.5))
            print(f"micro rollout 10^4x50 per_lane={per_lane} {name}: "
                  f"{median_call_ms(g, (a, s, s0)):.4f} ms ({card})",
                  flush=True)


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args()

    chip_smoke.require_gpu(jax.devices())
    card = chip_smoke.card_identity()
    print(card, flush=True)
    from mpc_mmd_tpu import Solver, fastrt_workload, ops, static_workload

    chip_smoke.phase_kernels(jax.devices("cpu")[0])
    micro(card)

    variants = VARIANTS
    cfgs = {"fastrt": fastrt_workload(num_reduced=10, num_obs=6,
                                      num_prime=50),
            "default": static_workload(num_reduced=10, num_obs=6,
                                       num_prime=50)}
    lowered = {}
    for cname, cfg in cfgs.items():
        solver = Solver(cfg)
        init_state, mean, cov, v_des, xt, yt = chip_smoke.static_inputs(
            cfg, solver.ws, 8)
        make = (lambda i, xt=xt, yt=yt, a=(init_state, mean, cov, v_des):
                (i, a[0], a[1], a[2], xt[i % 8], yt[i % 8], a[3]))
        for vname, table in variants.items():
            ops.KERNELS["gpu"] = table
            t0 = time.perf_counter()
            lowered[(cname, vname)] = (Solver(cfg, ws=solver.ws)._solve.lower(
                *make(0)), make)
            print(f"lower {cname} {vname}: {time.perf_counter() - t0:.2f} s",
                  flush=True)
    keys = list(lowered)
    t0 = time.perf_counter()
    first = lowered[keys[0]][0].compile()
    print(f"cold compile {keys[0]} alone: {time.perf_counter() - t0:.2f} s "
          f"({card})", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=8) as ex:
        rest = list(ex.map(lambda k: lowered[k][0].compile(), keys[1:]))
    print(f"compile of the other {len(rest)} programs in 8 threads: "
          f"{time.perf_counter() - t0:.2f} s ({card})", flush=True)
    compiled = dict(zip(keys, [first] + rest))

    times = {k: [] for k in keys}
    for rnd in range(args.rounds):
        order = keys if rnd % 2 == 0 else keys[::-1]
        for k in order:
            make = lowered[k][1]
            times[k].append(chip_smoke.time_solves(compiled[k], make,
                                                   args.reps))
    for cname in cfgs:
        base = np.median(times[(cname, "xla")]) if (cname, "xla") in times \
            else None
        for vname in variants:
            ms = 1e3 * np.asarray(times[(cname, vname)])
            rel = (f", {np.median(ms) / (1e3 * base):.3f}x xla"
                   if base else "")
            print(f"e2e {cname} {vname}: median {np.median(ms):.3f} ms/solve "
                  f"(round medians {np.round(ms, 3).tolist()}){rel} ({card})",
                  flush=True)


if __name__ == "__main__":
    main()
