"""Headline benchmark: risk-aware MPC solves/s on one GPU.

Problem shape pinned to BASELINE.json: mmd_opt cost, num_prime=50,
6 obstacles, num_reduced=10 (mother set = 100 rollouts), gaussian noise
0.1 — the reference's heaviest workload shape.

The headline runs the CERTIFIED COMBINED BUDGET (config.fastrt_workload:
outer CEM num_batch=64 x maxiter_cem=10 + inner beta-CEM S=64 x 12, vs
the reference's 100x20 outer and 100x20 inner).  The paired MC
certification (artifacts/fast/pooled_r5.json) measured this budget
significantly SAFER than the reference's default budget, so the headline is
a like-for-like capability comparison.  The reference-budget rate is
measured too and lands in the combined record.

Prints the device it runs on (platform, device_kind, device count, and the
card's name and power limit from nvidia-smi) and exits non-zero when the
first JAX device is not a GPU.  Every time is fenced with
``block_until_ready``.  Stdout gets the headline JSON line
    {"metric": ..., "value": N, "unit": "solves/s", "vs_baseline": N, ...}
and, unless BENCH_EXTRAS=0, one combined JSON line (headline fields +
latency and batched records) as the LAST line.  A failing extra fails the
run.  vs_baseline is the SAME-BUDGET speedup over the reference
implementation's solves/s on CPU with its budget attributes set to the
certified combined budget (benchmarks/reference_cpu_fastrt_budget.json; the
reference publishes no numbers and supports no accelerator, SURVEY.md §6).
"""

import json
import os
import sys
import time

import numpy as np


def _build(cfg):
    import jax
    import jax.numpy as jnp

    from mpc_mmd_tpu import Solver
    from mpc_mmd_tpu.dynamics import constant_velocity_obstacles

    solver = Solver(cfg)
    num_obs = cfg.obstacles.num_obs
    rng = np.random.default_rng(0)
    grid = np.array([35, 40, 45, 50, 55, 60, 65, 70, 75], dtype=np.float64)

    def scenarios(S):
        x0 = np.stack([rng.choice(grid, num_obs, replace=False)
                       for _ in range(S)])
        y0 = rng.choice(np.array([-1.75, 1.75]), (S, num_obs))
        zeros = jnp.zeros((S, num_obs))
        xt, yt, _ = jax.vmap(
            lambda a, b, c, d, e: constant_velocity_obstacles(
                a, b, c, d, e, solver.ws.tot_time)
        )(jnp.asarray(x0), jnp.asarray(y0), zeros, zeros, zeros)
        return xt, yt

    init_state = jnp.asarray([0.0, 1.75, 5.0, 0.0, 0.0, 0.0])
    mean = jnp.asarray([15.0] * 4 + [0.0] * 4)
    cov = jnp.asarray(np.diag([20.0] * 4 + [100.0] * 4), jnp.float32)
    return solver, scenarios, (init_state, mean, cov)


def _latency(solver, solve_args, seed0: int, reps: int) -> dict:
    """Blocking per-solve latencies, and the pipelined per-solve time of
    ``reps`` solves dispatched back to back with one final fence."""
    import jax

    init_state, mean, cov, xt, yt = solve_args
    lat = []
    for k in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(
            solver.solve(seed0 + k, init_state, mean, cov, xt, yt, 15.0))
        lat.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    for k in range(reps):
        r = solver.solve(seed0 + reps + k, init_state, mean, cov, xt, yt,
                         15.0)
    jax.block_until_ready(r)
    pipelined_ms = 1e3 * (time.perf_counter() - t0) / reps
    return {"p50_ms": round(1e3 * float(np.percentile(lat, 50)), 3),
            "p99_ms": round(1e3 * float(np.percentile(lat, 99)), 3),
            "pipelined_ms": round(pipelined_ms, 3), "reps": reps}


def _rate(solve, n: int) -> float:
    """Solves/s of ``n`` back-to-back calls of ``solve(i)``, one fence."""
    import jax

    t0 = time.perf_counter()
    for i in range(n):
        out = solve(i)
    jax.block_until_ready(out)
    return n / (time.perf_counter() - t0)


def main():
    import jax

    from mpc_mmd_tpu.utils.compilation_cache import enable_persistent_cache
    from mpc_mmd_tpu.utils.device import card_identity, require_gpu

    devices = jax.devices()
    require_gpu(devices)
    device = {"platform": devices[0].platform,
              "kind": devices[0].device_kind, "count": len(devices),
              "card": card_identity()}
    print(f"bench: device {device}", file=sys.stderr)
    print(f"bench: jax compilation cache -> {enable_persistent_cache()}",
          file=sys.stderr)

    import jax.numpy as jnp

    from mpc_mmd_tpu import fastrt_workload, realtime_workload, static_workload
    from mpc_mmd_tpu.config import (FASTRT_OUTER_BUDGET,
                                    REALTIME_INNER_BUDGET)

    shape = dict(num_reduced=10, num_obs=6, num_prime=50, mode="mmd_opt",
                 noise="gaussian", noise_level=0.1)
    cfg = fastrt_workload(**shape)
    solver, scenarios, (init_state, mean, cov) = _build(cfg)
    reps = int(os.environ.get("BENCH_REPS", "5"))

    # ---- headline: single-stream solves/s, ONE compiled program ----------
    xt1, yt1 = scenarios(1)

    def solve_fast(i, s=solver):
        return s.solve(i + 1, init_state, mean, cov, xt1[0], yt1[0], 15.0)

    t0 = time.perf_counter()
    jax.block_until_ready(solve_fast(-1))
    warmup_s = time.perf_counter() - t0
    print(f"bench: warmup (compile or cache hit) {warmup_s:.1f}s",
          file=sys.stderr)
    solves_per_s = _rate(solve_fast, reps * 2)

    bench_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "benchmarks")

    def _ref_rate(name):
        with open(os.path.join(bench_dir, name)) as f:
            return json.load(f)["solves_per_s"]

    ref_fastrt = _ref_rate("reference_cpu_fastrt_budget.json")
    ref_default = _ref_rate("reference_cpu_baseline.json")

    headline = {
        "metric": "mmd_opt MPC solves/s (num_prime=50, 6 obs, reduced set"
                  " 10/100, certified combined budget B64x10+S64x12;"
                  " vs_baseline is SAME-budget: reference CPU at"
                  " B64x10+S64x12)",
        "value": round(solves_per_s, 3),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_s / ref_fastrt, 3),
        "warmup_s": round(warmup_s, 1),
        "device": device,
    }
    print(json.dumps(headline))
    sys.stdout.flush()

    if os.environ.get("BENCH_EXTRAS", "1") == "0":
        return

    # ---- extras: latency per preset + batched throughput ----------------
    combined = dict(headline)
    lat_reps = int(os.environ.get("BENCH_LAT_REPS", "30"))
    solve_args = (init_state, mean, cov, xt1[0], yt1[0])
    f = _latency(solver, solve_args, 100, lat_reps)
    print(f"bench: headline(fastrt)-preset latency {f}", file=sys.stderr)
    combined.update({
        "fast_budget": "B%dx%d+S%dx%d" % (FASTRT_OUTER_BUDGET
                                          + REALTIME_INNER_BUDGET),
        "fast_p50_ms": f["p50_ms"], "fast_p99_ms": f["p99_ms"],
        "fast_pipelined_ms": f["pipelined_ms"], "lat_reps": f["reps"]})

    # reference budget (num_batch=100 x maxiter_cem=20, inner 100x20)
    solver_def, _, _ = _build(static_workload(**shape))

    def solve_def(i):
        return solver_def.solve(i + 1, init_state, mean, cov, xt1[0],
                                yt1[0], 15.0)

    jax.block_until_ready(solve_def(-1))
    default_rate = _rate(solve_def, reps * 2)
    d = _latency(solver_def, solve_args, 100, lat_reps)
    print(f"bench: default-preset latency {d}", file=sys.stderr)
    combined.update({
        "default_budget_solves_per_s": round(default_rate, 3),
        "vs_baseline_default_budget": round(default_rate / ref_default, 3),
        "p50_solve_ms": d["p50_ms"], "p99_solve_ms": d["p99_ms"],
        "pipelined_ms_per_solve": d["pipelined_ms"]})

    # real-time operating point (reduced inner budget; artifacts/realtime/);
    # the budget is 0.15 s per MPC step (carla_simulation.py:25)
    solver_rt, _, _ = _build(realtime_workload(**shape))
    jax.block_until_ready(solver_rt.solve(0, *solve_args, 15.0))
    rt = _latency(solver_rt, solve_args, 300, lat_reps)
    print(f"bench: realtime-preset latency {rt}", file=sys.stderr)
    combined.update({
        "realtime_budget": "S%dx%d" % REALTIME_INNER_BUDGET,
        "realtime_p50_ms": rt["p50_ms"], "realtime_p99_ms": rt["p99_ms"],
        "realtime_pipelined_ms": rt["pipelined_ms"],
        "realtime_in_budget": bool(rt["p99_ms"] <= 150.0)})

    # batched throughput: S scenarios per program, chunk of them concurrent
    from mpc_mmd_tpu.solver import Solver
    S_b = int(os.environ.get("BENCH_BATCHED_S", "8"))
    solver_b = Solver(cfg, ws=solver.ws, scenario_chunk=int(
        os.environ.get("BENCH_BATCHED_CHUNK", "4")))
    xtb, ytb = scenarios(S_b)
    seeds_b = jnp.arange(S_b, dtype=jnp.int32)

    def solve_b(i):
        return solver_b.solve_batch(seeds_b + i * S_b, init_state, mean, cov,
                                    xtb, ytb, 15.0)

    jax.block_until_ready(solve_b(0))
    combined["batched_solves_per_s"] = round(S_b * _rate(solve_b, reps), 3)
    combined["batched_config"] = "chunk%d_S%d" % (solver_b.scenario_chunk,
                                                  S_b)
    print(f"bench: batched ({combined['batched_config']}) "
          f"{combined['batched_solves_per_s']} solves/s", file=sys.stderr)

    # ---- final combined record: the LAST JSON line of the run -----------
    print(json.dumps(combined))


if __name__ == "__main__":
    main()
