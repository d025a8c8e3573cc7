#!/usr/bin/env python3
"""GPU smoke run: drive the engine's main path once, end to end, on one card.

Usage (from the repository root):

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --multichip   # four GPUs: the sharded paths only

Phases, in one JAX process and in this order (a failing phase exits
non-zero; nothing is caught and skipped):

  device    the first JAX device must be a GPU; prints its kind, the device
            count and the card's name and power limit (nvidia-smi).
  kernels   each hot-path op as ops.KERNELS dispatches it on the GPU (top-k,
            beta QP, rollout) against its plain reference at production width.
  stages    each stage of one outer-CEM iteration on the GPU against the same
            stage on the CPU backend of this process, on identical inputs
            (the CPU is the reference here, never a fallback), at matmul
            precision "highest" (bounded) and "default" (TF32 on the GPU;
            reported).
  solve     Solver.solve per risk mode at the reference shape, the certified
            fastrt budget, the dynamic cut-in workload, the on-road Frenet
            solver, and Solver.solve_batch over 8 scenarios: compile time,
            median solve time, memory; outputs finite, risk_obs <= 0 for
            mmd_opt.
  pipeline  the users' entry points in-process: cli.sweep -> cli.validate
            (1000 MC rollouts) on the stores it wrote, then a short
            closed-loop episode on the on-road workload.

``--multichip`` runs only the scenario-sharded sweep, the psum'd sweep
statistics, the sharded MC validator and the candidate-mesh solve over all
devices, each against its single-device result.

Times are smoke readings on the card named beside them, not benchmark
metrics.  The last stdout line is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

# The stages phase compares against JAX's CPU backend in this same process:
# keep it available when JAX_PLATFORMS names the GPU alone.
_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mpc_mmd_tpu.utils.device import card_identity, require_gpu  # noqa: E402

OUT_DIR = os.path.join("chiprun_out", "chip_smoke")
CARD = "card not queried"          # "name, power limit" from nvidia-smi


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# kernels: plain references and comparisons (small widths run in the tests)
# ---------------------------------------------------------------------------

def topk_input(rng, shape, nan_frac: float = 0.01) -> np.ndarray:
    """Rows with many exact ties (values on a 0.25 grid) and a few NaN
    lanes; every row keeps far more than k finite lanes."""
    x = np.round(rng.normal(0.0, 2.0, shape) * 4.0) / 4.0
    x[rng.random(shape) < nan_frac] = np.nan
    return x.astype(np.float32)


def topk_mismatches(topk_fn, x: np.ndarray, k: int, absolute: bool,
                    slice_to, cpu) -> int:
    """Index mismatches of ``topk_fn`` against ``lax.top_k`` run on the CPU
    backend, with the NaN-last rule applied to the reference's input."""
    got = np.asarray(topk_fn(jnp.asarray(x), k, absolute=absolute,
                             slice_to=slice_to))
    y = x if slice_to is None else x[..., :slice_to]
    y = np.abs(y) if absolute else y
    y = np.where(np.isnan(y), -np.inf, y).astype(np.float32)
    with jax.default_device(cpu):
        ref = np.asarray(jax.lax.top_k(jnp.asarray(y), k)[1])
    return int(np.sum(got != ref))


def qp_problems(rng, B: int, k: int, reg: float = 0.05):
    """Reduced-set QPs as the inner CEM builds them: a Laplace Gram of k
    random rollouts' features plus the qp_reg ridge, and r = row sums / M."""
    feats = rng.normal(0.0, 1.0, (B, k, 22))
    sigma = rng.uniform(0.5, 20.0, (B, 1, 1))
    d = np.abs(feats[:, :, None, :] - feats[:, None, :, :]).sum(-1)
    C = np.exp(-d / sigma) + reg * np.eye(k)
    r = rng.uniform(0.0, 1.0, (B, k))
    return C.astype(np.float32), r.astype(np.float32)


def qp_oracle(C: np.ndarray, r: np.ndarray):
    """float64 dense KKT solve [[C, 1], [1^T, 0]] [b; mu] = [r; 1]."""
    B, k, _ = C.shape
    kkt = np.zeros((B, k + 1, k + 1))
    kkt[:, :k, :k] = C
    kkt[:, :k, k] = 1.0
    kkt[:, k, :k] = 1.0
    rhs = np.concatenate((r, np.ones((B, 1))), axis=1).astype(np.float64)
    sol = np.linalg.solve(kkt, rhs[..., None])[..., 0]
    return sol[:, :k], sol[:, k]


def qp_errors(qp_fn, C: np.ndarray, r: np.ndarray, rtol: float = 1e-4,
              atol: float = 1e-5) -> dict:
    """Worst |got - ref| / (atol + rtol |ref|) over beta and mu (pass <= 1),
    and the worst |sum(beta) - 1|."""
    b, mu = qp_fn(jnp.asarray(C), jnp.asarray(r))
    b, mu = np.asarray(b, np.float64), np.asarray(mu, np.float64)
    b_ref, mu_ref = qp_oracle(C, r)
    ratio = max(np.max(np.abs(b - b_ref) / (atol + rtol * np.abs(b_ref))),
                np.max(np.abs(mu - mu_ref) / (atol + rtol * np.abs(mu_ref))))
    return {"ratio": float(ratio),
            "sum_err": float(np.max(np.abs(b.sum(-1) - 1.0)))}


def rollout_input(rng, L: int, T: int, per_lane: bool):
    acc = rng.normal(0.0, 1.0, (L, T)).astype(np.float32)
    steer = rng.normal(0.0, 0.05, (L, T)).astype(np.float32)
    if not per_lane:
        return acc, steer, np.asarray([0.0, 1.75, 5.0, 0.0, 0.0], np.float32)
    v = rng.uniform(3.0, 10.0, L)
    psi = rng.normal(0.0, 0.1, L)
    state0 = np.stack([rng.uniform(0.0, 10.0, L), rng.uniform(-2.0, 2.0, L),
                       v * np.cos(psi), v * np.sin(psi), psi], axis=1)
    return acc, steer, state0.astype(np.float32)


def rollout_oracle(acc, steer, state0, dt: float, wheel_base: float):
    """float64 numpy bicycle rollout (cem_helper.py:380-400,451-461)."""
    L, T = acc.shape
    s = np.broadcast_to(np.asarray(state0, np.float64), (L, 5)).copy()
    xs, ys = np.zeros((L, T)), np.zeros((L, T))
    for t in range(T):
        xs[:, t], ys[:, t] = s[:, 0], s[:, 1]
        v = np.sqrt(s[:, 2] ** 2 + s[:, 3] ** 2) + acc[:, t] * dt
        psi = s[:, 4] + v * np.tan(steer[:, t]) / wheel_base * dt
        vx, vy = v * np.cos(psi), v * np.sin(psi)
        s = np.stack([s[:, 0] + vx * dt, s[:, 1] + vy * dt, vx, vy, psi], 1)
    return xs, ys


def rollout_error(rollout_fn, acc, steer, state0, dt: float = 0.15,
                  wheel_base: float = 2.5) -> float:
    """Worst absolute position error (m) against the float64 oracle."""
    x, y = rollout_fn(jnp.asarray(acc), jnp.asarray(steer),
                      jnp.asarray(state0), dt, wheel_base)
    xr, yr = rollout_oracle(acc, steer, state0, dt, wheel_base)
    return float(max(np.max(np.abs(np.asarray(x) - xr)),
                     np.max(np.abs(np.asarray(y) - yr))))


def phase_kernels(cpu) -> None:
    from mpc_mmd_tpu import ops
    from mpc_mmd_tpu.dynamics import rollout

    log("kernels", f"dispatch on the GPU: {ops.KERNELS['gpu']}")
    rng = np.random.default_rng(0)
    cases = [("selection top-k |beta| (100, 90, 101)->10", (100, 90, 101),
              10, True, 100),
             ("elite top-k -cost (100, 100)->11", (100, 100), 11, False,
              None)]
    for name, shape, k, absolute, slice_to in cases:
        x = topk_input(rng, shape)
        if not absolute:          # elite pick: -cost with NaN costs -> +inf
            x = np.where(np.isnan(x), -np.inf, x)
        bad = topk_mismatches(ops.topk, x, k, absolute, slice_to, cpu)
        log("kernels", f"{name}: {bad} index mismatches vs lax.top_k on the "
            "CPU backend (limit 0, exact; f32)")
        assert bad == 0, name
    for k in (10, 15):
        C, r = qp_problems(rng, 10_000, k)
        e = qp_errors(ops.eq_qp_solve, C, r)
        log("kernels", f"beta QP B=10^4 k={k}: max err/(1e-5 + 1e-4|ref|) = "
            f"{e['ratio']:.3g} (limit 1, f32 vs float64 KKT), "
            f"|sum(beta)-1| = {e['sum_err']:.3g} (limit 1e-4)")
        assert e["ratio"] <= 1.0 and e["sum_err"] <= 1e-4, k
    for per_lane in (False, True):
        acc, steer, s0 = rollout_input(rng, 10_000, 50, per_lane)
        err = rollout_error(rollout, acc, steer, s0)
        form = "per-lane" if per_lane else "shared"
        log("kernels", f"rollout 10^4 x T=50, {form} state0: max |pos err| "
            f"= {err:.3g} m (limit 1e-4 m, f32 vs float64 oracle)")
        assert err <= 1e-4, form


# ---------------------------------------------------------------------------
# stages: one outer-CEM iteration, GPU vs the CPU backend
# ---------------------------------------------------------------------------

def static_inputs(cfg, ws, n: int, seed0: int = 0):
    """(init_state, mean, cov, v_des, x_traj, y_traj) for n static configs."""
    from mpc_mmd_tpu.scenarios import ego_initial_state, static_grid
    batch = static_grid(cfg, n, seed0=seed0)
    init_state, mean, cov, v_des = ego_initial_state("static")
    return init_state, mean, cov, v_des, batch.x_traj, batch.y_traj


def stage_functions(cfg, ws):
    """The stages of one outer-CEM iteration, in order, as
    [(name, fn, input names, output names)]; the inner CEM runs one
    iteration."""
    import dataclasses

    from mpc_mmd_tpu.dynamics import controls_from_trajectory
    from mpc_mmd_tpu.projection import project
    from mpc_mmd_tpu.qp import (boundary_vectors, compute_guess,
                                refit_coefficients)
    from mpc_mmd_tpu.reduced_set import select_reduced_set_batched
    from mpc_mmd_tpu.sampling import initial_params
    from mpc_mmd_tpu.solver import batched_rollouts

    cfg1 = cfg.replace(beta_cem=dataclasses.replace(cfg.beta_cem, maxiter=1))
    nb, M, T = cfg.cem.num_batch, cfg.risk.num_mother, cfg.horizon.num_prime

    def guess(init_state, mean, cov):
        b_eq_x, b_eq_y = boundary_vectors(cfg, init_state)
        return compute_guess(cfg, ws, initial_params(cfg, mean, cov),
                             b_eq_x, b_eq_y)

    def proj(init_state, cx_bar, cy_bar, xt, yt):
        b_eq_x, b_eq_y = boundary_vectors(cfg, init_state)
        zeros = jnp.zeros((nb, cfg.horizon.nvar))
        pr = project(cfg, ws, cx_bar, cy_bar, b_eq_x, b_eq_y, zeros, zeros,
                     jnp.zeros((nb, 2 * (cfg.horizon.num - 1))), xt, yt)
        return pr.x, pr.y, pr.res_norm, pr.xdot, pr.ydot, pr.xddot, pr.yddot

    def controls(xdot, ydot, xddot, yddot):
        return controls_from_trajectory(xdot, ydot, xddot, yddot,
                                        cfg.horizon.dt,
                                        cfg.vehicle.wheel_base)

    def rollouts(init_state, acc, steer):
        state0 = jnp.asarray([init_state[0], init_state[1], init_state[2],
                              init_state[3],
                              jnp.arctan2(init_state[3], init_state[2])])
        key, _ = jax.random.split(jax.random.PRNGKey(7))
        return batched_rollouts(cfg, key, acc[:, :T], steer[:, :T], state0,
                                mother=True)

    def refit(xr, yr):
        cxr, cyr = refit_coefficients(ws, xr.reshape(nb * M, T),
                                      yr.reshape(nb * M, T))
        return cxr.reshape(nb, M, -1), cyr.reshape(nb, M, -1)

    def inner(cxr, cyr, xr, yr):
        rs = select_reduced_set_batched(cfg1, cxr, cyr, xr, yr)
        return rs.res, rs.beta, rs.sigma

    return [
        ("compute_guess", guess, ("init_state", "mean", "cov"),
         ("cx_bar", "cy_bar")),
        ("project", proj, ("init_state", "cx_bar", "cy_bar", "xt", "yt"),
         ("x", "y", "res_norm", "xdot", "ydot", "xddot", "yddot")),
        ("controls_from_trajectory", controls,
         ("xdot", "ydot", "xddot", "yddot"), ("acc", "steer")),
        ("mother_rollouts", rollouts, ("init_state", "acc", "steer"),
         ("xr", "yr")),
        ("refit_coefficients", refit, ("xr", "yr"), ("cxr", "cyr")),
        ("inner_cem_iteration", inner, ("cxr", "cyr", "xr", "yr"),
         ("res", "beta", "sigma")),
    ]


def run_stages(stages, precision: str, device, inputs: dict,
               ref: dict | None = None) -> dict:
    """Run ``stages`` in order on ``device`` at matmul ``precision``.

    Without ``ref`` each stage takes the outputs of the stages before it
    (the reference chain).  With ``ref`` every stage takes its inputs from
    ``ref``, so each stage is compared with the reference on identical
    inputs and no stage inherits another's rounding.  Returns all inputs
    and outputs as numpy arrays."""
    from mpc_mmd_tpu.solver import with_matmul_precision

    env = dict(inputs)
    for _, fn, ins, outs in stages:
        src = env if ref is None else ref
        args = jax.device_put([src[k] for k in ins], device)
        res = jax.jit(with_matmul_precision(fn, precision))(*args)
        env.update(zip(outs, (np.asarray(r) for r in res)))
    return env


def stage_deviations(stages, got: dict, ref: dict) -> dict:
    """Per stage: max |got - ref| / max |ref| over its outputs.  The inner
    CEM's winning beta (an argmin over samples) is compared only on
    candidates whose winning sample agrees; the count of candidates whose
    winner differs is returned as ``winner_flips``."""
    dev = {}
    for name, _, _, outs in stages:
        worst = 0.0
        for k in outs:
            g, r = got[k].astype(np.float64), ref[k].astype(np.float64)
            assert np.all(np.isfinite(g)), f"{name}: non-finite {k}"
            if k == "beta":
                same = np.isclose(got["sigma"], ref["sigma"], rtol=1e-3,
                                  atol=0.0)
                dev["winner_flips"] = int(np.sum(~same))
                g, r = g[same], r[same]
                if not same.any():
                    continue
            worst = max(worst, float(np.max(np.abs(g - r))
                                     / max(np.max(np.abs(r)), 1e-30)))
        dev[name] = worst
    return dev


def phase_stages(gpu, cpu) -> None:
    from mpc_mmd_tpu import static_workload
    from mpc_mmd_tpu.qp import build_workspace

    cfg = static_workload(num_reduced=10, num_obs=6, num_prime=50)
    ws = build_workspace(cfg)
    init_state, mean, cov, _, xt, yt = static_inputs(cfg, ws, 1)
    inputs = {"init_state": np.asarray(init_state), "mean": np.asarray(mean),
              "cov": np.asarray(cov), "xt": np.asarray(xt[0]),
              "yt": np.asarray(yt[0])}
    stages = stage_functions(cfg, ws)
    n = cfg.cem.num_batch
    for precision in ("highest", "default"):
        ref = run_stages(stages, precision, cpu, inputs)
        got = run_stages(stages, precision, gpu, inputs, ref=ref)
        d = stage_deviations(stages, got, ref)
        flips = d.pop("winner_flips")
        text = ", ".join(f"{k} {v:.3g}" for k, v in d.items())
        if precision == "highest":
            log("stages", f"precision=highest (f32 on both), each stage on "
                f"the CPU's inputs: max |gpu-cpu| / max|cpu|: {text}; inner-"
                f"CEM winner flips {flips}/{n} (limit 1e-4 per stage)")
            bad = {k: v for k, v in d.items() if v > 1e-4}
            assert not bad, f"stages over 1e-4 at highest precision: {bad}"
        else:
            log("stages", f"precision=default (TF32 contractions on the GPU, "
                f"f32 on the CPU), each stage on the CPU's inputs: max "
                f"|gpu-cpu| / max|cpu|: {text}; inner-CEM winner flips "
                f"{flips}/{n} (reported, not bounded)")


# ---------------------------------------------------------------------------
# solve: compile, time and check each configuration
# ---------------------------------------------------------------------------

class CacheEvents:
    """Counts JAX's persistent-cache hit and miss events, in total and for
    the compile running on the calling thread."""

    def __init__(self):
        self.hits = self.misses = 0
        self._local = threading.local()
        jax.monitoring.register_event_listener(self._on_event)

    def _on_event(self, event: str, **_):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1
            self._local.hit = True
        elif event == "/jax/compilation_cache/cache_misses":
            self.misses += 1

    def compile(self, lowered):
        """(compiled, seconds, 'cache hit' | 'compiled')."""
        self._local.hit = False
        t0 = time.perf_counter()
        compiled = lowered.compile()
        secs = time.perf_counter() - t0
        return compiled, secs, ("cache hit" if self._local.hit
                                else "compiled")


def compile_all(phase: str, programs, cache: CacheEvents):
    """Lower ``programs`` [(label, jitted, args)] in turn, compile the first
    alone (a clean cold-compile time) and the rest concurrently; logs each
    compile and returns the compiled executables in order."""
    lowered = [jitted.lower(*args) for _, jitted, args in programs]
    first = cache.compile(lowered[0])
    log(phase, f"{programs[0][0]}: {first[2]} in {first[1]:.2f} s, alone "
        f"(on {CARD})")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(len(lowered) - 1, 1)) as ex:
        rest = list(ex.map(cache.compile, lowered[1:]))
    for (label, _, _), (_, secs, how) in zip(programs[1:], rest):
        log(phase, f"{label}: {how} in {secs:.2f} s, concurrently with "
            f"{len(rest) - 1} others (on {CARD})")
    log(phase, f"{len(rest)} concurrent compiles took "
        f"{time.perf_counter() - t0:.2f} s wall (on {CARD})")
    return [first[0]] + [c for c, _, _ in rest]


def time_solves(compiled, make_args, reps: int) -> float:
    """Median seconds of ``reps`` blocking calls (after one warm-up)."""
    jax.block_until_ready(compiled(*make_args(0)))
    ts = []
    for i in range(reps):
        args = make_args(i + 1)
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def memory_text(compiled, device) -> str:
    ma = compiled.memory_analysis()
    peak = (device.memory_stats() or {}).get("peak_bytes_in_use", 0)
    return (f"temp {ma.temp_size_in_bytes / 2**20:.1f} MiB, args "
            f"{ma.argument_size_in_bytes / 2**20:.2f} MiB, out "
            f"{ma.output_size_in_bytes / 2**20:.3f} MiB; process "
            f"peak_bytes_in_use {peak / 2**20:.1f} MiB")


def check_result(label: str, r, mmd_opt: bool) -> None:
    for f in r._fields:
        a = np.asarray(getattr(r, f))
        assert np.all(np.isfinite(a)), f"{label}: non-finite {f}"
    if mmd_opt:
        risk = np.asarray(r.risk_obs)
        assert np.all(risk <= 0.0), f"{label}: risk_obs {risk} > 0"


def solve_cases():
    """(label, solver, args-maker, mmd?) for every configuration."""
    from mpc_mmd_tpu import (Solver, dynamic_workload, fastrt_workload,
                             static_workload)
    from mpc_mmd_tpu.config import onroad_workload
    from mpc_mmd_tpu.frenet import path_parameters
    from mpc_mmd_tpu.scenarios import dynamic_cutin, ego_initial_state
    from mpc_mmd_tpu.solver_frenet import FrenetSolver

    cases = []
    for mode in ("mmd_opt", "cvar", "saa", "mmd_random"):
        cfg = static_workload(num_reduced=10, num_obs=6, num_prime=50,
                              mode=mode)
        # risk_obs <= 0 is the mark of a converged inner CEM, so it is
        # asserted for mmd_opt only: mmd_random's reduced set is a random
        # draw and its risk_obs can be positive
        cases.append((f"static {mode} (B100x20, S100x20, N=10, M=100)", cfg,
                      "static", mode == "mmd_opt"))
    cases.append(("static mmd_opt fastrt (B64x10, S64x12)",
                  fastrt_workload(num_reduced=10, num_obs=6, num_prime=50),
                  "static", True))
    cases.append(("dynamic cut-in mmd_opt (beta 0.3)", dynamic_workload(),
                  "dynamic", True))

    out = []
    for label, cfg, workload, mmd in cases:
        solver = Solver(cfg)
        if workload == "static":
            init_state, mean, cov, v_des, xt, yt = static_inputs(
                cfg, solver.ws, 8)
        else:
            batch = dynamic_cutin(cfg, 8)
            init_state, mean, cov, v_des = ego_initial_state("dynamic")
            xt, yt = batch.x_traj, batch.y_traj

        def make(i, xt=xt, yt=yt, init_state=init_state, mean=mean, cov=cov,
                 v_des=v_des):
            return (i, init_state, mean, cov, xt[i % 8], yt[i % 8], v_des)

        out.append((label, solver._solve, make, mmd))
        if label.startswith("static mmd_opt (B100"):
            def make_batch(i, xt=xt, yt=yt, init_state=init_state, mean=mean,
                           cov=cov, v_des=v_des):
                return (jnp.arange(8, dtype=jnp.int32) + 8 * i, init_state,
                        mean, cov, xt, yt, v_des)
            batch_case = ("static mmd_opt solve_batch x8 scenarios",
                          solver._solve_batch, make_batch, True)

    fcfg = onroad_workload()
    fsolver = FrenetSolver(fcfg)
    frame = path_parameters(
        jnp.linspace(0.0, fcfg.frenet.lookahead, fcfg.frenet.num_path),
        jnp.zeros(fcfg.frenet.num_path))
    tot = jnp.asarray(np.linspace(0, fcfg.horizon.t_fin, fcfg.horizon.num),
                      jnp.float32)
    n_obs = fcfg.obstacles.num_obs
    xt_o = jnp.asarray(np.linspace(30.0, 90.0, n_obs))[:, None] + 2.0 * tot
    yt_o = jnp.asarray(np.resize([0.0, 3.5], n_obs))[:, None] + 0.0 * tot
    init_global = jnp.asarray([0.0, 0.0, 8.0, 0.0, 0.0, 0.0], jnp.float32)
    mean = jnp.asarray([15.0] * 4 + [0.0] * 4)
    cov = jnp.asarray(np.diag([20.0] * 4 + [100.0] * 4), jnp.float32)

    def make_f(i):
        return (i, init_global, mean, cov, xt_o, yt_o, jnp.float32(15.0),
                frame)

    out.append(("on-road Frenet mmd_opt (N=4, 4 obs)", fsolver._solve,
                make_f, True))
    out.append(batch_case)
    return out, fsolver


def phase_solve(gpu, cache: CacheEvents):
    cases, fsolver = solve_cases()
    compiled = compile_all("solve", [(label, jitted, make(0))
                                     for label, jitted, make, _ in cases],
                           cache)
    for (label, _, make, mmd), exe in zip(cases, compiled):
        reps = 3 if "B100" in label or "x8" in label else 5
        med = time_solves(exe, make, reps)
        r = exe(*make(reps + 1))
        check_result(label, r, mmd)
        risk = np.asarray(r.risk_obs)
        log("solve", f"{label}: median solve {med * 1e3:.2f} ms over {reps} "
            f"(on {CARD}); risk_obs "
            f"{np.round(risk, 3).tolist() if risk.ndim else float(risk):}; "
            f"{memory_text(exe, gpu)}")
    return fsolver


# ---------------------------------------------------------------------------
# pipeline: sweep -> validate -> closed loop, in this process
# ---------------------------------------------------------------------------

def phase_pipeline(fsolver) -> None:
    from mpc_mmd_tpu.cli import sweep as sweep_cli
    from mpc_mmd_tpu.cli import validate as validate_cli
    from mpc_mmd_tpu.closedloop import run_episode
    from mpc_mmd_tpu.config import onroad_workload
    from mpc_mmd_tpu.utils.io_store import ResultStore

    data = os.path.join(OUT_DIR, "data")
    stats = os.path.join(OUT_DIR, "stats")
    shutil.rmtree(data, ignore_errors=True)
    shutil.rmtree(stats, ignore_errors=True)
    n_cfg = 8
    t0 = time.perf_counter()
    sweep_cli.main(["--workload", "static", "--costs", "mmd_opt", "cvar",
                    "--noise_levels", "0.1", "--num_reduced_sets", "10",
                    "--num_obs", "6", "--num_prime", "50", "--noises",
                    "gaussian", "--num_configs", str(n_cfg), "--chunk", "4",
                    "--accept_all", "--out", data])
    log("pipeline", f"cli.sweep mmd_opt+cvar x {n_cfg} configs: "
        f"{time.perf_counter() - t0:.2f} s incl. compile (on {CARD})")
    roots = []
    for mode in ("mmd_opt", "cvar"):
        root = os.path.join(data, "static/gaussian_noise/noise_10/ts_50",
                            f"{mode}_all_10_samples_6_obs")
        arrays = ResultStore(root).concatenated()
        seeds = np.random.RandomState(0).randint(1, 10000, size=n_cfg)
        assert arrays["cx"].shape == (n_cfg, 11), arrays["cx"].shape
        assert np.array_equal(np.sort(arrays["seeds"]), np.sort(seeds))
        for f in ("cx", "cy", "risk_obs", "x_obs_traj"):
            assert np.all(np.isfinite(arrays[f])), f"{mode}: {f}"
        roots.append(root)
    log("pipeline", f"stores round-trip: {n_cfg} finite rows each in "
        "mmd_opt and cvar")
    t0 = time.perf_counter()
    validate_cli.main(["--data", *roots, "--compare", "--n_mc", "1000",
                       "--out", stats])
    side = os.path.join(stats, "gaussian_noise/noise_10/ts_50",
                        "10_samples_6_obs.json")
    with open(side) as f:
        res = json.load(f)
    assert res["n_common"] == n_cfg, res["n_common"]
    for mode, m in res["modes"].items():
        assert all(np.isfinite(v) for v in m.values()), mode
    log("pipeline", f"cli.validate --compare n_mc=1000 on {n_cfg} common "
        f"scenarios: {time.perf_counter() - t0:.2f} s (on {CARD}); "
        + "; ".join(f"{k} coll {v['coll_pct_mean']:.2f}%"
                    for k, v in res["modes"].items()))
    t0 = time.perf_counter()
    ep = run_episode(onroad_workload(), max_steps=5, solver=fsolver)
    assert np.all(np.isfinite(ep.ego_trace)) and len(ep.ego_trace) == ep.steps
    log("pipeline", f"closed-loop episode: {ep.steps} MPC steps, collided="
        f"{ep.collided}, min margin {ep.min_obstacle_margin:.2f} m, median "
        f"step solve {np.median(ep.solve_times) * 1e3:.2f} ms, total "
        f"{time.perf_counter() - t0:.2f} s (on {CARD})")


# ---------------------------------------------------------------------------
# --multichip: sharded paths against one device
# ---------------------------------------------------------------------------

def _max_rel(a, b) -> float:
    """max |a - b| / (1e-3 |b| + 1e-6): <= 1 means within rtol 1e-3."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / (1e-3 * np.abs(b) + 1e-6)))


def phase_multichip(devices, cache: CacheEvents) -> None:
    from functools import partial

    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from mpc_mmd_tpu import Solver, static_workload
    from mpc_mmd_tpu.parallel.mesh import (SCENARIO_AXIS, make_mesh,
                                           sharded_sweep, sharded_validator,
                                           sweep_statistics)
    from mpc_mmd_tpu.qp import build_workspace
    from mpc_mmd_tpu.scenarios import blocking_scenarios, ego_initial_state
    from mpc_mmd_tpu.solver import _solve
    from mpc_mmd_tpu.validate import make_validator

    n = len(devices)
    # A full-budget solve is chaotic in its inputs' last bits: the CEM's
    # argsorts meet near-ties, so a 1e-7 input perturbation moves some
    # solves far past rtol 1e-3 even in f32 on the CPU.  The one-device
    # reference therefore runs the very program each card runs (a vmap over
    # that card's S/n scenarios), chunk by chunk, with f32 contractions.
    cfg = static_workload(num_reduced=10, num_obs=6, num_prime=50).replace(
        matmul_precision="highest")
    ws = build_workspace(cfg)
    mesh = make_mesh()
    failed = []
    sh = NamedSharding(mesh, P(SCENARIO_AXIS))
    S = 2 * n
    xt, yt = blocking_scenarios(ws.tot_time, S, n_obs=6)
    init_state, mean, cov, v_des = ego_initial_state("static")
    seeds = jnp.arange(S, dtype=jnp.int32) + 11
    sweep_args = (jax.device_put(seeds, sh), init_state, mean, cov,
                  jax.device_put(xt, sh), jax.device_put(yt, sh), v_des)
    per = S // n
    one_args = [(seeds[i:i + per], init_state, mean, cov, xt[i:i + per],
                 yt[i:i + per], v_des) for i in range(0, S, per)]
    solve_args = (3, init_state, mean, cov, xt[0], yt[0], v_des)
    cmesh = Mesh(np.asarray(devices), ("candidates",))
    sweep_sh, sweep_1, solve_c, solve_1 = compile_all("multichip", [
        (f"sharded_sweep {S} scenarios over {n} GPUs",
         sharded_sweep(cfg, ws, mesh), sweep_args),
        (f"one-device vmap of {per} scenarios (one card's share)",
         jax.jit(jax.vmap(partial(_solve, cfg, ws),
                          in_axes=(0, None, None, None, 0, 0, None))),
         one_args[0]),
        (f"candidate_mesh solve over {n} GPUs",
         Solver(cfg, ws, candidate_mesh=cmesh)._solve, solve_args),
        ("unsharded solve", Solver(cfg, ws)._solve, solve_args)], cache)

    out = sweep_sh(*sweep_args)
    ref = jax.tree_util.tree_map(lambda *a: jnp.concatenate(a),
                                 *[sweep_1(*a) for a in one_args])
    held = {s.device for s in out.cx.addressable_shards}
    assert held == set(devices), f"shards on {held}"
    check_result("sharded sweep", out, True)
    worst = max(_max_rel(getattr(out, f), getattr(ref, f))
                for f in ("cx", "cy", "risk_obs", "res"))
    log("multichip", f"precision=highest; sharded_sweep vs the one-device "
        f"vmap over each card's {per} scenarios: max |diff|/(1e-3|ref| + "
        f"1e-6) over cx, cy, risk_obs, res = {worst:.3g} (limit 1); cx "
        f"shards on {len(held)} of {n} devices; {S} scenarios take "
        f"{1e3 * time_solves(sweep_sh, lambda i: sweep_args, 2):.1f} ms "
        f"sharded vs {1e3 * per * time_solves(sweep_1, lambda i: one_args[0], 2):.1f}"
        f" ms as {n} chunks on one device (on {CARD})")
    if worst > 1.0:
        failed.append("sharded_sweep")

    # the psum'd statistics against the same statistics of the same risk
    # values reduced on one device (the host)
    r_np = np.asarray(out.risk_obs, np.float64)
    thr = float(np.median(r_np))
    n_acc, mean_r, max_r = sweep_statistics(cfg, mesh)(
        jax.device_put(out.risk_obs, sh), jnp.float32(thr))
    exp = (int(np.sum(r_np <= thr)), r_np.mean(), r_np.max())
    log("multichip", f"sweep_statistics psum: accepted {int(n_acc)} (one "
        f"device {exp[0]}), mean {float(mean_r):.7g} ({exp[1]:.7g}), max "
        f"{float(max_r):.7g} ({exp[2]:.7g})")
    if not (int(n_acc) == exp[0] and float(max_r) == float(exp[2])
            and abs(float(mean_r) - exp[1]) <= 1e-6 * abs(exp[1])):
        failed.append("sweep_statistics")

    key = jax.random.PRNGKey(5)
    m = S - 1                       # not a multiple of n: exercises padding
    v_args = (ref.cx[:m], ref.cy[:m], init_state, xt[:m], yt[:m], key)
    vs, coll_tot, lane_tot = sharded_validator(cfg, ws, n_mc=1000,
                                               mesh=mesh)(*v_args)
    v1 = make_validator(cfg, ws, n_mc=1000)(*v_args)
    same = all(np.array_equal(np.asarray(a), np.asarray(b))
               for a, b in zip(vs, v1))
    d_coll = int(np.max(np.abs(np.asarray(vs.coll_count)
                               - np.asarray(v1.coll_count))))
    d_lane = int(np.max(np.abs(np.asarray(vs.lane_count)
                               - np.asarray(v1.lane_count))))
    psum_ok = (int(coll_tot) == int(np.sum(vs.coll_count))
               and int(lane_tot) == int(np.sum(vs.lane_count)))
    log("multichip", f"sharded_validator n_mc=1000 on {m} solves over {n} "
        f"GPUs: bitwise identical to one device: {same}; worst per-solve "
        f"count difference: collisions {d_coll}, lane {d_lane} (limit 5 of "
        f"1000); psum totals equal the sum of the per-solve stats: "
        f"{psum_ok} (collisions {int(coll_tot)}, one device "
        f"{int(np.sum(v1.coll_count))})")
    if not (psum_ok and d_coll <= 5 and d_lane <= 5):
        failed.append("sharded_validator")

    r_c, r_1 = solve_c(*solve_args), solve_1(*solve_args)
    check_result("candidate-mesh solve", r_c, True)
    d = max(_max_rel(getattr(r_c, f), getattr(r_1, f))
            for f in ("cx", "cy", "risk_obs", "res"))
    log("multichip", f"candidate_mesh solve vs unsharded: max |diff|/(1e-3"
        f"|ref| + 1e-6) = {d:.3g} (limit 1); "
        f"{1e3 * time_solves(solve_c, lambda i: solve_args, 3):.2f} ms vs "
        f"{1e3 * time_solves(solve_1, lambda i: solve_args, 3):.2f} ms per "
        f"solve (on {CARD})")
    if d > 1.0:
        failed.append("candidate_mesh")
    assert not failed, f"multichip comparisons failed: {failed}"


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    global CARD
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--multichip", action="store_true",
                   help="run only the sharded paths over all devices")
    args = p.parse_args(argv)

    devices = jax.devices()
    require_gpu(devices)
    CARD = card_identity()
    print(CARD, flush=True)
    gpu = devices[0]
    log("device", f"platform {gpu.platform}, kind {gpu.device_kind}, "
        f"count {len(devices)}; card: {CARD}")

    from mpc_mmd_tpu.utils.compilation_cache import enable_persistent_cache
    log("device", f"persistent compile cache: {enable_persistent_cache()}")
    cache = CacheEvents()
    os.makedirs(OUT_DIR, exist_ok=True)

    t_start = time.perf_counter()
    if args.multichip:
        phase_multichip(devices, cache)
    else:
        cpu = jax.devices("cpu")[0]
        for name, run in (("kernels", lambda: phase_kernels(cpu)),
                          ("stages", lambda: phase_stages(gpu, cpu))):
            t0 = time.perf_counter()
            run()
            log(name, f"ok in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        fsolver = phase_solve(gpu, cache)
        log("solve", f"ok in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        phase_pipeline(fsolver)
        log("pipeline", f"ok in {time.perf_counter() - t0:.1f} s")
    log("done", f"all phases ok in {time.perf_counter() - t_start:.1f} s; "
        f"persistent cache hits {cache.hits}, misses {cache.misses}")
    print(json.dumps({"ok": True, "device": {
        "platform": gpu.platform, "kind": gpu.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
