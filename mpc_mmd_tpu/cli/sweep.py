"""Batch solve sweep over obstacle scenarios (static or dynamic workloads).

Device-batched, resumable replacement for the reference's
``synthetic_static_obs/main_mpc.py`` / ``synthetic_dynamic_obs/main_mpc.py``
(which re-enter jit once per config in a Python loop).  Scenarios solve in
vmapped chunks, accepted solves (risk below the mode's threshold,
main_mpc.py:86-97,121) are compacted on host, and chunks land in a
resumable ResultStore.

Usage:
    python -m mpc_mmd_tpu.cli.sweep --workload static --costs mmd_opt cvar \
        --noise_levels 0.1 --num_reduced_sets 10 --num_obs 6 --num_prime 50 \
        --noises gaussian --num_configs 200 --out ./data
"""

from __future__ import annotations

import argparse

import jax.numpy as jnp
import numpy as np

from ..config import dynamic_workload, static_workload
from ..scenarios import dynamic_cutin, ego_initial_state, static_grid
from ..solver import Solver
from ..utils.debug import hosts_alive
from ..utils.io_store import ResultStore
from ..utils.observability import MetricLogger, phase_timer


class HostFailure(RuntimeError):
    """A peer host failed the heartbeat; completed chunks are already
    persisted, so re-running the sweep resumes from the failure point."""


def accept_threshold(mode: str, ker_wt: float) -> float:
    """Ref: main_mpc.py:86-97."""
    if mode.startswith("mmd"):
        return -ker_wt + 1.0
    return 1.0e-5


def run_sweep(workload: str, mode: str, noise: str, noise_level: float,
              num_reduced: int, num_obs: int, num_prime: int,
              num_configs: int, out_root: str, chunk: int = 20,
              acc_const_noise: float = 0.0, steer_const_noise: float = 0.0,
              logger: MetricLogger | None = None,
              heartbeat_every: int = 0,
              heartbeat_timeout_s: float = 30.0,
              dispatch: str | None = None,
              inner_budget: tuple | None = None,
              outer_budget: tuple | None = None,
              accept_all: bool = False,
              kernel: str = "laplace",
              scenario_chunk: int | None = None) -> ResultStore:
    """dispatch: "pipeline" (default; per-scenario async dispatch), "batch"
    (one solve_batch program per chunk) or "mesh" (scenario-sharded
    shard_map sweep over the device mesh, with psum'd acceptance stats and
    per-process ResultStore shards — the multi-device BASELINE config 5
    path; under multi-host each process solves only the chunks it owns,
    cid % num_processes == process_id).  Which dispatch is fastest on the
    H100 is not measured yet.  Env override: MPC_MMD_SWEEP_DISPATCH."""
    import os
    if dispatch is None:
        dispatch = os.environ.get("MPC_MMD_SWEEP_DISPATCH", "pipeline")
    if dispatch not in ("pipeline", "batch", "mesh"):
        raise ValueError(f"unknown dispatch {dispatch!r}")
    logger = logger or MetricLogger()
    make = static_workload if workload == "static" else dynamic_workload
    cfg = make(num_reduced=num_reduced, num_obs=num_obs, noise=noise,
               noise_level=noise_level, num_prime=num_prime, mode=mode,
               acc_const_noise=acc_const_noise,
               steer_const_noise=steer_const_noise)
    if inner_budget is not None:
        # reduced inner-CEM budget (the "realtime" operating point; see
        # config.realtime_workload) — tagged into the store name so a
        # certification run can sweep default and reduced budgets side by
        # side without store collisions
        import dataclasses as _dc
        S_b, it_b = inner_budget
        cfg = cfg.replace(beta_cem=_dc.replace(
            cfg.beta_cem, num_samples_cem=S_b, maxiter=it_b))
    if outer_budget is not None:
        # reduced OUTER-CEM budget (num_batch x maxiter_cem — the "fast"
        # operating point, round-4 certification; reference constants at
        # synthetic_static_obs/optimizer/cem.py:88-89,137-140)
        import dataclasses as _dc
        B_b, it_b = outer_budget
        cfg = cfg.replace(cem=_dc.replace(
            cfg.cem, num_batch=B_b, maxiter_cem=it_b))
    if kernel != "laplace":
        # selectable MMD kernel (RiskConfig.kernel; the reference ships
        # gaussian/matern52 commented out, kernel_computation.py:21-53)
        import dataclasses as _dc
        cfg = cfg.replace(risk=_dc.replace(cfg.risk, kernel=kernel))
    # scenario_chunk: concurrent scenarios per solve_batch program
    # (dispatch=batch).
    solver = Solver(cfg, scenario_chunk=scenario_chunk)

    process_id, num_processes = 0, 1
    if dispatch == "mesh":
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        from ..parallel.mesh import (SCENARIO_AXIS, make_mesh, sharded_sweep,
                                     sweep_statistics)
        process_id, num_processes = jax.process_index(), jax.process_count()
        # Multi-controller: each process executes ONLY the chunks it owns
        # (cid % num_processes), so its shard_map must be a purely LOCAL
        # program — a global mesh would (a) raise on device_put of
        # process-local chunk arrays to non-addressable devices and
        # (b) deadlock collectives, since the processes take disjoint chunk
        # paths.  Single-process keeps the global mesh (same thing there).
        # Exercised for real by tests/test_mesh.py's 2-process
        # jax.distributed run.
        mesh_obj = make_mesh(local=num_processes > 1)
        mesh_sweep = sharded_sweep(cfg, solver.ws, mesh_obj)
        mesh_stats = sweep_statistics(cfg, mesh_obj)
        n_dev = int(np.prod(mesh_obj.devices.shape))
        shard_spec = NamedSharding(mesh_obj, P(SCENARIO_AXIS))

    with phase_timer(logger, "scenario_gen"):
        if workload == "static":
            batch = static_grid(cfg, num_configs)
        else:
            batch = dynamic_cutin(cfg, num_configs)

    init_state, mean, cov, v_des = ego_initial_state(workload)
    # accept_all persists EVERY solve (threshold +inf) with its risk_obs,
    # so any acceptance rule — the reference's asymmetric thresholds
    # (main_mpc.py:86-97), symmetric accept-all, or an MC-validated cutoff
    # — can be re-derived downstream (the harmonized-acceptance control,
    # VERDICT r3 item 3)
    threshold = np.inf if accept_all else \
        accept_threshold(mode, cfg.risk.ker_wt)

    # round(), not int(): 0.29 * 100 == 28.999... and int() would put the
    # sweep in noise_28/ while cli/validate.py's stats layout (which already
    # uses round(), see validate.py:182) writes noise_29/ — the two sides of
    # the pipeline must agree on the directory for every representable level.
    mode_tag = mode if inner_budget is None else \
        f"{mode}_S{inner_budget[0]}x{inner_budget[1]}"
    if outer_budget is not None:
        mode_tag += f"_B{outer_budget[0]}x{outer_budget[1]}"
    if kernel != "laplace":
        mode_tag += f"_K{kernel}"
    if accept_all:
        mode_tag += "_all"
    tag = (f"{workload}/{noise}_noise/noise_{round(noise_level * 100)}/"
           f"ts_{num_prime}/{mode_tag}_{num_reduced}_samples_{num_obs}_obs")
    meta = {
        "workload": workload, "mode": mode, "noise": noise,
        "noise_level": noise_level, "num_reduced": num_reduced,
        "num_obs": num_obs, "num_prime": num_prime,
        "num_configs": num_configs}
    if inner_budget is not None:
        meta["inner_budget"] = list(inner_budget)
    if outer_budget is not None:
        meta["outer_budget"] = list(outer_budget)
    if accept_all:
        meta["accept_all"] = True
    if kernel != "laplace":
        meta["kernel"] = kernel
    store = ResultStore(f"{out_root}/{tag}", meta=meta,
                        process_id=process_id, num_processes=num_processes)

    rng = np.random.RandomState(0)
    seeds_all = rng.randint(1, 10000, size=num_configs)

    # prefetch the scenario arrays to host ONCE instead of slicing device
    # arrays per field per chunk inside the loop
    host = {f: np.asarray(getattr(batch, f))
            for f in ("x_obs", "y_obs", "vx_obs", "vy_obs", "psi_obs",
                      "x_traj", "y_traj")}

    n_chunks = (num_configs + chunk - 1) // chunk
    for cid in range(n_chunks):
        if not store.owns(cid):       # multi-process: peer's chunk
            continue
        if store.is_done(cid):
            continue
        if heartbeat_every and cid % heartbeat_every == 0:
            # multi-host failure detection (SURVEY §5): a dead peer would
            # hang the next collective forever; probe with a watchdog and
            # abort cleanly instead — completed chunks are already on disk,
            # so a restart resumes exactly here.
            if not hosts_alive(heartbeat_timeout_s):
                logger.log("host_failure", chunk=cid)
                raise HostFailure(
                    f"heartbeat failed before chunk {cid}; "
                    f"{len(store.done_chunks())} chunks persisted — rerun to "
                    "resume")
        lo, hi = cid * chunk, min((cid + 1) * chunk, num_configs)
        sl = slice(lo, hi)
        with phase_timer(logger, "solve_chunk", chunk=cid, size=hi - lo):
            if dispatch == "pipeline":
                # Per-scenario async dispatch: every jitted solve call
                # enqueues immediately and the device pipelines them; the
                # np.asarray fetches below fence the chunk.  The lax.map
                # chunk body serializes strictly, while async dispatch
                # overlaps each solve's tail with the next one's head.
                outs = [solver.solve(int(seeds_all[i]), init_state, mean,
                                     cov, batch.x_traj[i], batch.y_traj[i],
                                     v_des)
                        for i in range(lo, hi)]
                # stack on DEVICE (still async), then ONE host fetch per
                # consumed field instead of one per solve per field; the
                # sweep only persists cx/cy/risk_obs.
                def _stack(f):
                    return np.asarray(jnp.stack([getattr(o, f)
                                                 for o in outs]))
                cx_np, cy_np = _stack("cx"), _stack("cy")
                risk = _stack("risk_obs")
            elif dispatch == "mesh":
                # scenario-sharded shard_map over the mesh: pad the chunk
                # to a multiple of the mesh size (dup of the last scenario;
                # trimmed before persisting), shard inputs, ONE program
                n = hi - lo
                pad = (-n) % n_dev
                idx_p = np.concatenate([np.arange(lo, hi),
                                        np.full(pad, hi - 1, np.int64)])
                import jax
                seeds_p = jax.device_put(
                    jnp.asarray(seeds_all[idx_p], jnp.int32), shard_spec)
                xt_p = jax.device_put(jnp.asarray(host["x_traj"][idx_p]),
                                      shard_spec)
                yt_p = jax.device_put(jnp.asarray(host["y_traj"][idx_p]),
                                      shard_spec)
                res = mesh_sweep(seeds_p, init_state, mean, cov, xt_p, yt_p,
                                 v_des)
                # psum'd acceptance count INSIDE the mapped region (padding
                # rows masked to +inf so they never count)
                mask = jnp.asarray(np.arange(n + pad) < n)
                risk_m = jnp.where(mask, res.risk_obs, jnp.inf)
                n_acc_dev, _, _ = mesh_stats(risk_m, jnp.float32(threshold))
                logger.log("chunk_psum_stats", chunk=cid,
                           accepted=int(n_acc_dev))
                cx_np = np.asarray(res.cx)[:n]
                cy_np = np.asarray(res.cy)[:n]
                risk = np.asarray(res.risk_obs)[:n]
            else:
                res = solver.solve_batch(
                    jnp.asarray(seeds_all[sl], jnp.int32), init_state, mean,
                    cov, batch.x_traj[sl], batch.y_traj[sl], v_des)
                cx_np, cy_np = np.asarray(res.cx), np.asarray(res.cy)
                risk = np.asarray(res.risk_obs)
        keep = risk <= threshold
        store.write_chunk(
            cid,
            cx=cx_np[keep], cy=cy_np[keep],
            init_state=np.tile(np.asarray(init_state), (int(keep.sum()), 1)),
            x_obs=host["x_obs"][sl][keep],
            y_obs=host["y_obs"][sl][keep],
            vx_obs=host["vx_obs"][sl][keep],
            vy_obs=host["vy_obs"][sl][keep],
            psi_obs=host["psi_obs"][sl][keep],
            x_obs_traj=host["x_traj"][sl][keep],
            y_obs_traj=host["y_traj"][sl][keep],
            risk_obs=risk[keep],
            seeds=seeds_all[sl][keep],
        )
        logger.log("chunk_done", chunk=cid, accepted=int(keep.sum()),
                   total=hi - lo)
    return store


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", choices=["static", "dynamic"], default="static")
    p.add_argument("--costs", type=str, nargs="+", required=True)
    p.add_argument("--noise_levels", type=float, nargs="+", required=True)
    p.add_argument("--num_reduced_sets", type=int, nargs="+", required=True)
    p.add_argument("--num_obs", type=int, nargs="+", required=True)
    p.add_argument("--num_prime", type=int, nargs="+", required=True)
    p.add_argument("--noises", type=str, nargs="+", required=True)
    p.add_argument("--acc_const_noise", type=float, default=0.0)
    p.add_argument("--steer_const_noise", type=float, default=0.0)
    p.add_argument("--num_configs", type=int, default=200)
    p.add_argument("--chunk", type=int, default=20)
    p.add_argument("--out", type=str, default="./data")
    p.add_argument("--metrics", type=str, default=None)
    p.add_argument("--heartbeat_every", type=int, default=0,
                   help="multi-host: probe hosts_alive every N chunks; "
                        "abort cleanly (resumable) on failure")
    p.add_argument("--heartbeat_timeout", type=float, default=30.0)
    p.add_argument("--inner_budget", type=str, default=None,
                   help="SxIT (e.g. 64x12): reduced inner-CEM budget for "
                        "mmd_opt (the realtime operating point; store tag "
                        "gains a _S{S}x{IT} suffix)")
    p.add_argument("--outer_budget", type=str, default=None,
                   help="BxIT (e.g. 64x12): reduced outer-CEM budget "
                        "(num_batch x maxiter_cem; the fast operating "
                        "point; store tag gains a _B{B}x{IT} suffix)")
    p.add_argument("--scenario_chunk", type=int, default=None,
                   help="concurrent scenarios inside each solve_batch "
                        "program (dispatch=batch; default: env "
                        "MPC_MMD_SCENARIO_CHUNK or 1).  fastrt-budget "
                        "sweeps measured fastest at --dispatch batch "
                        "--chunk 8 --scenario_chunk 4")
    p.add_argument("--kernel", default="laplace",
                   choices=["laplace", "gaussian", "matern52"],
                   help="MMD kernel family (RiskConfig.kernel); non-laplace "
                        "runs tag the store with _K{kernel}")
    p.add_argument("--accept_all", action="store_true",
                   help="persist EVERY solve (no acceptance threshold); "
                        "store tag gains an _all suffix — acceptance rules "
                        "are re-derived downstream from risk_obs")
    p.add_argument("--dispatch", choices=["pipeline", "batch", "mesh"],
                   default=None,
                   help="per-scenario async dispatch (default, faster), one "
                        "solve_batch program per chunk, or a scenario-"
                        "sharded shard_map sweep over the device mesh with "
                        "per-process store shards (multi-device path)")
    args = p.parse_args(argv)
    inner_budget = None
    if args.inner_budget:
        inner_budget = tuple(int(v) for v in args.inner_budget.split("x"))
    outer_budget = None
    if args.outer_budget:
        outer_budget = tuple(int(v) for v in args.outer_budget.split("x"))

    # warm-start from the persistent XLA cache
    from ..utils.compilation_cache import enable_persistent_cache
    enable_persistent_cache()

    logger = MetricLogger(args.metrics)
    for noise in args.noises:
        for lvl in args.noise_levels:
            for np_ in args.num_prime:
                for n_obs in args.num_obs:
                    for n_red in args.num_reduced_sets:
                        for mode in args.costs:
                            store = run_sweep(
                                args.workload, mode, noise, lvl, n_red, n_obs,
                                np_, args.num_configs, args.out, args.chunk,
                                args.acc_const_noise, args.steer_const_noise,
                                logger, args.heartbeat_every,
                                args.heartbeat_timeout, args.dispatch,
                                inner_budget, outer_budget,
                                args.accept_all, args.kernel,
                                args.scenario_chunk)
                            n = sum(len(a["cx"]) for _, a in store.iter_chunks())
                            print(f"workload={args.workload} cost={mode} "
                                  f"reduced={n_red} obs={n_obs} ts={np_} "
                                  f"noise={noise}@{lvl}: accepted {n}/"
                                  f"{args.num_configs}")


if __name__ == "__main__":
    main()
