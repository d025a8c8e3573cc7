"""Device-mesh scaling: scenario-sharded solve sweeps over several GPUs.

The reference is strictly single-device (SURVEY.md §2.4: no pmap/pjit/mesh,
inter-stage transport via npz files).  Here multi-chip scaling is first-class:

* **Scenario axis (DP)** — independent MPC solves (obstacle configs x seeds)
  shard across the mesh with ``shard_map``; zero inter-chip traffic during
  solves, collectives only for statistics reduction (psum) at the end.
  The mesh is 1-D and follows the algorithm alone: the cards of one host
  reach each other all to all over NVLink, so no torus shape carries over.
  This is the scaling axis that buys "solves/s" (SURVEY.md §5, §7).
* Statistics (collision counts, acceptance fractions, cost moments) reduce
  with ``jax.lax.psum`` inside the mapped region, so multi-device
  validation sweeps never materialize per-scenario data on one host.

Multi-host: call ``jax.distributed.initialize()`` before ``make_mesh`` and
pass globally-sharded arrays; the same code path covers 1 chip -> N hosts.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import ProblemConfig
from ..qp import Workspace, build_workspace
from ..solver import SolveResult, _solve

SCENARIO_AXIS = "scenarios"


def make_mesh(n_devices: Optional[int] = None,
              axis: str = SCENARIO_AXIS, local: bool = False) -> Mesh:
    """Build a 1-D scenario mesh.

    ``local=True`` restricts the mesh to this process's addressable devices
    — required when each process runs an independent (non-SPMD) slice of the
    work, e.g. the sweep CLI's chunk-ownership dispatch, where a global mesh
    would deadlock collectives across processes taking disjoint code paths.
    """
    devs = jax.local_devices() if local else jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (axis,))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> int:
    """Multi-host bring-up: ``jax.distributed.initialize`` + sanity barrier.

    Call once per process before ``make_mesh`` on a multi-host cluster.
    Nothing detects a GPU cluster automatically: pass the coordinator
    address (``host:port``), the process count and this process's id.
    Returns the process index.  Single-process callers (one host, any
    number of GPUs) skip this entirely.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs.update(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)
    # barrier: every process must see the same global device count
    n = jax.device_count()
    assert n >= jax.local_device_count()
    return jax.process_index()


def sharded_sweep(cfg: ProblemConfig, ws: Optional[Workspace] = None,
                  mesh: Optional[Mesh] = None):
    """Build a jitted scenario-sharded sweep function.

    Returns ``sweep(seeds, init_state, mean, cov, x_obs, y_obs, v_des)``
    where ``seeds`` is (S,) int32 and x_obs/y_obs are (S, num_obs, num);
    S must be divisible by the mesh size.  Output: SolveResult with a leading
    scenario axis, sharded over the mesh.
    """
    if ws is None:
        ws = build_workspace(cfg)
    if mesh is None:
        mesh = make_mesh()

    solve_local = jax.vmap(partial(_solve, cfg, ws),
                           in_axes=(0, None, None, None, 0, 0, None))

    def shard_body(seeds, init_state, mean, cov, x_obs, y_obs, v_des):
        return solve_local(seeds, init_state, mean, cov, x_obs, y_obs, v_des)

    spec_s = P(SCENARIO_AXIS)
    spec_r = P()
    mapped = jax.shard_map(
        shard_body, mesh=mesh,
        in_specs=(spec_s, spec_r, spec_r, spec_r, spec_s, spec_s, spec_r),
        out_specs=SolveResult(*([spec_s] * len(SolveResult._fields))),
        # replicated inputs feed scan carries that become device-varying;
        # skip the varying-manual-axes type check (pure DP, no collectives)
        check_vma=False)
    return jax.jit(mapped)


def sharded_frenet_sweep(cfg: ProblemConfig, ws: Optional[Workspace] = None,
                         mesh: Optional[Mesh] = None):
    """Scenario-sharded on-road (Frenet) solve sweep.

    Returns ``sweep(idxs, init_state_global, mean, cov, x_obs_traj,
    y_obs_traj, v_des, frame)`` with idxs (S,) int32 and x_obs_traj
    (S, num_obs, num) in Frenet coordinates; the local-path ``frame`` is
    replicated (every scenario solves against the same path window, the
    closed-loop fleet case).  Output: FrenetSolveResult with a leading
    scenario axis sharded over the mesh.
    """
    from ..frenet import FrenetFrame
    from ..solver_frenet import FrenetSolveResult, _solve_frenet

    if ws is None:
        ws = build_workspace(cfg)
    if mesh is None:
        mesh = make_mesh()

    solve_local = jax.vmap(
        partial(_solve_frenet, cfg, ws),
        in_axes=(0, None, None, None, 0, 0, None, None))

    def shard_body(idxs, init_state, mean, cov, x_obs, y_obs, v_des, frame):
        return solve_local(idxs, init_state, mean, cov, x_obs, y_obs,
                           v_des, frame)

    spec_s = P(SCENARIO_AXIS)
    spec_r = P()
    mapped = jax.shard_map(
        shard_body, mesh=mesh,
        in_specs=(spec_s, spec_r, spec_r, spec_r, spec_s, spec_s, spec_r,
                  FrenetFrame(*([spec_r] * len(FrenetFrame._fields)))),
        out_specs=FrenetSolveResult(
            *([spec_s] * len(FrenetSolveResult._fields))),
        check_vma=False)
    return jax.jit(mapped)


def sharded_validator(cfg: ProblemConfig, ws: Optional[Workspace] = None,
                      n_mc: int = 1000, mesh: Optional[Mesh] = None):
    """Mesh-sharded Monte-Carlo validator (multi-device BASELINE config 5).

    Returns ``validate(cx, cy, init_state, x_obs_traj, y_obs_traj, key)``
    — the same signature as :func:`mpc_mmd_tpu.validate.make_validator` —
    with the solve axis sharded over the mesh.  Keys are split globally
    (for the ORIGINAL solve count) then sharded, and any padding needed to
    reach a mesh-size multiple is added and trimmed internally, so
    per-solve results are bitwise identical to the single-device
    validator for every S.  Alongside the per-solve stats it returns
    psum-reduced totals ``(coll_total, lane_total)`` computed INSIDE the
    mapped region with padding masked out — the multi-device validation
    summary never gathers per-scenario data to one host (SURVEY §5
    distributed row).
    """
    from ..validate import ValidationStats, make_validator_core

    if ws is None:
        ws = build_workspace(cfg)
    if mesh is None:
        mesh = make_mesh()
    core = make_validator_core(cfg, ws, n_mc)
    n_dev = int(np.prod(mesh.devices.shape))

    def body(cx, cy, init_state, xt, yt, keys, mask):
        stats = core(cx, cy, init_state, xt, yt, keys)
        coll_total = jax.lax.psum(
            jnp.sum(jnp.where(mask, stats.coll_count, 0)), SCENARIO_AXIS)
        lane_total = jax.lax.psum(
            jnp.sum(jnp.where(mask, stats.lane_count, 0)), SCENARIO_AXIS)
        return stats, coll_total, lane_total

    spec_s = P(SCENARIO_AXIS)
    spec_r = P()
    mapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(spec_s, spec_s, spec_r, spec_s, spec_s, spec_s, spec_s),
        out_specs=(ValidationStats(spec_s, spec_s, spec_s), spec_r, spec_r),
        check_vma=False)
    mapped = jax.jit(mapped)
    sharding = NamedSharding(mesh, spec_s)

    def validate(cx, cy, init_state, x_obs_traj, y_obs_traj, key):
        S = cx.shape[0]
        keys = jax.random.split(key, S)
        pad = (-S) % n_dev

        def padded(a):
            if pad == 0:
                return jax.device_put(a, sharding)
            last = jnp.broadcast_to(a[-1:], (pad,) + a.shape[1:])
            return jax.device_put(jnp.concatenate([a, last]), sharding)

        mask = jnp.arange(S + pad) < S
        stats, coll_tot, lane_tot = mapped(
            padded(jnp.asarray(cx)), padded(jnp.asarray(cy)), init_state,
            padded(jnp.asarray(x_obs_traj)), padded(jnp.asarray(y_obs_traj)),
            padded(keys), jax.device_put(mask, sharding))
        stats = ValidationStats(*(a[:S] for a in stats))
        return stats, coll_tot, lane_tot

    return validate


def sweep_statistics(cfg: ProblemConfig, mesh: Optional[Mesh] = None):
    """Jitted psum-reduced sweep statistics.

    Input: per-scenario risk costs (S,) sharded over the mesh plus the
    acceptance threshold; output: replicated scalars
    (count_accepted, mean_risk, max_risk) — the device-side analog of the
    reference's host-side threshold filter (main_mpc.py:121) and the
    validator's count reductions (validation.py:153-169).
    """
    if mesh is None:
        mesh = make_mesh()

    def body(risk, threshold):
        accepted = jnp.sum(jnp.where(risk <= threshold, 1.0, 0.0))
        total = jax.lax.psum(accepted, SCENARIO_AXIS)
        mean = jax.lax.psum(jnp.sum(risk), SCENARIO_AXIS) / jax.lax.psum(
            jnp.asarray(risk.shape[0], jnp.float32), SCENARIO_AXIS)
        mx = jax.lax.pmax(jnp.max(risk), SCENARIO_AXIS)
        return total, mean, mx

    return jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(SCENARIO_AXIS), P()),
        out_specs=(P(), P(), P())))


def dryrun(n_devices: int) -> None:
    """Compile + execute the full sharded solve step on an n-device mesh.

    Tiny shapes, mmd_opt mode (exercises every subsystem: guess QP,
    projection, mother rollouts, inner beta-CEM, MMD risk, CEM update).
    Enables the persistent compile cache first (a no-op on the CPU backend).
    """
    from ..utils.compilation_cache import enable_persistent_cache
    enable_persistent_cache()
    import dataclasses

    from ..config import static_workload
    from ..dynamics import constant_velocity_obstacles

    cfg = static_workload(num_reduced=2, num_obs=1, num_prime=10,
                          mode="mmd_opt")
    cfg = cfg.replace(cem=dataclasses.replace(cfg.cem, maxiter_cem=2),
                      beta_cem=dataclasses.replace(cfg.beta_cem, maxiter=2))
    ws = build_workspace(cfg)
    mesh = make_mesh(n_devices)
    sweep = sharded_sweep(cfg, ws, mesh)

    S = n_devices
    seeds = jnp.arange(S, dtype=jnp.int32)
    x0 = jnp.full((S, 1), 40.0)
    y0 = jnp.full((S, 1), -1.75)
    zeros = jnp.zeros((S, 1))
    xt, yt, _ = jax.vmap(
        lambda a, b, c, d, e: constant_velocity_obstacles(a, b, c, d, e,
                                                          ws.tot_time)
    )(x0, y0, zeros, zeros, zeros)

    init_state = jnp.asarray([0.0, 1.75, 5.0, 0.0, 0.0, 0.0])
    mean = jnp.asarray([15.0] * 4 + [0.0] * 4)
    cov = jnp.asarray(np.diag([20.0] * 4 + [100.0] * 4), jnp.float32)

    seeds = jax.device_put(seeds, NamedSharding(mesh, P(SCENARIO_AXIS)))
    xt = jax.device_put(xt, NamedSharding(mesh, P(SCENARIO_AXIS)))
    yt = jax.device_put(yt, NamedSharding(mesh, P(SCENARIO_AXIS)))

    out = sweep(seeds, init_state, mean, cov, xt, yt, 15.0)
    out.cx.block_until_ready()
    assert out.cx.shape == (S, cfg.horizon.nvar)
    assert bool(jnp.all(jnp.isfinite(out.cx))), "non-finite solve output"

    stats = sweep_statistics(cfg, mesh)
    risk = jax.device_put(out.risk_obs, NamedSharding(mesh, P(SCENARIO_AXIS)))
    n_acc, mean_r, max_r = stats(risk, jnp.float32(1.0e9))
    assert int(n_acc) == S

    # mesh-sharded MC validator on the sweep outputs (the multi-device
    # sweep -> validate shape, BASELINE config 5)
    validator = sharded_validator(cfg, ws, n_mc=8, mesh=mesh)
    vstats, coll_total, lane_total = validator(
        out.cx, out.cy, init_state, xt, yt, jax.random.PRNGKey(0))
    assert vstats.coll_count.shape == (S,)
    assert int(coll_total) == int(jnp.sum(vstats.coll_count))

    # latency mode: candidate axis of ONE solve sharded over the mesh
    from ..solver import Solver
    cmesh = Mesh(np.asarray(jax.devices()[:n_devices]), ("candidates",))
    s_lat = Solver(cfg, ws, candidate_mesh=cmesh)
    r = s_lat.solve(0, init_state, mean, cov, xt[0], yt[0], 15.0)
    r.cx.block_until_ready()
    assert bool(jnp.all(jnp.isfinite(r.cx)))

    # on-road (Frenet) solver: full sharded training/solve step as well
    from ..config import onroad_workload
    from ..frenet import path_parameters

    fcfg = onroad_workload(num_reduced=2, num_obs=1, num_prime=10,
                           mode="mmd_opt")
    fcfg = fcfg.replace(cem=dataclasses.replace(fcfg.cem, maxiter_cem=2),
                        beta_cem=dataclasses.replace(fcfg.beta_cem,
                                                     maxiter=2))
    fws = build_workspace(fcfg)
    fsweep = sharded_frenet_sweep(fcfg, fws, mesh)

    num_path = fcfg.frenet.num_path
    frame = path_parameters(
        jnp.linspace(0.0, fcfg.frenet.lookahead, num_path),
        jnp.zeros(num_path))
    tot = jnp.asarray(np.linspace(0, fcfg.horizon.t_fin, fcfg.horizon.num),
                      jnp.float32)
    s_o = jnp.full((S, 1), 30.0)
    zeros_f = jnp.zeros((S, 1))
    xt_o, yt_o, _ = jax.vmap(
        lambda a, b, c, d, e: constant_velocity_obstacles(a, b, c, d, e, tot)
    )(s_o, zeros_f, zeros_f, zeros_f, zeros_f)
    init_global = jnp.asarray([0.0, 0.0, 5.0, 0.0, 0.0, 0.0], jnp.float32)

    sh = NamedSharding(mesh, P(SCENARIO_AXIS))
    fout = fsweep(jax.device_put(seeds, sh), init_global, mean, cov,
                  jax.device_put(xt_o, sh), jax.device_put(yt_o, sh),
                  jnp.float32(8.0), frame)
    fout.cx.block_until_ready()
    assert fout.cx.shape == (S, fcfg.horizon.nvar)
    assert bool(jnp.all(jnp.isfinite(fout.cx))), "non-finite frenet output"
