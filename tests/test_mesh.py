"""Multi-device sharding: sweep over an 8-device virtual CPU mesh."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from mpc_mmd_tpu.config import static_workload
from mpc_mmd_tpu.parallel.mesh import (SCENARIO_AXIS, dryrun, make_mesh,
                                       sharded_sweep, sweep_statistics)
from mpc_mmd_tpu.qp import build_workspace
from mpc_mmd_tpu.scenarios import ego_initial_state, static_grid


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    return make_mesh(8)


def tiny_cfg():
    cfg = static_workload(num_reduced=3, num_obs=2, num_prime=15, mode="cvar")
    return cfg.replace(cem=dataclasses.replace(cfg.cem, maxiter_cem=2))


def test_sharded_sweep_runs_and_is_sharded(mesh):
    cfg = tiny_cfg()
    ws = build_workspace(cfg)
    sweep = sharded_sweep(cfg, ws, mesh)
    S = 16
    batch = static_grid(cfg, S)
    init_state, mean, cov, v_des = ego_initial_state("static")
    spec = NamedSharding(mesh, P(SCENARIO_AXIS))
    seeds = jax.device_put(jnp.arange(S, dtype=jnp.int32), spec)
    xt = jax.device_put(batch.x_traj, spec)
    yt = jax.device_put(batch.y_traj, spec)
    out = sweep(seeds, init_state, mean, cov, xt, yt, v_des)
    assert out.cx.shape == (S, 11)
    assert np.all(np.isfinite(np.asarray(out.cx)))
    # output actually sharded over the mesh
    assert len(out.cx.sharding.device_set) == 8


def test_sharded_matches_unsharded_quality(mesh):
    """Sharded solves equal single-device solves on tie-free scenarios:
    distinct non-zero obstacle costs per candidate pin the argsort order, so
    the shard_map program must match single-device solves elementwise
    (rtol 1e-3 on the full res trace and coefficients)."""
    from conftest import blocking_scenarios
    from mpc_mmd_tpu.solver import Solver
    cfg = tiny_cfg()
    ws = build_workspace(cfg)
    sweep = sharded_sweep(cfg, ws, mesh)
    S = 8
    init_state, mean, cov, v_des = ego_initial_state("static")
    xts, yts = blocking_scenarios(ws.tot_time, S)
    spec = NamedSharding(mesh, P(SCENARIO_AXIS))
    seeds = jax.device_put(jnp.arange(S, dtype=jnp.int32), spec)
    xt = jax.device_put(xts, spec)
    yt = jax.device_put(yts, spec)
    out = sweep(seeds, init_state, mean, cov, xt, yt, v_des)

    solver = Solver(cfg, ws)
    for i in [0, 3, 7]:
        r = solver.solve(i, init_state, mean, cov, xts[i], yts[i], v_des)
        assert float(r.risk_obs) > 0.0, "scenario not tie-free"
        np.testing.assert_allclose(np.asarray(out.res[i]),
                                   np.asarray(r.res), rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(np.asarray(out.cx[i]),
                                   np.asarray(r.cx), rtol=1e-3, atol=1e-3)


def test_sweep_statistics_psum(mesh):
    cfg = tiny_cfg()
    stats = sweep_statistics(cfg, mesh)
    spec = NamedSharding(mesh, P(SCENARIO_AXIS))
    risk = jax.device_put(jnp.asarray(np.arange(16, dtype=np.float32)), spec)
    n_acc, mean_r, max_r = stats(risk, jnp.float32(7.5))
    assert int(n_acc) == 8          # values 0..7 below threshold
    assert float(mean_r) == pytest.approx(7.5)
    assert float(max_r) == 15.0


def test_candidate_sharded_solve_matches_plain():
    """Latency mode: one solve's candidate axis sharded across 4 devices
    produces the same result as the unsharded solve."""
    from jax.sharding import Mesh
    from mpc_mmd_tpu.solver import Solver
    cfg = static_workload(num_reduced=3, num_obs=2, num_prime=15,
                          mode="mmd_opt")
    cfg = cfg.replace(cem=dataclasses.replace(cfg.cem, maxiter_cem=2),
                      beta_cem=dataclasses.replace(cfg.beta_cem, maxiter=2))
    cmesh = Mesh(np.array(jax.devices()[:4]), ("candidates",))
    ws = build_workspace(cfg)
    s_sh = Solver(cfg, ws, candidate_mesh=cmesh)
    s_pl = Solver(cfg, ws)
    batch = static_grid(cfg, 1)
    init_state, mean, cov, v_des = ego_initial_state("static")
    r1 = s_sh.solve(7, init_state, mean, cov, batch.x_traj[0],
                    batch.y_traj[0], v_des)
    r2 = s_pl.solve(7, init_state, mean, cov, batch.x_traj[0],
                    batch.y_traj[0], v_des)
    np.testing.assert_allclose(np.asarray(r1.res), np.asarray(r2.res),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(r1.cx), np.asarray(r2.cx),
                               atol=1e-4)


def test_sharded_validator_bitwise_matches_single(mesh):
    """Mesh-sharded MC validation equals the single-device validator
    BITWISE (keys split globally then sharded), including at a solve count
    not divisible by the mesh (internal padding), and the psum totals
    equal the host-side sums."""
    from mpc_mmd_tpu.parallel.mesh import sharded_validator
    from mpc_mmd_tpu.validate import make_validator

    cfg = tiny_cfg()
    ws = build_workspace(cfg)
    rng = np.random.default_rng(0)
    S = 11                     # not divisible by 8 -> exercises padding
    nvar = cfg.horizon.nvar
    # plausible coefficient scale (trajectories tens of meters)
    cx = jnp.asarray(rng.normal(40, 20, (S, nvar)), jnp.float32)
    cy = jnp.asarray(rng.normal(0, 1.5, (S, nvar)), jnp.float32)
    batch = static_grid(cfg, S)
    init_state, _, _, _ = ego_initial_state("static")
    key = jax.random.PRNGKey(7)

    v_single = make_validator(cfg, ws, n_mc=64)
    ref = v_single(cx, cy, init_state, batch.x_traj, batch.y_traj, key)

    v_mesh = sharded_validator(cfg, ws, n_mc=64, mesh=mesh)
    got, coll_tot, lane_tot = v_mesh(cx, cy, init_state, batch.x_traj,
                                     batch.y_traj, key)
    np.testing.assert_array_equal(np.asarray(got.coll_count),
                                  np.asarray(ref.coll_count))
    np.testing.assert_array_equal(np.asarray(got.lane_count),
                                  np.asarray(ref.lane_count))
    np.testing.assert_array_equal(np.asarray(got.coll_fraction),
                                  np.asarray(ref.coll_fraction))
    assert int(coll_tot) == int(np.sum(np.asarray(ref.coll_count)))
    assert int(lane_tot) == int(np.sum(np.asarray(ref.lane_count)))


def test_mesh_dispatch_sweep_matches_batch(tmp_path, monkeypatch):
    """cli/sweep.py --dispatch mesh: the shard_map sweep persists the same
    accepted results as the solve_batch path (risk quality parity; see the
    argsort-ties invariant for why coefficients may differ)."""
    import dataclasses as _dc
    import mpc_mmd_tpu.cli.sweep as sweep_cli
    import mpc_mmd_tpu.config as config_mod

    orig_stat = config_mod.static_workload

    def tiny_stat(**kw):
        cfg = orig_stat(**kw)
        return cfg.replace(cem=_dc.replace(cfg.cem, maxiter_cem=2))

    monkeypatch.setattr(sweep_cli, "static_workload", tiny_stat)
    kw = dict(workload="static", mode="cvar", noise="gaussian",
              noise_level=0.1, num_reduced=3, num_obs=2, num_prime=15,
              num_configs=12, chunk=6)
    a = sweep_cli.run_sweep(**kw, out_root=str(tmp_path / "mesh"),
                            dispatch="mesh").concatenated()
    b = sweep_cli.run_sweep(**kw, out_root=str(tmp_path / "batch"),
                            dispatch="batch").concatenated()
    np.testing.assert_array_equal(a["seeds"], b["seeds"])
    np.testing.assert_allclose(a["risk_obs"], b["risk_obs"],
                               rtol=1e-3, atol=1e-3)
    assert a["cx"].shape == b["cx"].shape


def test_mesh_dispatch_multiprocess_store_shards(tmp_path, monkeypatch):
    """Multi-host mesh sweep semantics simulated in-process: two "processes"
    run the same sweep command against one store root; each solves only the
    chunks it owns and writes only its own shard files; the merged store
    covers every config exactly once."""
    import dataclasses as _dc
    import os
    import mpc_mmd_tpu.cli.sweep as sweep_cli
    import mpc_mmd_tpu.config as config_mod

    orig_stat = config_mod.static_workload

    def tiny_stat(**kw):
        cfg = orig_stat(**kw)
        return cfg.replace(cem=_dc.replace(cfg.cem, maxiter_cem=2))

    monkeypatch.setattr(sweep_cli, "static_workload", tiny_stat)
    kw = dict(workload="static", mode="cvar", noise="gaussian",
              noise_level=0.1, num_reduced=3, num_obs=2, num_prime=15,
              num_configs=16, chunk=4, out_root=str(tmp_path / "data"),
              dispatch="mesh")
    stores = []
    for pid in range(2):
        monkeypatch.setattr(jax, "process_index", lambda p=pid: p)
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        stores.append(sweep_cli.run_sweep(**kw))
    monkeypatch.undo()
    # every chunk done exactly once across the union; each process only
    # wrote its own files
    assert stores[1].done_chunks() == [0, 1, 2, 3]
    files = sorted(os.listdir(stores[0].root))
    assert "chunk_00000.npz" in files and "chunk_00002.npz" in files
    assert "chunk_p001_00001.npz" in files and "chunk_p001_00003.npz" in files
    assert "manifest.json" in files and "manifest_p001.json" in files
    merged = stores[1].concatenated()
    ref = sweep_cli.run_sweep(**{**kw, "dispatch": "batch",
                                 "out_root": str(tmp_path / "ref")})
    np.testing.assert_array_equal(np.sort(merged["seeds"]),
                                  np.sort(ref.concatenated()["seeds"]))


def test_initialize_distributed_single_process():
    """Multi-host bring-up smoke test: initialize_distributed stands up the
    coordinator and returns the process index (single-process form, the
    degenerate pod).  Run in a subprocess — jax.distributed.initialize is
    process-global state that must not leak into other tests."""
    import os
    import subprocess
    import sys

    code = (
        "from mpc_mmd_tpu.parallel.mesh import initialize_distributed\n"
        "import jax\n"
        "pid = initialize_distributed('localhost:12399', 1, 0)\n"
        "assert pid == 0\n"
        "assert jax.process_count() == 1\n"
        "print('distributed-ok')\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "distributed-ok" in out.stdout


def test_initialize_distributed_two_processes(tmp_path):
    """A REAL 2-process jax.distributed mesh sweep (VERDICT r3 item 6):
    coordinator + worker subprocesses each bring up jax.distributed on the
    CPU backend (2 local devices each, 4 global), run the SAME
    `--dispatch mesh` sweep command against one shared store root — each
    process builds a process-local mesh, solves only the chunks it owns
    (cid % 2 == process_id) and writes only its own shards — then the
    parent merge-reads the store and checks every config landed exactly
    once with the same accepted set as a single-process reference run."""
    import os
    import subprocess
    import sys

    root = str(tmp_path / "data")
    code = (
        "import sys\n"
        "pid = int(sys.argv[1]); root = sys.argv[2]\n"
        "from mpc_mmd_tpu.parallel.mesh import initialize_distributed\n"
        "import jax\n"
        "assert initialize_distributed('localhost:12431', 2, pid) == pid\n"
        "assert jax.process_count() == 2\n"
        "assert jax.device_count() == 2 * jax.local_device_count()\n"
        "import dataclasses as dc\n"
        "import mpc_mmd_tpu.cli.sweep as sc\n"
        "orig = sc.static_workload\n"
        "sc.static_workload = lambda **kw: (lambda c: c.replace(\n"
        "    cem=dc.replace(c.cem, maxiter_cem=2)))(orig(**kw))\n"
        "store = sc.run_sweep(workload='static', mode='cvar',\n"
        "    noise='gaussian', noise_level=0.1, num_reduced=3, num_obs=2,\n"
        "    num_prime=15, num_configs=8, out_root=root, chunk=2,\n"
        "    dispatch='mesh')\n"
        "assert store.process_id == pid and store.num_processes == 2\n"
        "print('proc-%d-ok' % pid)\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(pid), root],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for pid in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    for pid, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid}:\n{se[-3000:]}"
        assert f"proc-{pid}-ok" in so

    # merge-read: both processes' shards present, every chunk exactly once
    from mpc_mmd_tpu.utils.io_store import ResultStore
    tag = ("static/gaussian_noise/noise_10/ts_15/"
           "cvar_3_samples_2_obs")
    merged = ResultStore(f"{root}/{tag}")
    assert merged.done_chunks() == [0, 1, 2, 3]
    files = sorted(os.listdir(merged.root))
    assert "chunk_00000.npz" in files and "chunk_p001_00001.npz" in files
    assert "manifest.json" in files and "manifest_p001.json" in files

    # totals match a single-process reference sweep (accepted set identity)
    import dataclasses as _dc
    import mpc_mmd_tpu.cli.sweep as sweep_cli
    import mpc_mmd_tpu.config as config_mod
    orig_stat = config_mod.static_workload
    sweep_cli.static_workload = lambda **kw: (
        lambda c: c.replace(cem=_dc.replace(c.cem, maxiter_cem=2)))(
            orig_stat(**kw))
    try:
        ref = sweep_cli.run_sweep(
            workload="static", mode="cvar", noise="gaussian",
            noise_level=0.1, num_reduced=3, num_obs=2, num_prime=15,
            num_configs=8, out_root=str(tmp_path / "ref"), chunk=2,
            dispatch="batch")
    finally:
        sweep_cli.static_workload = orig_stat
    got, want = merged.concatenated(), ref.concatenated()
    np.testing.assert_array_equal(np.sort(got["seeds"]),
                                  np.sort(want["seeds"]))
    assert got["cx"].shape == want["cx"].shape


def test_dryrun_entrypoint():
    dryrun(8)
