"""ResultStore resume semantics + end-to-end sweep/validate/report CLI."""

import dataclasses
import json
import os

import numpy as np
import pytest

from mpc_mmd_tpu.utils.io_store import ResultStore
from mpc_mmd_tpu.utils.observability import MetricLogger, phase_timer


def test_store_roundtrip(tmp_path):
    store = ResultStore(str(tmp_path / "s"), meta={"mode": "cvar"})
    store.write_chunk(0, a=np.arange(5), b=np.ones((5, 2)))
    store.write_chunk(2, a=np.arange(3), b=np.zeros((3, 2)))
    assert store.done_chunks() == [0, 2]
    assert store.is_done(0) and not store.is_done(1)
    out = store.read_chunk(2)
    np.testing.assert_array_equal(out["a"], np.arange(3))
    cat = store.concatenated()
    assert cat["a"].shape == (8,)


def test_store_resume(tmp_path):
    root = str(tmp_path / "s")
    ResultStore(root, meta={"x": 1}).write_chunk(0, a=np.ones(2))
    # reopen: manifest survives, chunk 0 done
    store2 = ResultStore(root, meta={"x": 1})
    assert store2.is_done(0)
    with pytest.raises(ValueError):
        ResultStore(root, meta={"x": 2})


def test_store_extent_growth(tmp_path):
    """num_configs is sweep EXTENT, not scenario identity: extending a
    200-config sweep to 600 reopens the store (chunk contents are seeded
    per config) and bumps the recorded extent; identity keys still refuse
    to mix."""
    root = str(tmp_path / "s")
    ResultStore(root, meta={"mode": "cvar", "num_configs": 200}).write_chunk(
        0, a=np.ones(2))
    s2 = ResultStore(root, meta={"mode": "cvar", "num_configs": 600})
    assert s2.is_done(0) and s2.meta["num_configs"] == 600
    # shrinking keeps the max seen
    s3 = ResultStore(root, meta={"mode": "cvar", "num_configs": 100})
    assert s3.meta["num_configs"] == 600
    with pytest.raises(ValueError):
        ResultStore(root, meta={"mode": "saa", "num_configs": 600})


def test_store_multiprocess_shards(tmp_path):
    """Multi-host write isolation (io_store docstring claim): each process
    writes only its own chunk files + manifest; readers merge all process
    manifests; ownership is enforced on write."""
    root = str(tmp_path / "s")
    meta = {"mode": "cvar"}
    s0 = ResultStore(root, meta=meta, process_id=0, num_processes=2)
    s1 = ResultStore(root, meta=meta, process_id=1, num_processes=2)
    assert s0.owns(0) and s0.owns(2) and not s0.owns(1)
    assert s1.owns(1) and not s1.owns(0)
    s0.write_chunk(0, a=np.zeros(2))
    s1.write_chunk(1, a=np.ones(3))
    s0.write_chunk(2, a=np.full(1, 2.0))
    with pytest.raises(ValueError):        # not the owner
        s0.write_chunk(1, a=np.zeros(1))
    with pytest.raises(ValueError):
        ResultStore(root, meta=meta, process_id=2, num_processes=2)
    # no shared files: distinct manifests + chunk names
    files = set(os.listdir(root))
    assert {"manifest.json", "manifest_p001.json", "chunk_00000.npz",
            "chunk_p001_00001.npz", "chunk_00002.npz"} <= files
    # merged reads from either handle
    for s in (s0, s1):
        assert s.done_chunks() == [0, 1, 2]
        assert s.is_done(1)
    cat = s0.concatenated()
    np.testing.assert_array_equal(cat["a"], [0, 0, 1, 1, 1, 2])
    # meta mismatch across manifests is refused at read time
    s_bad = ResultStore(str(tmp_path / "t"), meta={"mode": "saa"},
                        process_id=0, num_processes=2)
    import shutil
    shutil.copy(os.path.join(root, "manifest_p001.json"),
                os.path.join(str(tmp_path / "t"), "manifest_p001.json"))
    with pytest.raises(ValueError):
        s_bad.done_chunks()


def test_store_peer_cache_sees_fresh_writes(tmp_path):
    """The peer-manifest mtime cache (ADVICE r3) must never serve stale
    state: a peer chunk landing after the cache is populated shows up on
    the next is_done/done_chunks call."""
    root = str(tmp_path / "s")
    meta = {"mode": "cvar"}
    s0 = ResultStore(root, meta=meta, process_id=0, num_processes=2)
    s1 = ResultStore(root, meta=meta, process_id=1, num_processes=2)
    s1.write_chunk(1, a=np.ones(1))
    assert s0.is_done(1)              # populates s0's peer cache
    assert not s0.is_done(3)
    s1.write_chunk(3, a=np.ones(1))   # peer manifest rewritten on disk
    assert s0.is_done(3)              # mtime bump invalidates the cache
    # cache hit path: repeated queries parse the peer manifest once
    assert s0.done_chunks() == [1, 3]
    assert s0.done_chunks() == [1, 3]


def test_animation_writer_mp4_selection(tmp_path):
    """MP4 parity with the reference's plot_traj_video.py: FFMpegWriter when
    ffmpeg exists, honest GIF fallback otherwise; plain .gif untouched."""
    from matplotlib import animation

    from mpc_mmd_tpu.cli.report import _animation_writer

    out, w = _animation_writer(str(tmp_path / "ep.gif"), fps=5)
    assert out.endswith("ep.gif") and isinstance(w, animation.PillowWriter)

    out, w = _animation_writer(str(tmp_path / "ep.mp4"), fps=5)
    if animation.FFMpegWriter.isAvailable():
        assert out.endswith("ep.mp4")
        assert isinstance(w, animation.FFMpegWriter)
    else:
        assert out.endswith("ep.gif")
        assert isinstance(w, animation.PillowWriter)


def test_metric_logger(tmp_path):
    path = str(tmp_path / "m.jsonl")
    logger = MetricLogger(path)
    with phase_timer(logger, "work", tag=1):
        pass
    logger.log("solve", cost=np.float32(1.5))
    recs = [json.loads(line) for line in open(path)]
    assert recs[0]["event"] == "phase" and recs[0]["phase"] == "work"
    assert recs[1]["cost"] == pytest.approx(1.5)


def test_dynamic_workload_sweep(tmp_path, monkeypatch):
    """Tiny dynamic-workload sweep: cut-in obstacle trajectories + beta
    noise + K_steer=0.05 end-to-end through the sweep CLI path."""
    import dataclasses as _dc
    import mpc_mmd_tpu.cli.sweep as sweep_cli
    import mpc_mmd_tpu.config as config_mod

    orig_dyn = config_mod.dynamic_workload

    def tiny_dyn(**kw):
        cfg = orig_dyn(**kw)
        return cfg.replace(cem=_dc.replace(cfg.cem, maxiter_cem=2))

    monkeypatch.setattr(sweep_cli, "dynamic_workload", tiny_dyn)
    store = sweep_cli.run_sweep(
        workload="dynamic", mode="cvar", noise="beta", noise_level=0.2,
        num_reduced=3, num_obs=2, num_prime=15, num_configs=4,
        out_root=str(tmp_path / "data"), chunk=2)
    arrays = store.concatenated()
    # at least one config must clear the acceptance threshold, else the
    # substantive checks below would be skipped silently
    assert len(arrays.get("cx", ())) >= 1
    # obstacle trajectories are the QP-generated cut-in paths (moving)
    xt = arrays["x_obs_traj"]
    assert np.any(np.abs(xt[..., -1] - xt[..., 0]) > 1.0)
    assert np.all(np.isfinite(arrays["cx"]))


def test_sweep_heartbeat_abort_is_resumable(tmp_path, monkeypatch):
    """Failure detection in the sweep loop (SURVEY §5): a failed heartbeat
    aborts cleanly with completed chunks persisted; a healthy rerun
    resumes and finishes."""
    import dataclasses as _dc
    import mpc_mmd_tpu.cli.sweep as sweep_cli
    import mpc_mmd_tpu.config as config_mod

    orig_static = config_mod.static_workload

    def tiny_static(**kw):
        cfg = orig_static(**kw)
        return cfg.replace(cem=_dc.replace(cfg.cem, maxiter_cem=2))

    monkeypatch.setattr(sweep_cli, "static_workload", tiny_static)

    # heartbeat dead from the start -> immediate clean abort, nothing solved
    monkeypatch.setattr(sweep_cli, "hosts_alive", lambda t: False)
    out = str(tmp_path / "data")
    kw = dict(workload="static", mode="cvar", noise="gaussian",
              noise_level=0.1, num_reduced=3, num_obs=2, num_prime=15,
              num_configs=4, out_root=out, chunk=2)
    with pytest.raises(sweep_cli.HostFailure):
        sweep_cli.run_sweep(**kw, heartbeat_every=1)

    # hosts healthy again -> the same sweep resumes and completes
    monkeypatch.setattr(sweep_cli, "hosts_alive", lambda t: True)
    store = sweep_cli.run_sweep(**kw, heartbeat_every=1)
    assert store.done_chunks() == [0, 1]


def _fake_arrays(rows):
    """Build a minimal store-arrays dict whose scenario key is determined by
    the integer rows: row r -> obstacles at (r, r+1) etc."""
    n = len(rows)
    r = np.asarray(rows, np.float64)[:, None]
    return {
        "init_state": np.tile(np.arange(6.0), (n, 1)),
        "x_obs": np.hstack([r, r + 1.0]),
        "y_obs": np.hstack([-r, r]),
        "vx_obs": np.zeros((n, 2)),
        "vy_obs": np.zeros((n, 2)),
    }


def test_intersect_stores_join():
    """Config-intersection semantics of validation.py:284-325: common
    scenarios only, aligned rows, first occurrence wins on duplicates."""
    from mpc_mmd_tpu.cli.validate import intersect_stores, scenario_keys

    a = _fake_arrays([0, 1, 2])
    b = _fake_arrays([1, 3, 2, 1])          # scenario 1 duplicated
    ia, ib = intersect_stores([a, b], num_obs=2)
    assert len(ia) == len(ib) == 2           # common scenarios {1, 2}
    ka = scenario_keys(a, 2)
    kb = scenario_keys(b, 2)
    for x, y in zip(ia, ib):                 # joined rows refer to the same scenario
        assert ka[x] == kb[y]
    assert 3 not in set(ib.tolist()) or kb[3] != kb[0]  # dup -> first index used
    assert set(ib.tolist()) <= {0, 1, 2}


def test_validate_compare_and_grid(tmp_path, monkeypatch):
    """Two-mode sweep -> intersection validate -> reference-layout stats npz
    -> grid box plot."""
    import mpc_mmd_tpu.cli.sweep as sweep_cli
    import mpc_mmd_tpu.cli.validate as validate_cli
    import mpc_mmd_tpu.cli.report as report_cli
    import mpc_mmd_tpu.config as config_mod

    orig_static = config_mod.static_workload

    def tiny_static(**kw):
        cfg = orig_static(**kw)
        return cfg.replace(cem=dataclasses.replace(cfg.cem, maxiter_cem=2))

    monkeypatch.setattr(sweep_cli, "static_workload", tiny_static)
    monkeypatch.setattr(validate_cli, "static_workload", tiny_static)

    out = str(tmp_path / "data")
    roots = []
    for mode in ("cvar", "saa"):
        store = sweep_cli.run_sweep(
            workload="static", mode=mode, noise="gaussian", noise_level=0.1,
            num_reduced=3, num_obs=2, num_prime=15, num_configs=4,
            out_root=out, chunk=2)
        roots.append(store.root)

    stats_root = str(tmp_path / "stats")
    res = validate_cli.validate_compare(roots, n_mc=50, out_root=stats_root)
    assert res["n_common"] >= 1
    assert set(res["modes"]) == {"cvar", "saa"}
    # paired significance rides in the result + sidecar
    assert "cvar_vs_saa" in res["pairs"]
    ps = res["pairs"]["cvar_vs_saa"]
    assert ps["n"] == res["n_common"]
    assert 0.0 <= ps["p_wilcoxon"] <= 1.0
    sidecar = json.load(open(res["stats_path"].replace(".npz", ".json")))
    assert "pairs" in sidecar
    with np.load(res["stats_path"]) as z:
        assert z["coll_cvar"].shape == z["coll_saa"].shape == \
            (res["n_common"],)
        assert "coll_cvar_lane" in z
    fig = report_cli.grid_boxplot(
        stats_root, "gaussian", [0.1], [3], 2, 15, 50,
        str(tmp_path / "grid.png"), modes=("cvar", "saa"))
    assert os.path.exists(fig)

    # cherry-pick map (plot_traj_video.py:285): idx_{mode} maps paired rows
    # back to store rows; a fully-permissive pick selects every joined row
    picks = report_cli.pick_showcase_solves(
        res["stats_path"], "cvar", "saa", other_min=0, self_max=10 ** 9)
    assert len(picks) == res["n_common"]
    fig2 = report_cli.trajectories(roots[0], str(tmp_path / "pick.png"),
                                   n_mc=10, n_solves=2,
                                   solve_indices=picks)
    assert os.path.exists(fig2)


def test_sweep_validate_report_end_to_end(tmp_path, monkeypatch):
    """Tiny full pipeline: sweep -> validate -> boxplot + trajectory figure."""
    import mpc_mmd_tpu.cli.sweep as sweep_cli
    import mpc_mmd_tpu.cli.validate as validate_cli
    import mpc_mmd_tpu.cli.report as report_cli
    import mpc_mmd_tpu.config as config_mod

    # shrink the solver for test speed
    orig_static = config_mod.static_workload

    def tiny_static(**kw):
        cfg = orig_static(**kw)
        return cfg.replace(cem=dataclasses.replace(cfg.cem, maxiter_cem=2))

    monkeypatch.setattr(sweep_cli, "static_workload", tiny_static)
    monkeypatch.setattr(validate_cli, "static_workload", tiny_static)

    out = str(tmp_path / "data")
    store = sweep_cli.run_sweep(
        workload="static", mode="cvar", noise="gaussian", noise_level=0.1,
        num_reduced=3, num_obs=2, num_prime=15, num_configs=4,
        out_root=out, chunk=2)
    n_acc = sum(len(a["cx"]) for _, a in store.iter_chunks())
    assert n_acc >= 1, "no accepted solves in tiny sweep"

    # resume: re-running skips all chunks (count of chunk files unchanged)
    store2 = sweep_cli.run_sweep(
        workload="static", mode="cvar", noise="gaussian", noise_level=0.1,
        num_reduced=3, num_obs=2, num_prime=15, num_configs=4,
        out_root=out, chunk=2)
    assert store2.done_chunks() == store.done_chunks()

    stats_dir = os.path.join(store.root, "stats")
    stats = validate_cli.validate_store(store.root, n_mc=50,
                                        out_root=stats_dir)
    assert stats["n_solves"] == n_acc
    assert 0.0 <= stats["coll_pct_mean"] <= 100.0
    # --mesh validation path produces identical per-solve counts
    stats_m = validate_cli.validate_store(store.root, n_mc=50,
                                          out_root=os.path.join(
                                              store.root, "stats_mesh"),
                                          mesh=True)
    assert stats_m["coll_count"] == stats["coll_count"]
    fig1 = report_cli.boxplot([stats_dir], ["cvar"], 50,
                              str(tmp_path / "box.png"))
    assert os.path.exists(fig1)
    fig2 = report_cli.trajectories(store.root, str(tmp_path / "traj.png"),
                                   n_mc=20, n_solves=1)
    assert os.path.exists(fig2)
    gif = report_cli.animate(store.root, str(tmp_path / "traj.gif"), n_mc=10)
    assert os.path.exists(gif)


def test_paired_stats():
    """Wilcoxon + bootstrap on paired collision counts: a systematic shift
    is significant with a CI excluding zero; identical samples give p=1."""
    from mpc_mmd_tpu.cli.validate import paired_stats

    rng = np.random.default_rng(3)
    base = rng.poisson(30, size=80).astype(float)
    shifted = base + rng.poisson(8, size=80)       # b systematically worse
    s = paired_stats(base, shifted)
    assert s["p_wilcoxon"] < 1e-6 and s["significant_05"]
    assert s["mean_diff"] < 0
    assert s["mean_diff_ci95"][1] < 0.0            # CI excludes zero

    same = paired_stats(base, base.copy())
    assert same["p_wilcoxon"] == 1.0 and not same["significant_05"]
    assert same["mean_diff"] == 0.0

    # pure noise: not significant (sanity against false positives)
    noise = paired_stats(base, base + rng.normal(0, 0.5, 80).round())
    assert noise["p_wilcoxon"] > 0.01

    with pytest.raises(ValueError):
        paired_stats(base, base[:-1])


def test_sweep_and_stats_noise_dirs_agree(tmp_path, monkeypatch):
    """noise_level=0.29: 0.29*100 == 28.999..., so int() would tag the sweep
    noise_28/ while the stats layout (cli/validate.py, round()) writes
    noise_29/.  Both sides must round()."""
    import dataclasses as _dc
    import mpc_mmd_tpu.cli.sweep as sweep_cli
    import mpc_mmd_tpu.cli.validate as validate_cli
    import mpc_mmd_tpu.config as config_mod

    orig_stat = config_mod.static_workload

    def tiny_stat(**kw):
        cfg = orig_stat(**kw)
        return cfg.replace(cem=dataclasses.replace(cfg.cem, maxiter_cem=2))

    monkeypatch.setattr(sweep_cli, "static_workload", tiny_stat)
    monkeypatch.setattr(validate_cli, "static_workload", tiny_stat)
    roots = []
    for mode in ("cvar", "saa"):
        store = sweep_cli.run_sweep(
            workload="static", mode=mode, noise="gaussian", noise_level=0.29,
            num_reduced=3, num_obs=2, num_prime=15, num_configs=2,
            out_root=str(tmp_path / "data"), chunk=2)
        assert "/noise_29/" in store.root.replace("\\", "/")
        roots.append(store.root)
    res = validate_cli.validate_compare(roots, n_mc=20,
                                        out_root=str(tmp_path / "stats"))
    if res["n_common"]:          # stats path only exists when scenarios join
        assert "/noise_29/" in res["stats_path"].replace("\\", "/")


def test_compare_same_mode_stores_with_labels(tmp_path, monkeypatch):
    """Certification shape: two mmd-family stores of the SAME mode but
    different inner-CEM budgets join under explicit labels (npz keys
    coll_{label}); duplicate labels are refused."""
    import dataclasses as _dc
    import mpc_mmd_tpu.cli.sweep as sweep_cli
    import mpc_mmd_tpu.cli.validate as validate_cli
    import mpc_mmd_tpu.config as config_mod

    orig_stat = config_mod.static_workload

    def tiny_stat(**kw):
        cfg = orig_stat(**kw)
        return cfg.replace(cem=dataclasses.replace(cfg.cem, maxiter_cem=2))

    monkeypatch.setattr(sweep_cli, "static_workload", tiny_stat)
    monkeypatch.setattr(validate_cli, "static_workload", tiny_stat)
    kw = dict(workload="static", mode="cvar", noise="gaussian",
              noise_level=0.1, num_reduced=3, num_obs=2, num_prime=15,
              num_configs=3, out_root=str(tmp_path / "data"), chunk=3)
    r_def = sweep_cli.run_sweep(**kw)
    r_rt = sweep_cli.run_sweep(**kw, inner_budget=(8, 2))
    assert r_rt.root != r_def.root and "_S8x2_" in r_rt.root
    assert r_rt.meta["inner_budget"] == [8, 2]
    r_fast = sweep_cli.run_sweep(**kw, outer_budget=(16, 2))
    assert "_B16x2_" in r_fast.root
    assert r_fast.meta["outer_budget"] == [16, 2]

    with pytest.raises(ValueError, match="duplicate labels"):
        validate_cli.validate_compare([r_def.root, r_rt.root], n_mc=10,
                                      out_root=str(tmp_path / "s0"))
    res = validate_cli.validate_compare(
        [r_def.root, r_rt.root], n_mc=10, out_root=str(tmp_path / "s1"),
        labels=["default", "realtime"])
    if res["n_common"]:
        assert set(res["modes"]) == {"default", "realtime"}
        assert "default_vs_realtime" in res["pairs"]
        with np.load(res["stats_path"]) as z:
            assert "coll_default" in z and "coll_realtime" in z


@pytest.mark.parametrize("env_set", [True, False])
def test_persistent_cache_placement(monkeypatch, tmp_path, env_set):
    """On the GPU the cache lands in $JAX_COMPILATION_CACHE_DIR when it is
    set and in the fixed <repo>/.jax_cache otherwise."""
    import os

    import jax

    from mpc_mmd_tpu.utils import compilation_cache as cc

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = str(tmp_path / "cache")
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert cc.cache_dir() == os.path.join(repo, ".jax_cache")
        # enable below creates the directory: point the default elsewhere
        monkeypatch.setattr(cc, "DEFAULT_DIR", want)
    assert cc.cache_dir() == want

    updates = {}
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.__setitem__(k, v))
    assert cc.enable_persistent_cache() == want
    assert updates["jax_compilation_cache_dir"] == want
    assert os.path.isdir(want)


def test_persistent_cache_off_on_cpu(monkeypatch, tmp_path):
    """The CPU backend stays uncached: XLA:CPU AOT entries are keyed loosely
    enough to load under a mismatched host CPU feature set (SIGILL risk)."""
    from mpc_mmd_tpu.utils import compilation_cache as cc

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    assert cc.enable_persistent_cache() == ""
    assert not (tmp_path / "cache").exists()


def test_sweep_dispatch_pipeline_matches_batch(tmp_path, monkeypatch):
    """Per-scenario async dispatch ("pipeline", the default) persists the
    same sweep results as the one-program solve_batch path ("batch"):
    identical accepted seeds, matching coefficients/risks to vmap-vs-single
    rounding."""
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
              num_configs=4, chunk=2)
    a = sweep_cli.run_sweep(**kw, out_root=str(tmp_path / "pipe"),
                            dispatch="pipeline").concatenated()
    b = sweep_cli.run_sweep(**kw, out_root=str(tmp_path / "batch"),
                            dispatch="batch").concatenated()
    np.testing.assert_array_equal(a["seeds"], b["seeds"])
    # solve QUALITY, not coefficients: tied candidate costs (all-clear
    # scenarios) legitimately flip the winning candidate between the vmap
    # and single-solve accumulation orders (see CLAUDE.md argsort-ties
    # invariant) — risk values must match, selected trajectories need not.
    np.testing.assert_allclose(a["risk_obs"], b["risk_obs"],
                               rtol=1e-3, atol=1e-3)
    assert a["cx"].shape == b["cx"].shape
    assert np.all(np.isfinite(a["cx"])) and np.all(np.isfinite(a["cy"]))


def test_sweep_kernel_variant_store_tag(tmp_path):
    """--kernel tags the store (_K{kernel}), records meta, and solves run
    the selectable-kernel path end to end (VERDICT r4 item 6 wiring)."""
    from mpc_mmd_tpu.cli import sweep as sweep_cli

    store = sweep_cli.run_sweep(
        workload="static", mode="mmd_opt", noise="gaussian", noise_level=0.1,
        num_reduced=3, num_obs=2, num_prime=15, num_configs=2, chunk=2,
        out_root=str(tmp_path), kernel="gaussian")
    assert "_Kgaussian_" in store.root.replace(str(tmp_path), "")
    assert store.meta["kernel"] == "gaussian"
    a = store.concatenated()
    assert np.all(np.isfinite(a["cx"]))


def test_prewarm_cli(capsys):
    """The prewarm tool compiles each (preset, mode) program and reports
    per-program timings + a summary line (cold-start tooling, VERDICT r4
    weak #4)."""
    import json as _json

    from mpc_mmd_tpu.cli import prewarm as prewarm_cli

    prewarm_cli.main(["--presets", "fastrt", "--modes", "cvar",
                      "--num_reduced", "3", "--num_obs", "2",
                      "--num_prime", "15"])
    lines = [l for l in capsys.readouterr().out.splitlines() if l.strip()]
    recs = [_json.loads(l) for l in lines]
    assert recs[0]["preset"] == "fastrt" and recs[0]["mode"] == "cvar"
    assert recs[-1]["prewarmed"] == 1 and recs[-1]["total_s"] >= 0
