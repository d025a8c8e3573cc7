"""Monte-Carlo validation of a sweep's accepted solves.

Replaces ``synthetic_static_obs/validation.py`` / dynamic variant: reads a
ResultStore written by the sweep CLI, re-rolls n_mc noisy rollouts per solve
on device, and writes collision/lane statistics to a stats store.

``validate_compare`` implements the reference's config-intersection step
(validation.py:284-304): the (init_state || x_obs || y_obs || vx_obs ||
vy_obs) row of each accepted solve is the scenario key, keys are intersected
across all modes, and only the common scenarios are validated — so mmd and
cvar box plots compare the SAME scenario set.  Stats land in the reference's
layout (validation.py:459-464):
``stats/{noise}_noise/noise_{lvl}/ts_{np}/{N}_samples_{M}_obs.npz`` with
``coll_{mode}`` / ``coll_{mode}_lane`` arrays, which cli/report.py's grid
box plot consumes.

Usage:
    python -m mpc_mmd_tpu.cli.validate --data ./data/static/... --n_mc 1000
    python -m mpc_mmd_tpu.cli.validate --compare ./data/static/.../mmd_opt_* \
        ./data/static/.../cvar_* --n_mc 1000 --out ./stats
"""

from __future__ import annotations

import argparse
import json
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..config import dynamic_workload, static_workload
from ..qp import build_workspace
from ..utils.io_store import ResultStore
from ..validate import make_validator


def _build_validator(cfg, ws, n_mc: int, use_mesh: bool):
    """Single-device or mesh-sharded MC validator with a uniform signature.
    The sharded validator's per-solve results are bitwise identical to the
    single-device path (keys split globally, padding trimmed internally) —
    its psum totals are dropped here since the CLI persists per-solve
    arrays anyway."""
    if use_mesh:
        from ..parallel.mesh import sharded_validator
        inner = sharded_validator(cfg, ws, n_mc=n_mc)
        return lambda *args: inner(*args)[0]
    return make_validator(cfg, ws, n_mc=n_mc)


def validate_store(data_root: str, n_mc: int = 1000, seed: int = 0,
                   out_root: str | None = None, mesh: bool = False) -> dict:
    store = ResultStore(data_root)
    meta = store.meta
    make = static_workload if meta.get("workload", "static") == "static" \
        else dynamic_workload
    cfg = make(num_reduced=meta["num_reduced"], num_obs=meta["num_obs"],
               noise=meta["noise"], noise_level=meta["noise_level"],
               num_prime=meta["num_prime"], mode=meta["mode"])
    ws = build_workspace(cfg)
    validator = _build_validator(cfg, ws, n_mc, mesh)

    arrays = store.concatenated()
    if len(arrays.get("cx", ())) == 0:
        return {"n_solves": 0}

    stats = validator(jnp.asarray(arrays["cx"]), jnp.asarray(arrays["cy"]),
                      jnp.asarray(arrays["init_state"][0]),
                      jnp.asarray(arrays["x_obs_traj"]),
                      jnp.asarray(arrays["y_obs_traj"]),
                      jax.random.PRNGKey(seed))

    coll = np.asarray(stats.coll_count)
    lane = np.asarray(stats.lane_count)
    frac = np.asarray(stats.coll_fraction)
    out = {
        "n_solves": int(len(coll)),
        "n_mc": n_mc,
        "coll_count": coll.tolist(),
        "lane_count": lane.tolist(),
        "coll_fraction": frac.tolist(),
        "coll_pct_mean": float(np.mean(coll) / n_mc * 100.0),
        "coll_pct_p50": float(np.percentile(coll, 50) / n_mc * 100.0),
        "coll_pct_p95": float(np.percentile(coll, 95) / n_mc * 100.0),
    }
    out_root = out_root or data_root.replace("/data/", "/stats/")
    if out_root == data_root:
        out_root = os.path.join(data_root, "stats")
    os.makedirs(out_root, exist_ok=True)
    np.savez(os.path.join(out_root, "validation.npz"),
             coll_count=coll, lane_count=lane, coll_fraction=frac,
             n_mc=np.int64(n_mc),
             seeds=arrays.get("seeds", np.zeros(0)))
    with open(os.path.join(out_root, "summary.json"), "w") as f:
        json.dump({k: v for k, v in out.items()
                   if not isinstance(v, list)}, f, indent=1)
    return out


def scenario_keys(arrays: dict, num_obs: int) -> list:
    """Per-solve scenario key rows (validation.py:284-295): hstack of
    init_state and the obstacle config, hashed as float tuples."""
    mat = np.hstack([
        np.asarray(arrays["init_state"], np.float64),
        np.asarray(arrays["x_obs"], np.float64)[:, :num_obs],
        np.asarray(arrays["y_obs"], np.float64)[:, :num_obs],
        np.asarray(arrays["vx_obs"], np.float64)[:, :num_obs],
        np.asarray(arrays["vy_obs"], np.float64)[:, :num_obs],
    ])
    return [tuple(row) for row in mat]


def intersect_stores(all_arrays: list, num_obs: int) -> list:
    """Row indices per store covering exactly the scenarios accepted by
    EVERY store (set intersection, first occurrence wins on duplicates —
    validation.py:296-325).  Returns one index array per input; all outputs
    have equal length and row i of each refers to the same scenario."""
    key_lists = [scenario_keys(a, num_obs) for a in all_arrays]
    common = set(key_lists[0])
    for keys in key_lists[1:]:
        common &= set(keys)
    # Deterministic scenario order: sort the key tuples.
    common = sorted(common)
    out = []
    for keys in key_lists:
        first = {}
        for i, k in enumerate(keys):
            first.setdefault(k, i)
        out.append(np.asarray([first[k] for k in common], np.int64))
    return out


def paired_stats(a: np.ndarray, b: np.ndarray, n_boot: int = 10000,
                 seed: int = 0) -> dict:
    """Paired significance of collision-count samples ``a`` vs ``b`` over
    the SAME scenarios (the intersection join preserves pairing, so a
    paired test is the statistically correct comparison — the reference's
    box plots eyeball unpaired means, plot_box_plots.py:116).

    Returns the Wilcoxon signed-rank p-value (two-sided; ties/zeros split,
    p=1.0 when every pair is tied) and a seeded percentile-bootstrap 95% CI
    on mean(a - b).  mean_diff < 0 with ci95 excluding 0 means ``a``
    (convention: mmd_opt) beats ``b`` significantly.
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"paired arrays must match: {a.shape} vs {b.shape}")
    d = a - b
    out = {"n": int(len(d)), "mean_diff": float(np.mean(d)),
           "p50_diff": float(np.median(d))}
    try:
        from scipy.stats import wilcoxon
        if np.all(d == 0):
            out["p_wilcoxon"] = 1.0
        else:
            # zsplit: zero-differences split between ranks (keeps n honest
            # when many scenarios are collision-free under both modes)
            out["p_wilcoxon"] = float(
                wilcoxon(a, b, zero_method="zsplit",
                         alternative="two-sided").pvalue)
    except ImportError:                      # pragma: no cover
        out["p_wilcoxon"] = None
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, len(d), size=(n_boot, len(d)))
    boot_means = np.mean(d[idx], axis=1)
    lo, hi = np.percentile(boot_means, [2.5, 97.5])
    out["mean_diff_ci95"] = [float(lo), float(hi)]
    out["significant_05"] = bool(out["p_wilcoxon"] is not None
                                 and out["p_wilcoxon"] < 0.05)
    return out


def validate_compare(data_roots: list, n_mc: int = 1000, seed: int = 0,
                     out_root: str = "./stats", mesh: bool = False,
                     labels: list | None = None) -> dict:
    """Joint validation of one scenario config swept under several modes.

    All stores must share (workload, noise, noise_level, num_reduced,
    num_obs, num_prime); the mode differs.  Writes the reference's stats
    npz (validation.py:459-464) and returns the per-mode collision arrays.

    ``labels`` overrides the per-store array labels (default: each store's
    mode).  Required when two stores share a mode — e.g. certifying a
    reduced-budget "realtime" mmd_opt sweep against the default-budget one,
    where both stores are mmd_opt and the npz keys would collide.
    """
    stores = [ResultStore(r) for r in data_roots]
    metas = [s.meta for s in stores]
    base = metas[0]
    for m in metas[1:]:
        for k in ("workload", "noise", "noise_level", "num_reduced",
                  "num_obs", "num_prime"):
            if m.get(k) != base.get(k):
                raise ValueError(f"store mismatch on {k}: "
                                 f"{m.get(k)} != {base.get(k)}")
    if labels is None:
        labels = [m["mode"] for m in metas]
    if len(labels) != len(stores):
        raise ValueError(f"{len(labels)} labels for {len(stores)} stores")
    if len(set(labels)) != len(labels):
        raise ValueError(f"duplicate labels {labels}; pass explicit "
                         "--labels to disambiguate same-mode stores")
    num_obs = base["num_obs"]
    all_arrays = [s.concatenated() for s in stores]
    if any(len(a.get("cx", ())) == 0 for a in all_arrays):
        return {"n_common": 0}
    joins = intersect_stores(all_arrays, num_obs)
    n_common = len(joins[0])
    if n_common == 0:
        return {"n_common": 0}

    make = static_workload if base.get("workload", "static") == "static" \
        else dynamic_workload
    out = {"n_common": int(n_common), "n_mc": n_mc, "modes": {}}
    npz_payload = {}
    for label, meta, arrays, idx in zip(labels, metas, all_arrays, joins):
        cfg = make(num_reduced=meta["num_reduced"], num_obs=meta["num_obs"],
                   noise=meta["noise"], noise_level=meta["noise_level"],
                   num_prime=meta["num_prime"], mode=meta["mode"])
        ws = build_workspace(cfg)
        validator = _build_validator(cfg, ws, n_mc, mesh)
        stats = validator(jnp.asarray(arrays["cx"][idx]),
                          jnp.asarray(arrays["cy"][idx]),
                          jnp.asarray(arrays["init_state"][0]),
                          jnp.asarray(arrays["x_obs_traj"][idx]),
                          jnp.asarray(arrays["y_obs_traj"][idx]),
                          jax.random.PRNGKey(seed))
        coll = np.asarray(stats.coll_count)
        lane = np.asarray(stats.lane_count)
        mode = label
        npz_payload[f"coll_{mode}"] = coll
        npz_payload[f"coll_{mode}_lane"] = lane
        # store-row index of each joined scenario: lets reporting map a
        # paired-stats row back to the solve in the mode's ResultStore
        # (e.g. the reference's cherry-picked trajectory videos,
        # plot_traj_video.py:285)
        npz_payload[f"idx_{mode}"] = idx
        out["modes"][mode] = {
            "coll_pct_mean": float(np.mean(coll) / n_mc * 100.0),
            "coll_pct_p50": float(np.percentile(coll, 50) / n_mc * 100.0),
            "coll_pct_p95": float(np.percentile(coll, 95) / n_mc * 100.0),
            "lane_mean": float(np.mean(lane)),
        }

    # Paired significance for every mode pair (VERDICT r2 item 3): the join
    # gives aligned per-scenario samples, so Wilcoxon signed-rank + a
    # bootstrap CI on the mean difference settle "MMD beats CVaR" properly
    # instead of eyeballing means.
    modes_list = list(labels)
    out["pairs"] = {}
    for i in range(len(modes_list)):
        for j in range(i + 1, len(modes_list)):
            mi, mj = modes_list[i], modes_list[j]
            out["pairs"][f"{mi}_vs_{mj}"] = paired_stats(
                npz_payload[f"coll_{mi}"], npz_payload[f"coll_{mj}"],
                seed=seed)

    # round(), not int(): 0.29 * 100 == 28.999... and int() would mislabel
    # the directory (the reference's validation.py:459 layout says 29)
    stats_dir = os.path.join(
        out_root, f"{base['noise']}_noise",
        f"noise_{round(base['noise_level'] * 100)}",
        f"ts_{base['num_prime']}")
    os.makedirs(stats_dir, exist_ok=True)
    stats_path = os.path.join(
        stats_dir, f"{base['num_reduced']}_samples_{num_obs}_obs.npz")
    # The stats layout (mirroring the reference's) does not encode the
    # workload; static and dynamic runs with identical knobs would silently
    # truncate each other's npz.  Refuse instead — use distinct --out roots
    # per workload (as artifacts/acceptance/ does: stats/ vs stats_dynamic/).
    workload = base.get("workload", "static")
    sidecar = stats_path.replace(".npz", ".json")
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            prev = json.load(f)
        if prev.get("workload", workload) != workload:
            raise ValueError(
                f"{stats_path} already holds {prev['workload']!r} stats; "
                f"pass a different --out root for the {workload!r} workload")
    out["workload"] = workload
    # n_mc rides in the npz so readers scale counts by the value actually
    # used at validation time, not a caller-supplied guess
    npz_payload["n_mc"] = np.int64(n_mc)
    np.savez(stats_path, **npz_payload)
    out["stats_path"] = stats_path
    with open(sidecar, "w") as f:
        json.dump(out, f, indent=1)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data", type=str, nargs="+", required=True)
    p.add_argument("--compare", action="store_true",
                   help="intersect scenarios across the given stores and "
                        "write paired stats (reference validation.py:284)")
    p.add_argument("--n_mc", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--mesh", action="store_true",
                   help="shard the MC validation over the device mesh "
                        "(per-solve results bitwise identical)")
    p.add_argument("--labels", type=str, nargs="+", default=None,
                   help="per-store array labels for --compare (default: "
                        "each store's mode; required when stores share one)")
    args = p.parse_args(argv)
    # warm-start from the persistent XLA cache
    from ..utils.compilation_cache import enable_persistent_cache
    enable_persistent_cache()
    if args.compare:
        out = validate_compare(args.data, args.n_mc, args.seed,
                               args.out or "./stats", mesh=args.mesh,
                               labels=args.labels)
        print(json.dumps(out, indent=1))
    else:
        for root in args.data:
            out = validate_store(root, args.n_mc, args.seed, args.out,
                                 mesh=args.mesh)
            print(json.dumps({k: v for k, v in out.items()
                              if not isinstance(v, list)}, indent=1))


if __name__ == "__main__":
    main()
