"""Closed-loop MPC episodes against the synthetic plant.

Replaces ``carla/main_carla.py``'s CLI: runs receding-horizon episodes with
the chosen risk mode (mmd_opt / cvar / det baseline), reports collision and
timing statistics, optionally renders the driven trajectory.

Usage:
    python -m mpc_mmd_tpu.cli.closedloop --mode mmd_opt --episodes 3 \
        --route curved --noise gaussian --noise_level 0.1
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..config import onroad_workload
from ..closedloop import run_episode
from ..solver_frenet import FrenetSolver


def animate_episode(result, cfg, route_kind: str, out_path: str,
                    fps: int = 10, stride: int = 2,
                    window: float = 60.0) -> str:
    """Birdview-style episode animation (GIF): ego-centered window with the
    route, obstacle safety ellipses, ego trail and heading — the synthetic
    counterpart of the reference's pygame HUD + birdeye overlay
    (carla/carla_simulation.py:251-309)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation
    from matplotlib.patches import Ellipse

    from ..closedloop import make_route

    rx, ry = make_route(route_kind)
    ego = result.ego_trace
    obs = result.obs_trace
    frames = range(0, len(ego), stride)

    fig, ax = plt.subplots(figsize=(7, 5))

    def draw(k):
        ax.clear()
        x_e, y_e = ego[k, 0], ego[k, 1]
        ax.plot(rx, ry, "k--", lw=0.7, alpha=0.6)
        ax.plot(ego[:k + 1, 0], ego[:k + 1, 1], "b-", lw=1.4)
        ax.plot(x_e, y_e, "b^", ms=9)
        if obs.shape[1]:
            for ox, oy in obs[k]:
                ax.add_patch(Ellipse((ox, oy), 2 * cfg.obstacles.a_obs,
                                     2 * cfg.obstacles.b_obs,
                                     facecolor="tab:red", alpha=0.25,
                                     edgecolor="tab:red"))
                ax.plot(ox, oy, "rs", ms=5)
        status = "COLLIDED" if (result.collided and k >= len(ego) - stride) \
            else f"v={ego[k, 2]:.1f} m/s"
        ax.set_title(f"step {k}/{len(ego)}  {status}")
        ax.set_xlim(x_e - window * 0.3, x_e + window)
        ax.set_ylim(y_e - window * 0.4, y_e + window * 0.4)
        ax.set_aspect("equal")

    anim = FuncAnimation(fig, draw, frames=frames)
    from .report import _animation_writer
    out_path, writer = _animation_writer(out_path, fps)
    anim.save(out_path, writer=writer)
    plt.close(fig)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mode", default="mmd_opt",
                   choices=["mmd_opt", "mmd_random", "cvar", "saa", "det"])
    p.add_argument("--episodes", type=int, default=1)
    p.add_argument("--route", default="curved",
                   choices=["straight", "curved", "circuit"])
    p.add_argument("--noise", default="gaussian", choices=["gaussian", "beta"])
    p.add_argument("--noise_level", type=float, default=0.1)
    p.add_argument("--num_reduced", type=int, default=4)
    p.add_argument("--num_obs", type=int, default=4)
    p.add_argument("--num_prime", type=int, default=50)
    p.add_argument("--v_des", type=float, default=15.0)
    p.add_argument("--max_steps", type=int, default=400)
    p.add_argument("--goal_arc", type=float, default=300.0)
    p.add_argument("--plot", type=str, default=None)
    p.add_argument("--animate", type=str, default=None,
                   help="write a birdview-style GIF of the LAST episode "
                        "(the CARLA HUD/birdeye overlay equivalent)")
    p.add_argument("--seed_base", type=int, default=0,
                   help="episode seed offset (episode seed = seed_base + "
                        "episode index); a nonzero base gives an "
                        "independent replication set of paired scenarios")
    p.add_argument("--actuation", default="direct", choices=["direct", "pid"],
                   help="pid = reference throttle/brake PID mapping "
                        "(carla/main_carla.py:25-71)")
    p.add_argument("--inner_budget", type=str, default=None,
                   help="SxIT (e.g. 64x12): reduced inner-CEM budget "
                        "(config.realtime_workload operating point)")
    p.add_argument("--outer_budget", type=str, default=None,
                   help="BxIT (e.g. 64x12): reduced outer-CEM budget "
                        "(num_batch x maxiter_cem; the fast operating "
                        "point, artifacts/fast/)")
    p.add_argument("--obstacles", type=str, nargs="*", default=None,
                   help="obstacles as s:l pairs along the route, e.g. "
                        "60:0 140:1.5 (default: the built-in pair). NOTE "
                        "an obstacle with |l - lane| < b_obs for every "
                        "lane is geometrically impassable within the band")
    args = p.parse_args(argv)

    # warm-start from the persistent XLA cache (minutes -> seconds for
    # every process after the first at a given config)
    from ..utils.compilation_cache import enable_persistent_cache
    enable_persistent_cache()

    cfg = onroad_workload(num_reduced=args.num_reduced, num_obs=args.num_obs,
                          noise=args.noise, noise_level=args.noise_level,
                          num_prime=args.num_prime, mode=args.mode)
    if args.inner_budget:
        import dataclasses
        S_b, it_b = (int(v) for v in args.inner_budget.split("x"))
        cfg = cfg.replace(beta_cem=dataclasses.replace(
            cfg.beta_cem, num_samples_cem=S_b, maxiter=it_b))
    if args.outer_budget:
        import dataclasses
        B_b, it_b = (int(v) for v in args.outer_budget.split("x"))
        cfg = cfg.replace(cem=dataclasses.replace(
            cfg.cem, num_batch=B_b, maxiter_cem=it_b))
    solver = FrenetSolver(cfg)

    results = []
    for ep in range(args.episodes):
        kw = {}
        if args.obstacles is not None:
            kw["obstacles_s_l"] = tuple(
                tuple(float(v) for v in o.split(":")) for o in args.obstacles)
        r = run_episode(cfg, route_kind=args.route, v_des=args.v_des,
                        max_steps=args.max_steps, goal_arc=args.goal_arc,
                        seed=args.seed_base + ep, solver=solver,
                        actuation=args.actuation, **kw)
        results.append(r)
        times = r.solve_times[1:] or r.solve_times
        print(json.dumps({
            "episode": args.seed_base + ep, "collided": r.collided,
            "steps": r.steps,
            "min_margin": round(r.min_obstacle_margin, 3),
            "mean_solve_ms": round(1e3 * float(np.mean(times)), 2),
            "p99_solve_ms": round(1e3 * float(np.percentile(times, 99)), 2),
        }))

    n_coll = sum(r.collided for r in results)
    print(json.dumps({"episodes": len(results), "collisions": n_coll,
                      "collision_rate": n_coll / len(results)}))

    if args.animate and results:
        print(animate_episode(results[-1], cfg, args.route, args.animate))

    if args.plot and results:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        from ..closedloop import make_route
        fig, ax = plt.subplots(figsize=(12, 5))
        rx, ry = make_route(args.route)
        ax.plot(rx[:3000], ry[:3000], "k--", lw=0.8, label="route")
        for r in results:
            if len(r.ego_trace):
                ax.plot(r.ego_trace[:, 0], r.ego_trace[:, 1], lw=1.2)
        ax.legend()
        ax.set_aspect("equal")
        fig.savefig(args.plot, dpi=150)
        print(args.plot)


if __name__ == "__main__":
    main()
