"""The measurement entry points on a machine without a GPU, and
chip_smoke.py's comparison helpers at small width on the CPU.

bench.py and chip_smoke.py measure the GPU only: on the CPU they must stop
with a message instead of timing the CPU.  chip_smoke.py's kernel checks
(top-k vs ``lax.top_k``, the beta QP vs a float64 KKT solve, the rollout vs a
float64 bicycle oracle) and its stage comparison run here at small width,
so the code the card runs is exercised before it gets there.
"""

import dataclasses

import jax
import numpy as np
import pytest

import bench
import chip_smoke
from mpc_mmd_tpu import ops, static_workload
from mpc_mmd_tpu.dynamics import rollout
from mpc_mmd_tpu.ops.qp_triton import eq_qp_solve_triton
from mpc_mmd_tpu.ops.rollout_triton import rollout_triton
from mpc_mmd_tpu.qp import build_workspace


@pytest.mark.parametrize("entry", ["bench", "chip_smoke"])
def test_device_guard_raises_on_cpu(entry, capsys):
    main = bench.main if entry == "bench" else (lambda: chip_smoke.main([]))
    with pytest.raises(SystemExit, match="no GPU found"):
        main()
    assert capsys.readouterr().out == ""       # no result line printed


@pytest.mark.parametrize("absolute,slice_to", [(True, 11), (False, None)])
def test_smoke_topk_check(rng, absolute, slice_to):
    x = chip_smoke.topk_input(rng, (6, 9, 12), nan_frac=0.05)
    cpu = jax.devices("cpu")[0]
    assert chip_smoke.topk_mismatches(ops.topk, x, 4, absolute, slice_to,
                                      cpu) == 0
    # a wrong implementation is caught
    def reversed_topk(v, k, absolute, slice_to):
        return ops.topk(v, k, absolute=absolute, slice_to=slice_to)[..., ::-1]
    assert chip_smoke.topk_mismatches(reversed_topk, x, 4, absolute,
                                      slice_to, cpu) > 0


@pytest.mark.parametrize("impl", ["xla", "triton"])
def test_smoke_qp_check(rng, impl):
    C, r = chip_smoke.qp_problems(rng, 64, 5)
    fn = ops.eq_qp_solve if impl == "xla" else (
        lambda C, r: eq_qp_solve_triton(C, r, interpret=True))
    e = chip_smoke.qp_errors(fn, C, r)
    assert e["ratio"] <= 1.0 and e["sum_err"] <= 1e-4
    # the oracle is an independent dense KKT solve: perturbing r moves it
    e_bad = chip_smoke.qp_errors(lambda C, r: fn(C, r + 1e-2), C, r)
    assert e_bad["ratio"] > 1.0


@pytest.mark.parametrize("per_lane", [False, True])
def test_smoke_rollout_check(rng, per_lane):
    acc, steer, s0 = chip_smoke.rollout_input(rng, 96, 50, per_lane)
    assert chip_smoke.rollout_error(rollout, acc, steer, s0) <= 1e-4
    interp = (lambda a, s, s0, dt, wb:
              rollout_triton(a, s, s0, dt, wb, interpret=True))
    assert chip_smoke.rollout_error(interp, acc, steer, s0) <= 1e-4


def test_smoke_stage_comparison():
    """The stages phase's chain and deviation metric, CPU against CPU:
    each stage rerun on the reference's inputs agrees exactly, and a
    perturbed stage output is flagged."""
    cfg = static_workload(num_reduced=3, num_obs=2, num_prime=15)
    cfg = cfg.replace(cem=dataclasses.replace(cfg.cem, num_batch=24),
                      beta_cem=dataclasses.replace(cfg.beta_cem,
                                                   num_samples_cem=20))
    ws = build_workspace(cfg)
    init_state, mean, cov, _, xt, yt = chip_smoke.static_inputs(cfg, ws, 1)
    inputs = {"init_state": np.asarray(init_state), "mean": np.asarray(mean),
              "cov": np.asarray(cov), "xt": np.asarray(xt[0]),
              "yt": np.asarray(yt[0])}
    stages = chip_smoke.stage_functions(cfg, ws)
    cpu = jax.devices("cpu")[0]
    ref = chip_smoke.run_stages(stages, "highest", cpu, inputs)
    got = chip_smoke.run_stages(stages, "highest", cpu, inputs, ref=ref)
    d = chip_smoke.stage_deviations(stages, got, ref)
    assert d.pop("winner_flips") == 0
    assert list(d) == [name for name, *_ in stages]
    assert max(d.values()) == 0.0
    bumped = dict(got, xr=got["xr"] * (1 + 1e-3))
    assert chip_smoke.stage_deviations(stages, bumped, ref)[
        "mother_rollouts"] > 1e-4
    assert ref["res"].shape == (24, 1)
    assert np.all(np.isfinite(ref["res"]))
