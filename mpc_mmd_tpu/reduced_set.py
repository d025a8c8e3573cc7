"""Reduced-set selection via an inner CEM over (beta weights, kernel bandwidth).

Given a "mother" ensemble of M noisy rollouts, pick ``k = num_reduced``
representative rollouts and optimal weights beta (sum=1) minimizing the MMD
between the weighted reduced set and the uniform mother distribution — the
paper's core contribution (arXiv 2501.19045).

Redesign (vs ``synthetic_static_obs/compute_beta.py``)
-----------------------------------------------------
The reference recomputes pairwise feature differences (k x M x 22) for every
one of 100 beta-samples x 20 CEM iterations (compute_beta.py:120-127 calling
kernel_computation.py:58-65).  But every kernel evaluated is a *row/column
subset of one mother Gram*, and the Laplace kernel's L1 distance matrix is
bandwidth-independent.  We therefore:

1. compute the (M, M) pairwise L1 distance matrix ONCE per candidate,
2. reduce each sample's kernel to gather + exp(-D/sigma),
3. batch the (k+1)-dim equality-KKT solves over all 100 samples.

This removes the dominant O(iters * samples * k * M * F) recompute entirely
while producing identical values (gathers commute with the feature-sum).

RNG consumption mirrors compute_beta.py:41-68,108-133 exactly (fixed
PRNGKey(0) seed — the inner CEM is deterministic and shared across
candidates, as in the reference where the vmap carries no per-candidate key).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .config import ProblemConfig
from .kernels import kernel_of, pairwise_l1, pairwise_l2sq
from .ops import eq_qp_solve, topk


class ReducedSet(NamedTuple):
    beta: jnp.ndarray       # (k,) optimal weights.  Slot order depends on
    #                       #  solve_strategy: ascending-|beta| for "exact"
    #                       #  (reference argsort), descending for the fast
    #                       #  path (ops.topk).  beta/x_red/y_red slots always
    #                       #  stay index-consistent with each other.
    sigma: jnp.ndarray      # ()   kernel bandwidth (reference quirk: drawn
    #                       #      from the *post-update* sample batch)
    x_red: jnp.ndarray      # (k, T) reduced rollouts
    y_red: jnp.ndarray
    res: jnp.ndarray        # (maxiter,) per-iteration best MMD residual


def _beta_qp(K_red: jnp.ndarray, row_sum: jnp.ndarray, M: int,
             cfg: ProblemConfig):
    """Equality-constrained QP for optimal reduced-set weights (batched).

    min_b  rho*b^T K_red b - 2*rho/M * row_sum . b   s.t.  sum(b) = 1

    K_red: (..., k, k); row_sum = sum_m K_mixed: (..., k).
    Returns (beta (..., k), mmd_cost (...)).
    Ref: compute_beta.py:70-91 (KKT assembly + the dropped constant terms).
    """
    b = cfg.beta_cem
    k = K_red.shape[-1]
    S = K_red.shape[0]
    cost = b.rho_beta * K_red + b.qp_reg * jnp.eye(k)
    lincost = -b.rho_beta * (1.0 / M) * row_sum

    if cfg.solve_strategy == "exact":
        # Dense KKT solve, bit-matching the reference (compute_beta.py:74-81).
        ones_col = jnp.ones((S, k, 1))
        top = jnp.concatenate((cost, ones_col), axis=2)
        bot = jnp.concatenate((jnp.ones((S, 1, k)), jnp.zeros((S, 1, 1))), axis=2)
        kkt = jnp.concatenate((top, bot), axis=1)           # (S, k+1, k+1)
        rhs = jnp.concatenate((-lincost, jnp.ones((S, 1))), axis=1)
        sol = jnp.linalg.solve(kkt, rhs[..., None])[..., 0]
        beta = sol[:, :k]
        q = -2.0 * (1.0 / M) * row_sum
        mmd = (jnp.einsum("si,sij,sj->s", beta, K_red, beta)
               + jnp.einsum("si,si->s", q, beta))
        return beta, mmd

    # Block elimination (C is PD thanks to the qp_reg ridge); the kernel
    # table in ops/ picks the Triton kernel or the fused-jnp unroll.
    r = -lincost
    beta, mu = eq_qp_solve(cost, r)

    # mmd = b'K_red b + q.b with q = -2/M sum_m K_mixed = -2 r / rho.
    # KKT identity (rho K_red + reg I) b = r - mu 1 and sum(b) = 1 give
    #   b' K_red b = (b.r - mu - reg |b|^2) / rho,
    # so  mmd = (-b.r - mu - reg |b|^2) / rho  — three (S, k) dot products
    # instead of the O(S k^2) contraction.
    br = jnp.sum(beta * r, axis=-1)
    mmd = (-br - mu - b.qp_reg * jnp.sum(beta * beta, axis=-1)) / b.rho_beta
    return beta, mmd


def _beta_qp_t(K_red_t: jnp.ndarray, row_sum_t: jnp.ndarray, M: int,
               cfg: ProblemConfig):
    """Lane-major variant of :func:`_beta_qp` (fast mode only).

    K_red_t: (k, k, B) with K_red_t[i, j] = K_red[..., i, j];
    row_sum_t: (k, B).  Returns (beta_t (k, B), mmd_cost (B,)).

    The selection chain emits K_red in this layout ("xt", see
    :func:`select_reduced_set_batched`); the solve itself runs on the
    (B, k, k) view.
    """
    b = cfg.beta_cem
    k = K_red_t.shape[0]
    B = K_red_t.shape[-1]
    eye_flat = jnp.eye(k, dtype=K_red_t.dtype).reshape(k * k, 1)
    cost_t = b.rho_beta * K_red_t.reshape(k * k, B) + b.qp_reg * eye_flat
    r_t = (b.rho_beta / M) * row_sum_t
    C_b = jnp.moveaxis(cost_t.reshape(k, k, B), -1, 0)
    beta_b, mu = eq_qp_solve(C_b, r_t.T)
    beta_t = beta_b.T
    br = jnp.sum(beta_t * r_t, axis=0)
    mmd = (-br - mu - b.qp_reg * jnp.sum(beta_t * beta_t, axis=0)) / b.rho_beta
    return beta_t, mmd


def _cov_ddof1(X: jnp.ndarray) -> jnp.ndarray:
    """np.cov-compatible covariance of rows (n, d) with ddof=1."""
    mu = jnp.mean(X, axis=0)
    Xc = X - mu
    return (Xc.T @ Xc) / (X.shape[0] - 1)


def select_reduced_set(cfg: ProblemConfig, cx: jnp.ndarray, cy: jnp.ndarray,
                       x_roll: jnp.ndarray, y_roll: jnp.ndarray) -> ReducedSet:
    """Run the inner CEM for one candidate's mother ensemble.

    cx, cy: (M, nvar) Bernstein coefficients of the rollouts (the kernel
    feature space); x_roll, y_roll: (M, T) rollout positions.
    Ref: compute_beta.py:93-157.
    """
    b = cfg.beta_cem
    M = cfg.risk.num_mother
    k = cfg.risk.num_reduced
    S = b.num_samples_cem
    n_el = b.num_ellite

    feats = jnp.concatenate((cx, cy), axis=1)               # (M, 2*nvar)
    D = pairwise_l1(feats, feats)                            # (M, M) — once!
    # non-laplace kernels (RiskConfig.kernel) additionally need the squared
    # L2 distances; both matrices are iteration-constant, so the selectable
    # kernel stays a gather + elementwise map (kernels.kernel_of)
    kind = cfg.risk.kernel
    D2 = pairwise_l2sq(feats, feats) if kind != "laplace" else None

    # "prefactored" (production) strategy swaps the CEM resampling for an
    # exact low-rank reformulation: the elite covariance is
    # X^T X/(n-1) + jitter*I with X only (n_ellite, M+1)-centred elites, so
    # N(mean, cov) sampling is mean + u @ X / sqrt(n-1) + sqrt(jitter) * z
    # with u, z standard normal — identical distribution, NO (M+1)^2
    # covariance formation and NO (M+1)-dim Cholesky per iteration.  "exact"
    # keeps the reference's jnp.cov + multivariate_normal path (compute_beta.py:52-68).
    fast = cfg.solve_strategy != "exact"

    mean0 = jnp.zeros(M + 1)
    # Key chain mirrors the reference: split(PRNGKey(0))[0] seeds the scan
    # carry, and compute_beta_samples_initial splits once more before its MVN
    # draw (compute_beta.py:25,42-46,108-110).
    key0, _ = jax.random.split(jax.random.PRNGKey(0))
    init_key, _ = jax.random.split(key0)
    if fast:
        samples0 = jnp.sqrt(b.init_cov_scale) * jax.random.normal(
            init_key, (S, M + 1))
    else:
        cov0 = b.init_cov_scale * jnp.eye(M + 1)
        samples0 = jax.random.multivariate_normal(init_key, mean0, cov0, (S,))
    samples0 = samples0.at[:, -1].set(jnp.clip(samples0[:, -1], b.sigma_clip))

    def iteration(carry, _):
        key, samples = carry
        sigma = samples[:, -1]                               # (S,)

        if fast:
            # top-k by |beta| (descending; the reduced-set QP and MMD are
            # permutation-invariant, and beta/rollout outputs stay
            # index-consistent) instead of the reference's full argsort.
            idx_top = topk(samples, k, absolute=True, slice_to=M)  # (S, k)
        else:
            idx_sorted = jnp.argsort(jnp.abs(samples[:, :M]), axis=1)
            idx_top = idx_sorted[:, M - k:]                  # ascending |beta|

        if fast:
            # Irregular memory access -> dense one-hot contractions: the
            # row gather D[idx_top] and the column sub-selection become
            # matmuls, and exp commutes with selection so
            # K_red[i, j] = exp(-rows)[i, idx_j].
            onehot = (idx_top[:, :, None]
                      == jnp.arange(M)[None, None, :]).astype(D.dtype)
            rows = jnp.einsum("skr,rm->skm", onehot, D)      # (S, k, M)
            if kind == "laplace":
                K_mixed = jnp.exp(-rows / sigma[:, None, None])
            else:
                rows2 = jnp.einsum("skr,rm->skm", onehot, D2)
                K_mixed = kernel_of(kind, sigma[:, None, None], rows, rows2)
            # column sub-selection commutes with ANY elementwise kernel map
            K_red = jnp.einsum("skm,sjm->skj", K_mixed, onehot)
        else:
            rows = D[idx_top]                                # (S, k, M)
            idx_bc = jnp.broadcast_to(idx_top[:, None, :], (S, k, k))
            if kind == "laplace":
                K_mixed = jnp.exp(-rows / sigma[:, None, None])
                sub = jnp.take_along_axis(rows, idx_bc, axis=2)
                K_red = jnp.exp(-sub / sigma[:, None, None])
            else:
                rows2 = D2[idx_top]
                K_mixed = kernel_of(kind, sigma[:, None, None], rows, rows2)
                K_red = jnp.take_along_axis(K_mixed, idx_bc, axis=2)

        row_sum = jnp.sum(K_mixed, axis=2)                   # (S, k)
        beta_opt, cost = _beta_qp(K_red, row_sum, M, cfg)    # (S, k), (S,)

        # --- CEM update (ref compute_beta.py:51-68) ------------------------
        key, _ = jax.random.split(key)
        upd_key, _sub = jax.random.split(key)
        if fast:
            # only the n_el best are consumed: a top-k of -cost, whose
            # tie-breaking matches stable argsort (first index wins).
            # NaN costs -> +inf so the top-k skips them like argsort's
            # NaN-last ordering does on the exact path.
            cost = jnp.where(jnp.isnan(cost), jnp.inf, cost)
            idx_el = topk(-cost, n_el)                       # (n_el,)
            elites = samples[idx_el]
        else:
            order = jnp.argsort(cost)
            elites = samples[order[:n_el]]
        mean = jnp.mean(elites, axis=0)
        if fast:
            ku, kz = jax.random.split(upd_key)
            u = jax.random.normal(ku, (S - n_el, n_el))
            z = jax.random.normal(kz, (S - n_el, M + 1))
            fresh = (mean + (u @ (elites - mean)) / jnp.sqrt(n_el - 1.0)
                     + jnp.sqrt(b.cov_jitter) * z)
            # elites' sigma lane is already clipped (inductively), so
            # clipping just the fresh rows is exact and saves a pass.
            fresh = fresh.at[:, -1].set(jnp.clip(fresh[:, -1], b.sigma_clip))
            new_samples = jnp.concatenate((elites, fresh), axis=0)
        else:
            cov = _cov_ddof1(elites) + b.cov_jitter * jnp.eye(M + 1)
            fresh = jax.random.multivariate_normal(upd_key, mean, cov,
                                                   (S - n_el,))
            new_samples = jnp.concatenate((elites, fresh), axis=0)
            new_samples = new_samples.at[:, -1].set(
                jnp.clip(new_samples[:, -1], b.sigma_clip))

        i_min = jnp.argmin(cost)
        best = (beta_opt[i_min],
                new_samples[i_min, -1],   # reference quirk: sigma from the
                #                         # POST-update batch (compute_beta.py:133-138)
                idx_top[i_min],
                jnp.min(cost))
        return (key, new_samples), best

    (key_f, _), (betas, sigmas, idxs, mins) = lax.scan(
        iteration, (key0, samples0), None, length=b.maxiter)

    idx_best = idxs[-1]
    return ReducedSet(beta=betas[-1], sigma=sigmas[-1],
                      x_red=x_roll[idx_best], y_red=y_roll[idx_best],
                      res=mins)


def select_reduced_set_batched(cfg: ProblemConfig, cx: jnp.ndarray,
                               cy: jnp.ndarray, x_roll: jnp.ndarray,
                               y_roll: jnp.ndarray,
                               selection: str | None = None) -> ReducedSet:
    """All-candidate inner CEM (the production fast-mode path).

    cx, cy: (C, M, nvar); x_roll, y_roll: (C, M, T).  Semantically equal to
    ``vmap(select_reduced_set)`` in fast mode (the CEM noise is shared across
    candidates in both — the reference's inner CEM carries no per-candidate
    key), verified by tests/test_ops.py::test_batched_inner_cem_matches_vmap.

    selection (default ``MPC_MMD_SELECTION`` or "xla") picks one of three
    plain-XLA formulations of the selection stage, all with the same math:

    * "xla": top-k (ops.topk) and the kernel matrices as one-hot einsums,
      which XLA fuses with the exp.
    * "g": the reduce-before-gather form — row_sum as one fused exp+reduce
      over ALL mother rows followed by a scalar gather (the reduction
      commutes with the row gather), K_red from feature-space pairwise L1;
      no (C, S, k, M) rows tensor at all.  Values match the einsum form up
      to sum reassociation (~1e-5 relative).
    * "xt": the lane-major chain — K_red emitted as (k, k, C*S)
      ("cskm,csjm->kjcs"), row_sum emitted transposed, and beta kept
      (k, C, S) through the whole scan.

    Which one is fastest on the H100 is not measured yet.
    """
    import os
    if selection is None:
        selection = os.environ.get("MPC_MMD_SELECTION") or "xla"
    if selection not in ("xla", "xt", "g"):
        raise ValueError(f"unknown selection {selection!r} "
                         "(expected 'xla', 'xt' or 'g')")
    kind = cfg.risk.kernel
    if kind != "laplace" and selection == "g":
        # the reduce-before-gather formulation hard-codes the Laplace exp;
        # non-laplace kernels take the default selection chain
        selection = "xla"
    lane_major = selection == "xt"

    b = cfg.beta_cem
    M = cfg.risk.num_mother
    k = cfg.risk.num_reduced
    S = b.num_samples_cem
    n_el = b.num_ellite
    C = cx.shape[0]

    feats = jnp.concatenate((cx, cy), axis=2)               # (C, M, 2*nvar)
    D = pairwise_l1(feats, feats)                            # (C, M, M)
    # squared-L2 distances only when the configured kernel needs them
    # (RiskConfig.kernel; the selection gathers below run on BOTH matrices
    # then, kernels.kernel_of maps the pair to K)
    D2 = pairwise_l2sq(feats, feats) if kind != "laplace" else None

    key0, _ = jax.random.split(jax.random.PRNGKey(0))
    init_key, _ = jax.random.split(key0)
    samples0_row = jnp.sqrt(b.init_cov_scale) * jax.random.normal(
        init_key, (S, M + 1))
    samples0_row = samples0_row.at[:, -1].set(
        jnp.clip(samples0_row[:, -1], b.sigma_clip))
    samples0 = jnp.broadcast_to(samples0_row[None], (C, S, M + 1))

    inv_sqrt = 1.0 / jnp.sqrt(n_el - 1.0)
    sqrt_jit = jnp.sqrt(b.cov_jitter)
    # per-lane floor implementing the sigma clip as ONE fused elementwise
    # max: -inf on the beta lanes, sigma_clip on the bandwidth lane.  The
    # .at[..., -1].set(clip(...)) form lowers to a dynamic-update-slice
    # that re-materializes the whole fresh tensor every iteration.
    lane_floor = jnp.full((M + 1,), -jnp.inf).at[-1].set(b.sigma_clip)

    # Hoist the CEM-update noise out of the scan: replicate the in-scan key
    # chain exactly (key <- split(key)[0] once per iteration; u/z from the
    # update key's split), generate every iteration's u/z in two batched
    # normal calls, and feed them to the scan as xs.  Removes 4 threefry
    # dispatches per iteration; values are bit-identical to the in-scan
    # draws (vmap over keys == stacked per-key calls).
    kc = key0
    ku_list, kz_list = [], []
    for _ in range(b.maxiter):
        kc, _ = jax.random.split(kc)
        upd_key, _ = jax.random.split(kc)
        ku, kz = jax.random.split(upd_key)
        ku_list.append(ku)
        kz_list.append(kz)
    u_all = jax.vmap(
        lambda kk: jax.random.normal(kk, (S - n_el, n_el)))(jnp.stack(ku_list))
    z_all = jax.vmap(
        lambda kk: jax.random.normal(kk, (S - n_el, M + 1)))(jnp.stack(kz_list))

    # The whole CEM update is affine in the elites:
    #   fresh_s = mean + inv_sqrt * sum_e u_se (elite_e - mean) + jit * z_s
    #           = sum_e [inv_sqrt*u_se + (1 - inv_sqrt*sum_e u_se)/n_el] elite_e
    #             + jit * z_s
    # so new_samples = B_t @ elites + Z_t with B_t = [[I]; [A_t]] and
    # Z_t = [[0]; [jit * z_t]], both depending ONLY on the hoisted noise —
    # precomputed here for every iteration.  This collapses the in-scan
    # mean / fresh-einsum / concatenate chain into ONE
    # (S, n_el) x (C, n_el, M+1) GEMM.
    s_u = jnp.sum(u_all, axis=2)                            # (maxiter, S-n_el)
    A_all = (inv_sqrt * u_all
             + ((1.0 - inv_sqrt * s_u) / n_el)[..., None])  # (., S-n_el, n_el)
    eye_rows = jnp.broadcast_to(jnp.eye(n_el)[None],
                                (b.maxiter, n_el, n_el))
    B_all = jnp.concatenate((eye_rows, A_all), axis=1)      # (., S, n_el)
    Z_all = jnp.concatenate(
        (jnp.zeros((b.maxiter, n_el, M + 1)), sqrt_jit * z_all),
        axis=1)                                             # (., S, M+1)

    def _selection_qp(samples_sub):
        """Per-row selection + reduced-set QP on a (C, S_sub, M+1) batch.

        Pure function of the rows (and the iteration-constant D/feats), so
        its outputs for a row can be cached across iterations when the row
        itself is carried unchanged (see elite_carry below).
        """
        if selection == "g":
            sigma = samples_sub[..., -1]                     # (C, Ss), clipped
            idx_top = topk(samples_sub, k, absolute=True,
                           slice_to=M)                       # (C, Ss, k)
            onehot = (idx_top[..., None]
                      == jnp.arange(M)).astype(D.dtype)      # (C, Ss, k, M)
            # fused exp+reduce: XLA materializes only the (C, Ss, M) output
            G = jnp.sum(
                jnp.exp(-D[:, None, :, :] / sigma[:, :, None, None]),
                axis=-1)
            row_sum = jnp.einsum("cskr,csr->csk", onehot, G)
            fsel = jnp.einsum("cskr,crf->cskf", onehot, feats)
            d_sub = jnp.sum(
                jnp.abs(fsel[:, :, :, None, :] - fsel[:, :, None, :, :]),
                axis=-1)                                     # (C, Ss, k, k)
            K_red = jnp.exp(-d_sub / sigma[..., None, None])
        elif lane_major:
            sigma = samples_sub[..., -1]                     # (C, Ss), clipped
            Cc, Ss = sigma.shape
            idx_top = topk(samples_sub, k, absolute=True,
                           slice_to=M)                       # (C, Ss, k)
            onehot = (idx_top[..., None]
                      == jnp.arange(M)).astype(D.dtype)      # (C, Ss, k, M)
            rows = jnp.einsum("cskr,crm->cskm", onehot, D)
            if kind == "laplace":
                K_mixed = jnp.exp(-rows / sigma[..., None, None])
            else:
                rows2 = jnp.einsum("cskr,crm->cskm", onehot, D2)
                K_mixed = kernel_of(kind, sigma[..., None, None], rows, rows2)
            K_red_t = jnp.einsum("cskm,csjm->kjcs", K_mixed, onehot)
            row_sum_t = jnp.einsum("cskm->kcs", K_mixed)
            beta_t, cost = _beta_qp_t(K_red_t.reshape(k, k, Cc * Ss),
                                      row_sum_t.reshape(k, Cc * Ss), M, cfg)
            beta_opt = beta_t.reshape(k, Cc, Ss)             # lane-major!
            cost = cost.reshape(Cc, Ss)
        else:
            sigma = samples_sub[..., -1]                     # (C, Ss), clipped
            idx_top = topk(samples_sub, k, absolute=True,
                           slice_to=M)                       # (C, Ss, k)
            onehot = (idx_top[..., None]
                      == jnp.arange(M)).astype(D.dtype)      # (C, Ss, k, M)
            rows = jnp.einsum("cskr,crm->cskm", onehot, D)
            if kind == "laplace":
                K_mixed = jnp.exp(-rows / sigma[..., None, None])
            else:
                rows2 = jnp.einsum("cskr,crm->cskm", onehot, D2)
                K_mixed = kernel_of(kind, sigma[..., None, None], rows, rows2)
            K_red = jnp.einsum("cskm,csjm->cskj", K_mixed, onehot)
            row_sum = jnp.sum(K_mixed, axis=-1)
        if not lane_major:
            beta_opt, cost = _beta_qp(K_red, row_sum, M, cfg)
            #                                               (C,Ss,k), (C,Ss)

        # NaN costs -> +inf: keeps poisoned samples out of the elite set
        # (argsort-NaN-last semantics of the exact path)
        cost = jnp.where(jnp.isnan(cost), jnp.inf, cost)
        # NaN betas -> 0: the winner extraction below is a one-hot einsum
        # over the sample axis, and 0 * NaN from a NON-winning poisoned
        # sample would otherwise contaminate the selected row (the
        # take_along_axis it replaced was immune).  Poisoned samples carry
        # +inf cost so zeroing never alters a genuine winner.
        beta_opt = jnp.where(jnp.isnan(beta_opt), 0.0, beta_opt)
        return idx_top, beta_opt, cost

    # One-hot GATHER contractions must be value-exact: a reduced default
    # matmul precision (TF32 on the GPU) would round every gathered value
    # (and the carried elite ROWS through the affine update's identity
    # block).  These are all tiny contractions (<= 1e7 MACs vs 1e9 for the
    # selection einsums), so they are pinned to full f32.
    _exact = jax.lax.Precision.HIGHEST

    def _update_samples(samples, cost, B_t, Z_t):
        # one-hot gather of the elites along the sample axis
        idx_el = topk(-cost, n_el)                           # (C, n_el)
        onehot_el = (idx_el[..., None]
                     == jnp.arange(S)).astype(samples.dtype)
        elites = jnp.einsum("ces,csm->cem", onehot_el, samples,
                            precision=_exact)
        # precomputed affine update (see B_all/Z_all above); the lane
        # floor is identity on the elite rows (inductively clipped), so
        # rows 0..n_el-1 of new_samples are the elites BIT-UNCHANGED.
        new_samples = jnp.maximum(
            jnp.einsum("se,cem->csm", B_t, elites, precision=_exact) + Z_t,
            lane_floor)
        # elite cost via take_along_axis, NOT a one-hot einsum — 0 * inf
        # from a non-selected poisoned sample would turn it into NaN (the
        # gather is (C, n_el), tiny).
        el_cost = jnp.take_along_axis(cost, idx_el, axis=1)
        return new_samples, onehot_el, el_cost

    def _winner(idx_top, beta_opt, cost, new_samples):
        i_min = jnp.argmin(cost, axis=1)                     # (C,)
        # one-hot contractions for the winner row of each candidate
        oh_min = (i_min[:, None]
                  == jnp.arange(S)).astype(new_samples.dtype)
        return (jnp.einsum("cs,kcs->ck" if lane_major else "cs,csk->ck",
                           oh_min, beta_opt, precision=_exact),
                jnp.einsum("cs,cs->c", oh_min, new_samples[..., -1],
                           precision=_exact),
                jnp.einsum("cs,csk->ck", oh_min,
                           idx_top.astype(new_samples.dtype),
                           precision=_exact).astype(idx_top.dtype))

    # Elite-carry: new_samples rows 0..n_el-1 ARE the elites, bit-unchanged
    # (B_t's top block is the identity — exact thanks to the pinned gather
    # precision above — and the lane floor is a no-op on inductively-clipped
    # rows), and _selection_qp is a pure per-row function of (row, D) — so
    # the elites' selection/QP outputs from this iteration are exactly what
    # the next iteration would recompute for them.  Carry (idx_top, beta,
    # cost) for the elite rows and run the heavy selection stage on only
    # the S - n_el fresh rows.
    elite_carry = os.environ.get("MPC_MMD_ELITE_CARRY", "1") != "0"

    if elite_carry:
        # iteration 0 peeled out of the scan (all rows fresh: full-batch
        # selection), and the winner extraction peeled off the LAST
        # iteration — only res (per-iteration min cost) and the final
        # iteration's winner are consumed by callers, so the scan body
        # carries just the elite results forward.
        # Iteration 0 is candidate-SHARED: samples0 is a broadcast of one
        # (S, M+1) row batch, so the top-k and the one-hot are identical
        # across candidates — compute them once and contract the shared
        # (S, k, M) one-hot against every candidate's D (the einsums then
        # read a 100x smaller one-hot operand).  The "xla" and "xt"
        # selections exploit this; "g" falls back to the generic
        # per-candidate path.
        if selection in ("xla", "xt"):
            sigma0 = samples0_row[:, -1]                     # (S,), clipped
            idx0_1 = topk(samples0_row[None], k, absolute=True,
                          slice_to=M)[0]                     # (S, k)
            onehot0 = (idx0_1[..., None]
                       == jnp.arange(M)).astype(D.dtype)     # (S, k, M)
            rows0 = jnp.einsum("skr,crm->cskm", onehot0, D)
            if kind == "laplace":
                K_mixed0 = jnp.exp(-rows0 / sigma0[None, :, None, None])
            else:
                rows0_2 = jnp.einsum("skr,crm->cskm", onehot0, D2)
                K_mixed0 = kernel_of(kind, sigma0[None, :, None, None],
                                     rows0, rows0_2)
            if lane_major:
                K_red0_t = jnp.einsum("cskm,sjm->kjcs", K_mixed0, onehot0)
                row_sum0_t = jnp.einsum("cskm->kcs", K_mixed0)
                beta0_t, cost0 = _beta_qp_t(
                    K_red0_t.reshape(k, k, C * S),
                    row_sum0_t.reshape(k, C * S), M, cfg)
                beta0 = beta0_t.reshape(k, C, S)
                cost0 = cost0.reshape(C, S)
            else:
                K_red0 = jnp.einsum("cskm,sjm->cskj", K_mixed0, onehot0)
                row_sum0 = jnp.sum(K_mixed0, axis=-1)
                beta0, cost0 = _beta_qp(K_red0, row_sum0, M, cfg)
            cost0 = jnp.where(jnp.isnan(cost0), jnp.inf, cost0)
            beta0 = jnp.where(jnp.isnan(beta0), 0.0, beta0)
            idx0 = jnp.broadcast_to(idx0_1[None], (C, S, k))
        else:
            idx0, beta0, cost0 = _selection_qp(samples0)
        s1, oh0, elc1 = _update_samples(samples0, cost0, B_all[0], Z_all[0])
        fdt = s1.dtype
        el_idx1 = jnp.einsum("ces,csk->cek", oh0, idx0.astype(fdt),
                             precision=_exact).astype(idx0.dtype)
        _bsum = "ces,kcs->kce" if lane_major else "ces,csk->cek"
        el_beta1 = jnp.einsum(_bsum, oh0, beta0, precision=_exact)
        min0 = jnp.min(cost0, axis=1)

        if b.maxiter == 1:
            beta_w, sigma_w, idx_best = _winner(idx0, beta0, cost0, s1)
            mins = min0[None]
        else:
            def iteration(carry, uz):
                samples, (el_idx, el_beta, el_cost) = carry
                B_t, Z_t = uz
                idx_f, beta_f, cost_f = _selection_qp(samples[:, n_el:])
                cost = jnp.concatenate((el_cost, cost_f), axis=1)
                new_samples, oh, el_cost2 = _update_samples(
                    samples, cost, B_t, Z_t)
                # split one-hot extraction over the (carried | fresh) row
                # blocks — avoids materializing the concatenated (C, S, k)
                # beta/idx tensors inside the scan
                oh_e, oh_f = oh[:, :, :n_el], oh[:, :, n_el:]
                el_beta2 = (jnp.einsum(_bsum, oh_e, el_beta,
                                       precision=_exact)
                            + jnp.einsum(_bsum, oh_f, beta_f,
                                         precision=_exact))
                el_idx2 = (jnp.einsum("ces,csk->cek", oh_e,
                                      el_idx.astype(fdt), precision=_exact)
                           + jnp.einsum("ces,csk->cek", oh_f,
                                        idx_f.astype(fdt), precision=_exact)
                           ).astype(el_idx.dtype)
                return ((new_samples, (el_idx2, el_beta2, el_cost2)),
                        jnp.min(cost, axis=1))

            (s_f, (el_idx_f, el_beta_f, el_cost_f)), mins_mid = lax.scan(
                iteration, (s1, (el_idx1, el_beta1, elc1)),
                (B_all[1:-1], Z_all[1:-1]))

            # final iteration: full concat once, winner extraction once
            idx_l, beta_l, cost_l = _selection_qp(s_f[:, n_el:])
            idx_top = jnp.concatenate((el_idx_f, idx_l), axis=1)
            # lane-major beta blocks are (k, C, rows): concat on the row axis
            beta_opt = jnp.concatenate((el_beta_f, beta_l),
                                       axis=-1 if lane_major else 1)
            cost = jnp.concatenate((el_cost_f, cost_l), axis=1)
            s_last, _, _ = _update_samples(s_f, cost, B_all[-1], Z_all[-1])
            beta_w, sigma_w, idx_best = _winner(idx_top, beta_opt, cost,
                                                s_last)
            mins = jnp.concatenate(
                (min0[None], mins_mid, jnp.min(cost, axis=1)[None]))

        x_red = jnp.take_along_axis(x_roll, idx_best[:, :, None], axis=1)
        y_red = jnp.take_along_axis(y_roll, idx_best[:, :, None], axis=1)
        return ReducedSet(beta=beta_w, sigma=sigma_w, x_red=x_red,
                          y_red=y_red, res=jnp.moveaxis(mins, 0, 1))
    else:
        # full-recompute fallback (MPC_MMD_ELITE_CARRY=0):
        # same helpers, winner extracted every iteration (no peel)
        def iteration(samples, uz):
            B_t, Z_t = uz
            idx_top, beta_opt, cost = _selection_qp(samples)
            new_samples, _, _ = _update_samples(samples, cost, B_t, Z_t)
            beta_w, sigma_w, idx_w = _winner(idx_top, beta_opt, cost,
                                             new_samples)
            return new_samples, (beta_w, sigma_w, idx_w,
                                 jnp.min(cost, axis=1))

        _, (betas, sigmas, idxs, mins) = lax.scan(
            iteration, samples0, (B_all, Z_all))

    idx_best = idxs[-1]                                      # (C, k)
    x_red = jnp.take_along_axis(x_roll, idx_best[:, :, None], axis=1)
    y_red = jnp.take_along_axis(y_roll, idx_best[:, :, None], axis=1)
    return ReducedSet(beta=betas[-1], sigma=sigmas[-1], x_red=x_red,
                      y_red=y_red, res=jnp.moveaxis(mins, 0, 1))
