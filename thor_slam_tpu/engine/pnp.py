"""Multi-camera PnP: batched Gauss-Newton with Huber IRLS and RANSAC.

Pose estimation for the VO front-end — the role cuVSLAM's tracker plays
(closed CUDA). Design: RANSAC is not a data-dependent loop but a
*batch of hypotheses* solved in parallel under `vmap`, scored densely, and
reduced with one argmax; the final polish is a masked IRLS Gauss-Newton over
all correspondences. Everything is fixed-iteration and fixed-shape.

Conventions:
* optimized variable: ``X = body_T_world`` (world point -> body frame);
* per-observation camera extrinsics are ``cam_T_body`` (body -> camera);
* observations are *normalized* image coordinates ((u-cx)/fx, (v-cy)/fy);
* se(3) tangent is [rho, phi], left-multiplicative: X <- exp(delta) X.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from thor_slam_tpu.ops import lie, linalg


class PnPResult(NamedTuple):
    """Result of robust pose estimation.

    Attributes:
        body_t_world: (4, 4) estimated pose (world -> body).
        inliers: (N,) bool inlier mask at the final pose.
        num_inliers: () int32.
        rms_error: () float32 RMS reprojection error of inliers (normalized
            coords; multiply by fx for pixels).
        covariance: (6, 6) pose covariance in the solve's left tangent
            [rho, phi] of ``body_t_world`` — the residual-scaled inverse of
            the final Gauss-Newton Hessian (free at the solve: the last
            iteration already formed J^T W J). The reference consumes a
            6x6 pose covariance from its engine for its confidence metric
            (reference isaac_ros.py:308-325); here it is actually derived
            from the estimation geometry instead of left unset.
    """

    body_t_world: jnp.ndarray
    inliers: jnp.ndarray
    num_inliers: jnp.ndarray
    rms_error: jnp.ndarray
    covariance: jnp.ndarray


def pose_covariance(
    body_t_world: jnp.ndarray,
    points_w: jnp.ndarray,
    obs: jnp.ndarray,
    inlier_weights: jnp.ndarray,
    cam_rot: jnp.ndarray,
    cam_trans: jnp.ndarray,
    damping: float = 1e-6,
) -> jnp.ndarray:
    """(6, 6) covariance of the pose estimate in the [rho, phi] tangent.

    ``sigma^2 * (J^T W J)^-1`` with the per-coordinate residual variance
    ``sigma^2`` estimated from the inlier residuals (2 residual rows per
    observation, 6 pose dofs). Degenerate systems (too few inliers) return
    a large-but-finite covariance rather than inf/nan.
    """
    r, j, behind = _residuals_and_jacobian(body_t_world, points_w, obs, cam_rot, cam_trans)
    w = inlier_weights * (1.0 - behind.astype(jnp.float32))
    jw = j * w[:, None, None]
    h = jnp.einsum("nai,naj->ij", jw, j) + damping * jnp.eye(6)
    n_eff = jnp.sum(w)
    dof = jnp.maximum(2.0 * n_eff - 6.0, 1.0)
    sigma2 = jnp.sum(w[:, None] * r**2) / dof
    cov = sigma2 * linalg.spd_inverse(h)
    # Symmetrize (inv of a near-symmetric matrix drifts) and guard NaN.
    cov = 0.5 * (cov + cov.T)
    return jnp.where(jnp.all(jnp.isfinite(cov)), cov, jnp.eye(6) * 1e6)


def project_points(
    body_t_world: jnp.ndarray,
    points_w: jnp.ndarray,
    cam_rot: jnp.ndarray,
    cam_trans: jnp.ndarray,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """World points -> per-observation camera frames and normalized coords.

    Args:
        body_t_world: (4, 4).
        points_w: (N, 3) world points.
        cam_rot: (N, 3, 3) cam_T_body rotation per observation.
        cam_trans: (N, 3) cam_T_body translation per observation.

    Returns:
        (p_body (N,3), p_cam (N,3), uv (N,2) normalized projections).
    """
    p_b = points_w @ body_t_world[:3, :3].T + body_t_world[:3, 3]
    p_c = jnp.einsum("nij,nj->ni", cam_rot, p_b) + cam_trans
    z = jnp.maximum(p_c[:, 2], 1e-6)
    uv = p_c[:, :2] / z[:, None]
    return p_b, p_c, uv


def _residuals_and_jacobian(body_t_world, points_w, obs, cam_rot, cam_trans):
    p_b, p_c, uv = project_points(body_t_world, points_w, cam_rot, cam_trans)
    r = uv - obs  # (N, 2)

    z = jnp.maximum(p_c[:, 2], 1e-6)
    inv_z = 1.0 / z
    x, y = p_c[:, 0], p_c[:, 1]
    # d(uv)/d(p_c): (N, 2, 3)
    zero = jnp.zeros_like(inv_z)
    j_proj = jnp.stack(
        [
            jnp.stack([inv_z, zero, -x * inv_z * inv_z], axis=-1),
            jnp.stack([zero, inv_z, -y * inv_z * inv_z], axis=-1),
        ],
        axis=1,
    )
    # d(p_b)/d(delta) = [I | -hat(p_b)]: (N, 3, 6)
    n = points_w.shape[0]
    eye = jnp.broadcast_to(jnp.eye(3), (n, 3, 3))
    hat_pb = jax.vmap(lie.hat)(p_b)
    dpb = jnp.concatenate([eye, -hat_pb], axis=-1)
    # d(p_c)/d(delta) = R_cb @ dpb: (N, 3, 6); J = j_proj @ that: (N, 2, 6)
    j = jnp.einsum("nab,nbc,ncd->nad", j_proj, cam_rot, dpb)
    behind = p_c[:, 2] <= 1e-4
    return r, j, behind


def _huber_weights(r_norm: jnp.ndarray, delta: float) -> jnp.ndarray:
    return jnp.where(r_norm <= delta, 1.0, delta / jnp.maximum(r_norm, 1e-12))


@partial(jax.jit, static_argnames=("iters",))
def gauss_newton_pnp(
    points_w: jnp.ndarray,
    obs: jnp.ndarray,
    weights: jnp.ndarray,
    cam_rot: jnp.ndarray,
    cam_trans: jnp.ndarray,
    init_body_t_world: jnp.ndarray,
    iters: int = 8,
    huber_delta: float = 0.01,
    damping: float = 1e-6,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """IRLS Gauss-Newton pose refinement over masked correspondences.

    Args:
        points_w: (N, 3) world landmarks.
        obs: (N, 2) normalized observations.
        weights: (N,) a-priori weights; 0 disables a correspondence.
        cam_rot: (N, 3, 3) cam_T_body rotations per observation.
        cam_trans: (N, 3) cam_T_body translations.
        init_body_t_world: (4, 4) initial pose.
        iters: Fixed GN iteration count (static).
        huber_delta: Huber kernel width in normalized-coordinate units
            (0.01 ~ 5 px at fx=500).
        damping: Levenberg diagonal damping.

    Returns:
        (body_t_world, residual_norms): refined (4,4) pose and (N,) final
        per-correspondence residual norms.
    """

    def step(_, x):
        r, j, behind = _residuals_and_jacobian(x, points_w, obs, cam_rot, cam_trans)
        r_norm = jnp.linalg.norm(r, axis=-1)
        w = weights * _huber_weights(r_norm, huber_delta) * (1.0 - behind.astype(jnp.float32))
        jw = j * w[:, None, None]
        h = jnp.einsum("nai,naj->ij", jw, j) + damping * jnp.eye(6)
        g = jnp.einsum("nai,na->i", jw, r)
        # Unrolled Cholesky, not linalg.solve: the 6x6 LU's pivoting loops
        # run ~11x per tick (hypothesis batch + polish) on the scalar unit.
        delta = -linalg.spd_solve(h, g)
        # Guard: reject non-finite updates (singular systems).
        delta = jnp.where(jnp.all(jnp.isfinite(delta)), delta, jnp.zeros(6))
        return lie.se3_exp(delta) @ x

    x = jax.lax.fori_loop(0, iters, step, init_body_t_world)
    r, _, behind = _residuals_and_jacobian(x, points_w, obs, cam_rot, cam_trans)
    r_norm = jnp.linalg.norm(r, axis=-1) + behind * 1e3
    return x, r_norm


@partial(jax.jit, static_argnames=("num_hypotheses", "sample_size", "hyp_iters", "refine_iters"))
def ransac_pnp(
    key: jax.Array,
    points_w: jnp.ndarray,
    obs: jnp.ndarray,
    valid: jnp.ndarray,
    cam_rot: jnp.ndarray,
    cam_trans: jnp.ndarray,
    init_body_t_world: jnp.ndarray,
    num_hypotheses: int = 32,
    sample_size: int = 8,
    hyp_iters: int = 5,
    refine_iters: int = 6,
    inlier_threshold: float = 0.012,
    obs_weight: jnp.ndarray | None = None,
) -> PnPResult:
    """Batched-hypothesis robust PnP.

    Every hypothesis runs Gauss-Newton from ``init_body_t_world`` on a random
    ``sample_size``-subset of valid correspondences (all hypotheses solved in
    one vmap); the hypothesis with the most inliers seeds a final IRLS polish
    over its full inlier set.

    Args:
        key: PRNG key for hypothesis sampling.
        points_w: (N, 3) world landmarks.
        obs: (N, 2) normalized observations.
        valid: (N,) bool correspondence mask.
        cam_rot: (N, 3, 3) per-observation cam_T_body rotations.
        cam_trans: (N, 3) translations.
        init_body_t_world: (4, 4) motion-model / IMU pose prediction.
        num_hypotheses: Parallel RANSAC hypotheses (static).
        sample_size: Correspondences per hypothesis (static).
        hyp_iters: GN iterations per hypothesis (static).
        refine_iters: GN iterations for the final polish (static).
        inlier_threshold: Normalized-coordinate inlier gate
            (0.012 ~ 6 px at fx=500).
        obs_weight: Optional (N,) a-priori observation weights (inverse
            relative variance). Weighted observations contribute
            proportionally in the GN normal equations and covariance, and
            are sampled into RANSAC hypotheses proportionally (a
            log-weight shift of the Gumbel scores). Used for observation
            classes with larger expected error — e.g. mono-camera
            observations of stereo-triangulated landmarks, whose depth
            error projects laterally into the mono view. None = uniform.

    Returns:
        A :class:`PnPResult`.
    """
    n = points_w.shape[0]

    # Sample hypothesis subsets proportional to validity (gumbel top-k),
    # biased by log-weight when observation weights are supplied.
    gumbel = -jnp.log(-jnp.log(jax.random.uniform(key, (num_hypotheses, n)) + 1e-12) + 1e-12)
    if obs_weight is not None:
        gumbel = gumbel + jnp.log(jnp.maximum(obs_weight, 1e-6))[None, :]
    scores = jnp.where(valid[None, :], gumbel, -jnp.inf)
    # top-k as S rounds of (argmax, mask): S is tiny (6) so the
    # iterative form is ~free.
    iota_n = jnp.arange(n, dtype=jnp.int32)[None, :]
    cols = []
    for _ in range(sample_size):
        i = jnp.argmax(scores, axis=1).astype(jnp.int32)
        cols.append(i)
        scores = jnp.where(iota_n == i[:, None], -jnp.inf, scores)
    subset_idx = jnp.stack(cols, axis=1)  # (H, S)

    # Gather each hypothesis's subset and solve GN on (H, S) instead of
    # masking over (H, N): the gather is H*S ~ 100 rows (negligible)
    # while the per-iteration Jacobian work shrinks by
    # N/S ~ 170x. Weights still gate on validity in case fewer than S
    # correspondences are valid (top_k then picks -inf-scored rows).
    sub_pts = points_w[subset_idx]  # (H, S, 3)
    sub_obs = obs[subset_idx]  # (H, S, 2)
    sub_rot = cam_rot[subset_idx]  # (H, S, 3, 3)
    sub_tr = cam_trans[subset_idx]  # (H, S, 3)
    sub_w = valid[subset_idx].astype(jnp.float32)  # (H, S)
    if obs_weight is not None:
        sub_w = sub_w * obs_weight[subset_idx]

    def solve_one(pts, ob, w, rot, tr):
        x, _ = gauss_newton_pnp(pts, ob, w, rot, tr, init_body_t_world, iters=hyp_iters)
        return x

    hyp_poses = jax.vmap(solve_one)(sub_pts, sub_obs, sub_w, sub_rot, sub_tr)  # (H, 4, 4)

    def count_inliers(x):
        _, _, uv = project_points(x, points_w, cam_rot, cam_trans)
        err = jnp.linalg.norm(uv - obs, axis=-1)
        inl = (err <= inlier_threshold) & valid
        return jnp.sum(inl), inl

    counts, inlier_masks = jax.vmap(count_inliers)(hyp_poses)
    best = jnp.argmax(counts)
    best_pose = hyp_poses[best]
    best_inliers = inlier_masks[best]

    # Final polish on the winning inlier set.
    polish_w = best_inliers.astype(jnp.float32)
    if obs_weight is not None:
        polish_w = polish_w * obs_weight
    refined, r_norm = gauss_newton_pnp(
        points_w,
        obs,
        polish_w,
        cam_rot,
        cam_trans,
        best_pose,
        iters=refine_iters,
    )
    final_inliers = (r_norm <= inlier_threshold) & valid
    num = jnp.sum(final_inliers)
    rms = jnp.sqrt(
        jnp.sum(jnp.where(final_inliers, r_norm**2, 0.0)) / jnp.maximum(num, 1)
    )
    # If the polish lost inliers (degenerate), keep the better of the two.
    use_refined = jnp.sum(final_inliers) >= jnp.sum(best_inliers) // 2
    pose_out = jnp.where(use_refined, refined, best_pose)
    inl_out = jnp.where(use_refined, final_inliers, best_inliers)
    cov_w = inl_out.astype(jnp.float32)
    if obs_weight is not None:
        cov_w = cov_w * obs_weight
    cov = pose_covariance(pose_out, points_w, obs, cov_w, cam_rot, cam_trans)
    return PnPResult(
        body_t_world=pose_out,
        inliers=inl_out,
        num_inliers=jnp.sum(inl_out),
        rms_error=rms,
        covariance=cov,
    )
