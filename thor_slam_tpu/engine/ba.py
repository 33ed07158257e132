"""Sliding-window bundle adjustment: batched sparse Gauss-Newton with Schur.

The backend refinement cuVSLAM runs internally (closed CUDA). Design
(SURVEY.md §7.3 item 1 — the hard part): the window is a FIXED-shape
problem — K keyframe poses, L landmarks, observations as a dense masked
(K, C, L) tensor — so jit sees static shapes regardless of how many
landmarks actually exist. The classic BA sparsity is exploited
*algebraically*, not with sparse formats:

* landmark (3x3) blocks are batched-inverted in one shot;
* the Schur complement reduces to einsums over the (K, C, L) axes —
  dense contractions;
* the reduced camera system is a (6K x 6K) dense solve (K <= 16: trivial).

Gauge freedom is fixed by anchoring pose 0 (its delta is projected out).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from thor_slam_tpu.ops import lie


class BAProblem(NamedTuple):
    """A fixed-shape bundle-adjustment window.

    Attributes:
        body_t_world: (K, 4, 4) keyframe poses (world -> body).
        landmarks_w: (L, 3) landmark positions (world).
        obs: (K, C, L, 2) normalized observations (undistorted, raw-cam frame).
        obs_mask: (K, C, L) float 1/0 — which (keyframe, camera, landmark)
            triplets were actually observed.
        cam_rot: (C, 3, 3) cam_T_body rotations.
        cam_trans: (C, 3) cam_T_body translations.
        pose_mask: (K,) float 1/0 — which poses exist (window may be partial).
        lm_mask: (L,) float 1/0 — which landmark slots are real.
    """

    body_t_world: jnp.ndarray
    landmarks_w: jnp.ndarray
    obs: jnp.ndarray
    obs_mask: jnp.ndarray
    cam_rot: jnp.ndarray
    cam_trans: jnp.ndarray
    pose_mask: jnp.ndarray
    lm_mask: jnp.ndarray


class BAResult(NamedTuple):
    """Refined window plus diagnostics.

    Attributes:
        body_t_world: (K, 4, 4) refined poses.
        landmarks_w: (L, 3) refined landmarks.
        initial_rms: () float32 masked reprojection RMS before.
        final_rms: () float32 after.
    """

    body_t_world: jnp.ndarray
    landmarks_w: jnp.ndarray
    initial_rms: jnp.ndarray
    final_rms: jnp.ndarray


def _inv3x3(m: jnp.ndarray) -> jnp.ndarray:
    """Batched closed-form 3x3 inverse (adjugate / determinant).

    jnp.linalg.inv lowers small batched inverses to LU with sequential
    pivoting; the adjugate is dense vector math. Inputs here are
    damped SPD blocks, so the determinant is safely positive.
    """
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co00 = e * i - f * h
    co01 = c * h - b * i
    co02 = b * f - c * e
    co10 = f * g - d * i
    co11 = a * i - c * g
    co12 = c * d - a * f
    co20 = d * h - e * g
    co21 = b * g - a * h
    co22 = a * e - b * d
    det = a * co00 + b * co10 + c * co20
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-20, det, 1e-20)
    adj = jnp.stack(
        [
            jnp.stack([co00, co01, co02], axis=-1),
            jnp.stack([co10, co11, co12], axis=-1),
            jnp.stack([co20, co21, co22], axis=-1),
        ],
        axis=-2,
    )
    return adj * inv_det[..., None, None]


def _residuals_jacobians(poses, landmarks, obs, cam_rot, cam_trans):
    """Dense residuals + Jacobians over the full (K, C, L) grid.

    Returns r (K,C,L,2), j_pose (K,C,L,2,6), j_lm (K,C,L,2,3), behind mask.
    """
    # p_b[k, l] = R_k p_l + t_k
    p_b = jnp.einsum("kij,lj->kli", poses[:, :3, :3], landmarks) + poses[:, None, :3, 3]
    # p_c[k, c, l] = R_c p_b + t_c
    p_c = jnp.einsum("cij,klj->kcli", cam_rot, p_b) + cam_trans[None, :, None, :]
    z = jnp.maximum(p_c[..., 2], 1e-6)
    uv = p_c[..., :2] / z[..., None]
    r = uv - obs  # (K, C, L, 2)

    inv_z = 1.0 / z
    x, y = p_c[..., 0], p_c[..., 1]
    zero = jnp.zeros_like(inv_z)
    j_proj = jnp.stack(
        [
            jnp.stack([inv_z, zero, -x * inv_z * inv_z], axis=-1),
            jnp.stack([zero, inv_z, -y * inv_z * inv_z], axis=-1),
        ],
        axis=-2,
    )  # (K, C, L, 2, 3)

    # d p_b / d delta_k = [I | -hat(p_b)]  (left-multiplicative se3 on pose k)
    hat_pb = jax.vmap(jax.vmap(lie.hat))(p_b)  # (K, L, 3, 3)
    eye3 = jnp.broadcast_to(jnp.eye(3), hat_pb.shape)
    dpb = jnp.concatenate([eye3, -hat_pb], axis=-1)  # (K, L, 3, 6)
    # d p_c / d delta_k = R_c @ dpb -> (K, C, L, 3, 6)
    dpc_pose = jnp.einsum("cij,kljm->kclim", cam_rot, dpb)
    j_pose = jnp.einsum("kclai,kclim->kclam", j_proj, dpc_pose)  # (K,C,L,2,6)

    # d p_c / d p_l = R_c R_k -> (K, C, 3, 3), broadcast over landmarks.
    rc_rk = jnp.einsum("cij,kjm->kcim", cam_rot, poses[:, :3, :3])
    j_lm = jnp.einsum("kclai,kcim->kclam", j_proj, rc_rk)  # (K,C,L,2,3)

    behind = p_c[..., 2] <= 1e-4
    return r, j_pose, j_lm, behind


def _masked_rms(r, w):
    num = jnp.sum(w * jnp.sum(r * r, axis=-1))
    cnt = jnp.maximum(jnp.sum(w), 1.0)
    return jnp.sqrt(num / cnt)


@partial(jax.jit, static_argnames=("iters",))
def bundle_adjust(
    problem: BAProblem,
    iters: int = 5,
    huber_delta: float = 0.01,
    damping: float = 1e-4,
    landmark_damping: float = 1e-3,
) -> BAResult:
    """Run fixed-iteration Schur-complement Gauss-Newton on a window.

    Args:
        problem: The window (see :class:`BAProblem`).
        iters: GN iterations (static).
        huber_delta: Huber kernel width (normalized coords).
        damping: Levenberg damping for the reduced camera system.
        landmark_damping: Damping added to landmark 3x3 blocks.

    Returns:
        A :class:`BAResult`.
    """
    with jax.default_matmul_precision("float32"):
        return _bundle_adjust_f32(problem, iters, huber_delta, damping, landmark_damping)


def _bundle_adjust_f32(problem, iters, huber_delta, damping, landmark_damping):
    # Full-f32 matmuls: bf16 operands quantize meter-scale coordinates to
    # ~8 mm inside the residual/Jacobian einsums (see tracker.track_step).
    k, c, l = problem.obs_mask.shape

    def rms_of(poses, landmarks):
        r, _, _, behind = _residuals_jacobians(
            poses, landmarks, problem.obs, problem.cam_rot, problem.cam_trans
        )
        w = problem.obs_mask * (1.0 - behind)
        return _masked_rms(r, w)

    def step(_, carry):
        poses, landmarks = carry
        r, j_p, j_l, behind = _residuals_jacobians(
            poses, landmarks, problem.obs, problem.cam_rot, problem.cam_trans
        )
        r_norm = jnp.linalg.norm(r, axis=-1)
        huber = jnp.where(r_norm <= huber_delta, 1.0, huber_delta / jnp.maximum(r_norm, 1e-12))
        w = problem.obs_mask * huber * (1.0 - behind)  # (K, C, L)

        jp_w = j_p * w[..., None, None]
        jl_w = j_l * w[..., None, None]

        # Blocks.
        h_pp = jnp.einsum("kclai,kclaj->kij", jp_w, j_p)  # (K, 6, 6)
        h_ll = jnp.einsum("kclai,kclaj->lij", jl_w, j_l)  # (L, 3, 3)
        h_pl = jnp.einsum("kclai,kclaj->klij", jp_w, j_l)  # (K, L, 6, 3)
        g_p = jnp.einsum("kclai,kcla->ki", jp_w, r)  # (K, 6)
        g_l = jnp.einsum("kclai,kcla->li", jl_w, r)  # (L, 3)

        # Invert landmark blocks (batched 3x3, damped; empty slots -> ~0
        # update). Closed-form adjugate, NOT jnp.linalg.inv: batched LU
        # lowers to sequential pivoting loops while the adjugate is ~20
        # dense elementwise ops over the (L, 3, 3) batch.
        h_ll = h_ll + landmark_damping * jnp.eye(3)
        h_ll_inv = _inv3x3(h_ll) * problem.lm_mask[:, None, None]

        # Schur complement: S = Hpp - Hpl Hll^-1 Hlp (dense 6K x 6K).
        hpl_hinv = jnp.einsum("klij,ljm->klim", h_pl, h_ll_inv)  # (K, L, 6, 3)
        s_off = jnp.einsum("klim,qlnm->kqin", hpl_hinv, h_pl)  # (K, K, 6, 6)
        # Diagonal insertions as dense masked adds, not an `.at[diag].add`
        # scatter.
        eye_k = jnp.eye(k)[:, :, None, None]
        s = -s_off + eye_k * h_pp[:, None]
        b = g_p - jnp.einsum("klim,lm->ki", hpl_hinv, g_l)  # (K, 6)

        # Gauge + missing poses: project out pose 0 and masked poses.
        free = problem.pose_mask.at[0].set(0.0)  # (K,)
        sel = (free[:, None] * free[None, :])[:, :, None, None]
        s = s * sel + eye_k * ((1.0 - free)[:, None, None, None] * jnp.eye(6))
        b = b * free[:, None]

        s_mat = s.transpose(0, 2, 1, 3).reshape(k * 6, k * 6) + damping * jnp.eye(k * 6)
        # The 60x60 LU is NOT the per-iteration bottleneck (measured: a
        # Jacobi-CG replacement was time-neutral); keep the exact solve.
        delta_p = -jnp.linalg.solve(s_mat, b.reshape(k * 6)).reshape(k, 6)
        delta_p = jnp.where(jnp.all(jnp.isfinite(delta_p)), delta_p, jnp.zeros_like(delta_p))

        # Back-substitute landmarks: dl = -Hll^-1 (g_l + Hlp^T dp).
        hlp_dp = jnp.einsum("klij,ki->lj", h_pl, delta_p)  # (L, 3)
        delta_l = -jnp.einsum("lij,lj->li", h_ll_inv, g_l + hlp_dp)
        delta_l = jnp.where(jnp.isfinite(delta_l), delta_l, 0.0) * problem.lm_mask[:, None]

        poses = jax.vmap(lambda d, x: lie.se3_exp(d) @ x)(delta_p, poses)
        landmarks = landmarks + delta_l
        return (poses, landmarks)

    initial_rms = rms_of(problem.body_t_world, problem.landmarks_w)
    poses, landmarks = jax.lax.fori_loop(
        0, iters, step, (problem.body_t_world, problem.landmarks_w)
    )
    final_rms = rms_of(poses, landmarks)

    # Reject a diverged solve outright (keeps the backend safe to call).
    ok = final_rms <= initial_rms
    poses = jnp.where(ok, poses, problem.body_t_world)
    landmarks = jnp.where(ok, landmarks, problem.landmarks_w)
    return BAResult(
        body_t_world=poses,
        landmarks_w=landmarks,
        initial_rms=initial_rms,
        final_rms=jnp.where(ok, final_rms, initial_rms),
    )
