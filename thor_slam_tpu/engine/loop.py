"""Loop closure: appearance-based detection + geometric verification.

The place-recognition role of cuVSLAM's loop closure (reference exposes it
only as the ``enable_loop_closure`` flag, launch/thor_visual_slam.launch.py).
Design:

* **Detection** is one matmul: every keyframe's binary descriptors are
  kept as ±1 vectors; the similarity of the query keyframe against the
  whole database is a (N x 256) @ (256 x K*N) contraction followed by
  per-keyframe vote counting. No tree/BoW index — at rig scale (hundreds
  of keyframes x 512 descriptors) a brute-force dense contraction is
  faster than any index walk.
* **Verification** reuses the batched RANSAC PnP: the candidate keyframe's
  stored landmarks against the query's observations; a loop is accepted
  only with a strong inlier consensus.

The accepted relative pose becomes a pose-graph edge
(:mod:`thor_slam_tpu.engine.posegraph`).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from thor_slam_tpu.engine import pnp
from thor_slam_tpu.ops import match as match_ops
from thor_slam_tpu.ops.brief import NUM_BITS
from thor_slam_tpu.ops.match import unpack_to_signs


class LoopCandidate(NamedTuple):
    """Result of appearance-based lookup.

    Attributes:
        keyframe: () int32 best database keyframe index.
        votes: () int32 matched-descriptor votes for it.
        all_votes: (K,) int32 votes per database keyframe.
    """

    keyframe: jnp.ndarray
    votes: jnp.ndarray
    all_votes: jnp.ndarray


@partial(jax.jit, static_argnames=("match_threshold",))
def find_candidate(
    query_desc: jnp.ndarray,
    query_valid: jnp.ndarray,
    db_desc: jnp.ndarray,
    db_valid: jnp.ndarray,
    db_mask: jnp.ndarray,
    match_threshold: int = 48,
) -> LoopCandidate:
    """Vote for the database entry that shares the most descriptors.

    Args:
        query_desc: (N, 8) uint32 query keyframe descriptors.
        query_valid: (N,) bool.
        db_desc: (K, N, 8) uint32 database descriptors. An entry is one
            (keyframe, camera) signature — the multi-camera place DB
            folds its camera axis into K (see ``LoopBackend``).
        db_valid: (K, N) bool.
        db_mask: (K,) float 1/0 — entries eligible (temporal gating:
            exclude recent neighbors on the host).
        match_threshold: Hamming distance under which a descriptor pair
            votes.

    Returns:
        A :class:`LoopCandidate`.

    The DB is processed in blocks of entries (``lax.map``): the raw
    query-vs-DB Hamming matrix is (N, K*N) — at an all-camera DB
    (K = capacity * num_cams, e.g. 1024 entries x 512 kp) materializing
    it whole is a ~1 GB transient. Blocking bounds the peak to the block
    while each block is still one dense contraction.
    """
    k, n, _ = db_desc.shape
    q = unpack_to_signs(query_desc)  # (N, 256) bf16 +/-1
    qv = query_valid

    block = 32
    while k % block:  # K is a power-of-two capacity times C in practice
        block //= 2

    def block_votes(args):
        d_blk, v_blk = args  # (B, N, 8), (B, N)
        b = d_blk.shape[0]
        d = unpack_to_signs(d_blk.reshape(b * n, 8))  # (B*N, 256)
        corr = jax.lax.dot_general(
            q, d, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
        )  # (N, B*N)
        ham = 0.5 * (NUM_BITS - corr)
        ham = jnp.where(qv[:, None] & v_blk.reshape(1, b * n), ham, 1e9)
        # Per query descriptor: its best match within each entry.
        best_per_kf = jnp.min(ham.reshape(n, b, n), axis=-1)  # (N, B)
        return jnp.sum(best_per_kf <= match_threshold, axis=0)  # (B,)

    votes = jax.lax.map(
        block_votes,
        (
            db_desc.reshape(k // block, block, n, 8),
            db_valid.reshape(k // block, block, n),
        ),
    ).reshape(k)
    votes = jnp.where(db_mask > 0, votes, -1)
    best = jnp.argmax(votes)
    return LoopCandidate(keyframe=best, votes=votes[best], all_votes=votes)


class LoopVerification(NamedTuple):
    """Geometric check of a loop candidate.

    Attributes:
        accepted: () bool.
        body_t_candidate: (4, 4) — the query body pose expressed in the
            candidate keyframe's world anchor (for the pose-graph edge).
        num_inliers: () int32.
        rms_error: () float32 inlier reprojection RMS (normalized coords).
        covariance: (6, 6) tangent covariance of the verification solve —
            the loop constraint's own noise floor. The engine gates closure
            on the odometry discrepancy exceeding this floor (a constraint
            that cannot distinguish the drift from its own noise has
            nothing to correct).
    """

    accepted: jnp.ndarray
    body_t_candidate: jnp.ndarray
    num_inliers: jnp.ndarray
    rms_error: jnp.ndarray
    covariance: jnp.ndarray


@partial(jax.jit, static_argnames=("min_inliers",))
def verify_candidate(
    key: jax.Array,
    cand_lm_w: jnp.ndarray,
    cand_lm_valid: jnp.ndarray,
    cand_desc: jnp.ndarray,
    query_obs_norm: jnp.ndarray,
    query_desc: jnp.ndarray,
    query_valid: jnp.ndarray,
    cam_rot: jnp.ndarray,
    cam_trans: jnp.ndarray,
    init_body_t_world: jnp.ndarray,
    min_inliers: int = 40,
    inlier_threshold: float = 0.01,
) -> LoopVerification:
    """Descriptor-match the query against the candidate, then RANSAC PnP.

    All arrays are single-camera slices (loop closure verifies on the
    camera that produced the candidate votes); the candidate's landmarks
    are in the world frame of its own (drifted) trajectory — the resulting
    pose is the loop constraint.
    """
    m = match_ops.match_descriptors(
        query_desc, query_valid, cand_desc, cand_lm_valid, ratio=0.9
    )
    lm = cand_lm_w[m.idx]
    lm_ok = cand_lm_valid[m.idx] & m.valid

    n = query_desc.shape[0]
    rot = jnp.broadcast_to(cam_rot, (n, 3, 3))
    trans = jnp.broadcast_to(cam_trans, (n, 3))
    result = pnp.ransac_pnp(
        key, lm, query_obs_norm, lm_ok, rot, trans, init_body_t_world,
        num_hypotheses=48, sample_size=6, inlier_threshold=inlier_threshold,
    )
    accepted = result.num_inliers >= min_inliers
    return LoopVerification(
        accepted=accepted,
        body_t_candidate=result.body_t_world,
        num_inliers=result.num_inliers,
        rms_error=result.rms_error,
        covariance=result.covariance,
    )
