"""The multi-camera visual-odometry tracker: one fused jitted step.

This is the compute heart of the framework — the replacement for cuVSLAM's
tracking pipeline (closed CUDA; reference launch/thor_visual_slam.launch.py).
One `track_step` call consumes the synchronized rig tick as a single dense
tensor (C cameras x 2 stereo images) and produces the body pose:

    rectify -> FAST -> BRIEF -> [stereo match -> triangulate]
                              -> [temporal match -> RANSAC PnP]
                              -> keyframe landmark refresh

Everything runs under one jit with static shapes: per-camera work is
`vmap`-ed over the camera axis (the natural data-parallel axis of the rig —
see SURVEY.md §2.4), keyframe decisions are `jnp.where` selections, RANSAC
is a vmapped hypothesis batch. The host never sees intermediate tensors.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp

from thor_slam_tpu.engine import pnp, triangulate
from thor_slam_tpu.ops import brief, fast, klt, match
from thor_slam_tpu.ops import stereo as stereo_ops
from thor_slam_tpu.ops import calib
from thor_slam_tpu.ops.image import downsample2, gaussian_blur


@dataclass(frozen=True)
class TrackerParams:
    """Static tracker configuration (hashable: participates in jit keys)."""

    num_cams: int
    height: int
    width: int
    max_keypoints: int = 512
    fast_threshold: float = 0.05
    cell_size: int = 32
    per_cell: int = 8
    border_margin: int = 20
    match_max_distance: float = 64.0
    match_ratio: float = 0.95
    stereo_max_dy: float = 1.5
    max_disparity_px: float = 100.0
    klt_radius: int = 4
    klt_iters: int = 3
    klt_levels: int = 2
    klt_max_residual: float = 0.08
    persist_radius_px: float = 2.0  # keypoint inherits a landmark within this
    min_disparity: float = 0.25
    max_depth_m: float = 40.0
    ransac_hypotheses: int = 16
    ransac_sample_size: int = 6
    inlier_threshold_px: float = 3.0  # pixels; normalized per-camera by fx
    keyframe_min_inliers: int = 50
    keyframe_max_translation: float = 0.12
    keyframe_max_rotation: float = 0.12
    # Minimum ticks between LOW-INLIER-triggered keyframes (motion
    # triggers are exempt). A refresh fired on decayed support re-mints
    # the bank through the persist_radius inheritance gate; when the
    # scene cannot supply fresh landmark sources (sensor blackout, dark
    # or textureless stretch) each re-mint only LOSES slots — measured:
    # an un-rate-limited low-inlier trigger fired every tick of a stereo
    # blackout and decayed the surviving mono bank 73 -> 13 slots in 12
    # ticks, tripling the drift the surviving camera should have
    # prevented.
    keyframe_low_inlier_interval: int = 8
    min_track_inliers: int = 12
    restart_after_untracked: int = 5  # lost streak before VO restarts
    oriented_descriptors: bool = False  # upright BRIEF: precise, VO-friendly
    # 3x3 median prefilter on every input image (ops/image.median3x3).
    # Exact salt-and-pepper / dead-pixel rejection: measured 32.6 -> 13.7 cm
    # flagship ATE under 2% salt; off by default (clean sensors lose a few
    # mm of corner localization to any prefilter). YAML: backend.tracker.
    median_prefilter: bool = False
    # Mono-camera support (reference accepts non-stereo sources: its
    # num_cameras counts 2 per stereo + 1 per mono, ref run_slam.py:112-114
    # and the mono capture path luxonis.py:551-568). Mono cameras never
    # triangulate; at keyframes their detections SEED from landmarks the
    # stereo cameras just minted (projection + descriptor gate) and then
    # contribute KLT observations + PnP constraints like any other camera.
    has_mono: bool = False  # static: traces the seeding block only if set
    mono_seed_radius_px: float = 3.0
    mono_seed_max_hamming: float = 64.0
    # Window-BA weight of mono cameras' observations (TrackBA.bind).
    # The TRACKER's PnP uses PER-LANDMARK weights instead: each seeded
    # landmark carries the variance of its source stereo camera's
    # triangulation DEPTH error projected into the mono camera's view
    # (computed at seeding in mint_bank, stored in ``lm_weight``). The
    # error is along-ray — hence ~invisible — in the source camera but
    # projects laterally into the mono view, scaled by the sine of the
    # inter-ray angle over the mono range; a single global scalar both
    # over-weights badly-placed landmarks and under-weights well-placed
    # ones (measured: the global 0.25 left the mono camera net-neutral).
    mono_obs_weight: float = 0.25
    mono_seed_disp_sigma_px: float = 0.4  # stereo subpixel disparity std
    # ALL-mono rig support (no stereo source anywhere — the cuVSLAM
    # mono-only capability, reference luxonis.py:551-568). STATIC: traces
    # the pending-landmark machinery only when set. Landmarks then come
    # from MOTION: the first map from a two-view essential-matrix
    # bootstrap (engine/epipolar.py, dispatched by the engine via
    # make_mono_init), steady-state minting from midpoint triangulation
    # of each pending detection between its minting keyframe and the
    # next (mint_bank). Scale is unobservable: unit-|t| bootstrap gauge.
    mono_bootstrap: bool = False
    mono_init_min_inliers: int = 40  # E-RANSAC support to accept the boot
    mono_trigger_parallax: float = 0.02  # mean 2D displacement to attempt
    mono_min_parallax: float = 0.01  # per-point triangulation ray angle
    mono_reboot_min_tracks: int = 30  # below this, re-mint fresh anchors


class CameraSetup(NamedTuple):
    """Per-camera constants (stacked over the camera axis C).

    The tracker never remaps images (no full-frame gather); geometry is
    applied to *coordinates*: keypoints are undistorted/
    rectified analytically and landmark predictions are projected through
    the forward distortion model. The per-camera reference frame is the RAW
    left camera.

    Attributes:
        k_left/k_right: (C, 4) raw intrinsics (fx, fy, cx, cy) per imager.
        dist_left/dist_right: (C, 5) plumb-bob distortion coefficients.
        rect_left/rect_right: (C, 3, 3) rotations raw-cam -> rectified-cam
            (for epipolar-aligned stereo coordinates).
        k_rect: (C, 3) rectified intrinsics (f, cx, cy).
        baseline: (C,) rectified stereo baselines (meters).
        cam_r_body: (C, 3, 3) rotation body -> raw-left-cam.
        cam_t_body: (C, 3) translation of the same transform.
        body_t_cam: (C, 4, 4) inverse (raw-left-cam -> body).
        cam_r_body_right/cam_t_body_right: body -> raw-RIGHT-cam transforms
            (the BA backend keeps the stereo constraint by including right-
            camera observations).
        stereo_mask: (C,) bool — True for stereo sources. Mono sources
            carry duplicated left geometry in the right-imager fields and
            a placeholder baseline; every stereo product (triangulation,
            right observations) is masked off for them.
    """

    k_left: jnp.ndarray
    k_right: jnp.ndarray
    dist_left: jnp.ndarray
    dist_right: jnp.ndarray
    rect_left: jnp.ndarray
    rect_right: jnp.ndarray
    k_rect: jnp.ndarray
    baseline: jnp.ndarray
    cam_r_body: jnp.ndarray
    cam_t_body: jnp.ndarray
    body_t_cam: jnp.ndarray
    cam_r_body_right: jnp.ndarray
    cam_t_body_right: jnp.ndarray
    stereo_mask: jnp.ndarray


class TrackerState(NamedTuple):
    """Device-resident tracker state (a pytree; fixed shapes).

    Attributes:
        world_t_body: (4, 4) current pose estimate.
        prev_world_t_body: (4, 4) previous pose (constant-velocity model).
        velocity_w: (3,) world-frame velocity estimate.
        lm_pos_w: (C, N, 3) active landmark positions (world).
        lm_desc: (C, N, 8) uint32 landmark descriptors at creation (kept
            for relocalization / loop closure, not per-frame tracking).
        lm_valid: (C, N) bool.
        lm_px: (C, N, 2) each landmark's pixel position in the previous
            left frame (the KLT template anchor).
        lm_obs_px: (C, N, 2) the landmark's best *observation* in the
            latest frame — the KLT-tracked position for inherited landmarks
            (subpixel-consistent with their 3D position), the detector
            position for fresh ones. This is what the BA backend consumes;
            ``lm_px`` (the KLT template anchor) is always the detector
            position at the keyframe.
        lm_id: (C, N) int32 persistent landmark identities — slots change at
            keyframe refreshes, ids survive inheritance (the join key for
            the sliding-window bundle adjustment backend).
        lm_id_counter: () int32 next fresh landmark id.
        kf_world_t_body: (4, 4) pose of the keyframe that created the
            active landmarks.
        prev_left0/1/2: Previous left-image pyramid (KLT templates).
        frame_idx: () int32.
        untracked_streak: () int32 consecutive failed-tracking frames.
        key: PRNG key for RANSAC sampling.
        lm_pending: (C, N) bool — slot is KLT-tracked in 2D but has NO 3D
            position yet (all-mono rigs only: fresh mono detections await
            motion triangulation; ``mono_bootstrap``). Pending slots are
            excluded from PnP and from the reported landmark count; they
            persist/track like any slot and are promoted at the next
            keyframe (or by the essential-matrix bootstrap).
        lm_anchor_px: (C, N, 2) the slot's observation at its minting
            keyframe — the FROZEN first ray of the two-view pair
            (``kf_world_t_body`` is the matching pose). Only meaningful
            for pending slots; refreshed at every keyframe.
        lm_weight: (C, N) per-landmark PnP observation weight (inverse
            relative variance; 1.0 for stereo-triangulated landmarks,
            the projected-depth-error weight for mono-seeded ones — see
            ``TrackerParams.mono_obs_weight`` docs and ``mint_bank``).
        last_kf_frame: () int32 frame index of the last refresh (rate-
            limits the low-inlier keyframe trigger —
            ``keyframe_low_inlier_interval``).
    """

    world_t_body: jnp.ndarray
    prev_world_t_body: jnp.ndarray
    velocity_w: jnp.ndarray
    lm_pos_w: jnp.ndarray
    lm_desc: jnp.ndarray
    lm_valid: jnp.ndarray
    lm_px: jnp.ndarray
    lm_obs_px: jnp.ndarray
    lm_robs_px: jnp.ndarray
    lm_robs_valid: jnp.ndarray
    lm_id: jnp.ndarray
    lm_id_counter: jnp.ndarray
    kf_world_t_body: jnp.ndarray
    prev_left0: jnp.ndarray
    prev_left1: jnp.ndarray
    prev_left2: jnp.ndarray
    frame_idx: jnp.ndarray
    untracked_streak: jnp.ndarray
    key: jax.Array
    lm_pending: jnp.ndarray
    lm_anchor_px: jnp.ndarray
    lm_weight: jnp.ndarray
    last_kf_frame: jnp.ndarray


class TrackOutput(NamedTuple):
    """Per-step diagnostics surfaced to the host.

    Attributes:
        world_t_body: (4, 4) solved pose.
        num_inliers: () int32 PnP inliers.
        num_matches: () int32 temporal 2D-3D correspondences attempted.
        num_landmarks: () int32 active landmarks after this step.
        rms_error: () float32 normalized-coordinate reprojection RMS.
        refreshed: () bool — landmarks were re-triangulated (keyframe).
        obs_norm: (C, N, 2) this tick's landmark observations as
            undistorted normalized LEFT-camera coordinates (post-branch
            bank: KLT tracks on continue ticks, detections on keyframes) —
            the per-tick measurement stream the track-level BA backend
            consumes, joined across ticks by ``lm_id``.
        robs_norm: (C, N, 2) normalized RIGHT-camera observations. Only a
            fresh measurement on ``refreshed`` ticks (the stereo match at
            landmark minting); on continue ticks it repeats the minting
            keyframe's value and must not be re-used as a new measurement.
        lm_id: (C, N) int32 persistent landmark identities (the join key).
        lm_valid: (C, N) bool — slots actually observed this tick.
        robs_valid: (C, N) bool — slots with a valid stereo right match.
        covariance: (6, 6) world-frame pose covariance, ordered
            [position(3), orientation(3)] — the PnP solve's residual-scaled
            inverse Hessian rotated into the world frame (both blocks by
            ``world_t_body[:3,:3]``: a left-tangent perturbation
            ``exp([rho,phi]) @ body_t_world`` moves the world position by
            ``-R_wb rho`` and the world orientation by ``-R_wb phi``).
            Large (1e6 diag) on untracked ticks. The reference's engine
            publishes exactly this 6x6 and derives confidence
            = 1/(1+trace) from it (reference isaac_ros.py:308-325).
    """

    world_t_body: jnp.ndarray
    num_inliers: jnp.ndarray
    num_matches: jnp.ndarray
    num_landmarks: jnp.ndarray
    rms_error: jnp.ndarray
    refreshed: jnp.ndarray
    covariance: jnp.ndarray
    obs_norm: jnp.ndarray
    robs_norm: jnp.ndarray
    lm_id: jnp.ndarray
    lm_valid: jnp.ndarray
    robs_valid: jnp.ndarray


def init_state(params: TrackerParams, world_t_body0=None, key=None) -> TrackerState:
    """Fresh tracker state (no landmarks, pose at ``world_t_body0``)."""
    c, n = params.num_cams, params.max_keypoints
    h, w = params.height, params.width
    pose0 = jnp.eye(4) if world_t_body0 is None else jnp.asarray(world_t_body0, jnp.float32)
    # Distinct buffers per pose field: the engine's step donates the state,
    # and donating one buffer referenced by several fields is an error
    # ("attempt to donate the same buffer twice").
    return TrackerState(
        world_t_body=pose0,
        prev_world_t_body=jnp.array(pose0, copy=True),
        velocity_w=jnp.zeros(3),
        lm_pos_w=jnp.zeros((c, n, 3)),
        lm_desc=jnp.zeros((c, n, 8), jnp.uint32),
        lm_valid=jnp.zeros((c, n), bool),
        lm_px=jnp.zeros((c, n, 2)),
        lm_obs_px=jnp.zeros((c, n, 2)),
        lm_robs_px=jnp.zeros((c, n, 2)),
        lm_robs_valid=jnp.zeros((c, n), bool),
        lm_id=-jnp.ones((c, n), jnp.int32),
        lm_id_counter=jnp.asarray(0, jnp.int32),
        kf_world_t_body=jnp.array(pose0, copy=True),
        prev_left0=jnp.zeros((c, h, w)),
        prev_left1=jnp.zeros((c, h // 2, w // 2)),
        prev_left2=jnp.zeros((c, h // 4, w // 4)),
        frame_idx=jnp.asarray(0, jnp.int32),
        untracked_streak=jnp.asarray(0, jnp.int32),
        key=jax.random.PRNGKey(0) if key is None else key,
        lm_pending=jnp.zeros((c, n), bool),
        lm_anchor_px=jnp.zeros((c, n, 2)),
        lm_weight=jnp.ones((c, n)),
        last_kf_frame=jnp.asarray(0, jnp.int32),
    )


def _se3_inv(m):
    r = m[:3, :3]
    t = m[:3, 3]
    return jnp.eye(4).at[:3, :3].set(r.T).at[:3, 3].set(-r.T @ t)


def track_step(
    params: TrackerParams,
    setup: CameraSetup,
    state: TrackerState,
    images: jnp.ndarray,
    pose_prediction: jnp.ndarray | None = None,
    cam_active: jnp.ndarray | None = None,
    allow_refresh: bool = True,
    half_res: bool = False,
) -> tuple[TrackerState, TrackOutput]:
    """One VO tick. Call under jit with ``params`` static.

    Args:
        params: Static configuration.
        setup: Per-camera constants.
        state: Current tracker state.
        images: (C, 2, H, W) float32 frames in [0, 1] (left, right) — or
            (C, 1, H, W) left-only on LIGHT ticks (``allow_refresh=False``).
        pose_prediction: Optional (4, 4) world_T_body prediction (e.g. from
            IMU preintegration); defaults to a constant-velocity model.
        cam_active: Optional (C,) bool — cameras the rig watchdog considers
            live. A dead camera's image is stale/frozen, so its KLT tracks
            would be plausible-looking zero-motion observations that bias
            PnP toward "no movement"; masking here removes them from the
            solve and from landmark refreshes. None means all active (and
            traces a mask-free graph — the common case pays nothing).
        allow_refresh: STATIC. False = a LIGHT tick: the keyframe branch
            (detect/describe/stereo/triangulate — the only consumer of the
            right images) is not even traced, the bank persists, and the
            tick consumes left images only. Non-keyframe ticks never touch
            the right image, so the host can halve its per-tick upload
            bytes by shipping (C, 1, H, W) on ticks it schedules as light —
            the hot KLT/PnP path is bit-identical to a full tick that
            chose not to refresh (the upload-bound deployment lever; see
            ``TpuSlamEngine`` ``light_ticks``).
        half_res: STATIC. The host shipped images 2x-downsampled (2x2
            mean); the step bilinearly upsamples them back to (H, W) on
            device and runs the identical full-resolution pipeline — the
            state pytree, landmark pixel coordinates, and all output
            shapes are unchanged. Level-0 KLT refinement then operates
            on a signal without the finest octave, costing some subpixel
            precision for 1/4 the upload bytes (the knob for
            upload-bound links; see ``TpuSlamEngine`` ``light_half_res``
            for the measured ATE impact).

    Returns:
        (new_state, output).
    """
    # Full-f32 matmuls throughout the tick: reduced-precision operands
    # (bf16, or TF32 on NVIDIA GPUs) quantize meter-scale world coordinates
    # to mm and image intensities to the pixel quantum inside every einsum
    # — bf16 operands measured 8x worse trajectory ATE than f32. The FLOP cost is noise
    # here (the tick's matmuls are small); kernels that WANT bf16 for
    # throughput (SGM aggregation, Hamming matching) set it explicitly.
    with jax.default_matmul_precision("float32"):
        return _track_step_f32(
            params, setup, state, images, pose_prediction, cam_active,
            allow_refresh, half_res,
        )


def _track_step_f32(
    params: TrackerParams,
    setup: CameraSetup,
    state: TrackerState,
    images: jnp.ndarray,
    pose_prediction: jnp.ndarray | None = None,
    cam_active: jnp.ndarray | None = None,
    allow_refresh: bool = True,
    half_res: bool = False,
) -> tuple[TrackerState, TrackOutput]:
    p = params
    # uint8 frames normalize ON DEVICE: the host ships 1/4 the bytes and
    # skips a large float conversion (measured 300-600 ms/tick at 4x720p on
    # a weak host CPU; the conversion is one fused elementwise op here).
    if images.dtype == jnp.uint8:
        images = images.astype(jnp.float32) * (1.0 / 255.0)
    if half_res:
        # 2x bilinear upsample back to the pipeline's resolution. The 2x2
        # mean the host applied and 'linear' both use half-pixel-center
        # alignment, so the round trip introduces no geometric shift.
        c_, s_, h2, w2 = images.shape
        images = jax.image.resize(
            images, (c_, s_, 2 * h2, 2 * w2), method="linear"
        )
    if p.median_prefilter:
        # (C, S, H, W) -> per-image exact 3x3 median (see TrackerParams).
        from thor_slam_tpu.ops.image import median3x3

        images = jax.vmap(jax.vmap(median3x3))(images)

    # ------------------------------------------------------------------ 6
    # Pose prediction. Two distinct uses with different failure modes:
    # * the KLT initialization wants motion compensation (constant-velocity
    #   or IMU) — a few-pixel error is harmless, LK converges locally;
    # * the PnP initialization must NOT be the extrapolated estimate when it
    #   derives from our own output: extrapolating the last solve doubles
    #   its error and the fixed-iteration solver then under-corrects,
    #   compounding geometrically (measured: ~1.5x rotation error per frame).
    #   An externally supplied prediction (IMU preintegration) is fine.
    if pose_prediction is None:
        delta = state.world_t_body @ _se3_inv(state.prev_world_t_body)
        extrapolated = delta @ state.world_t_body
        klt_prediction = jnp.where(
            state.untracked_streak > 0, state.world_t_body, extrapolated
        )
        init_body_t_world = _se3_inv(state.world_t_body)  # last solved pose
    else:
        klt_prediction = pose_prediction
        init_body_t_world = _se3_inv(pose_prediction)
    klt_body_t_world = _se3_inv(klt_prediction)

    hot = run_hot_frontend(params, setup, state, images, klt_body_t_world)
    if cam_active is not None:
        hot = hot._replace(
            corr_valid=hot.corr_valid & cam_active[:, None],
            tracks_valid=hot.tracks_valid & cam_active[:, None],
        )

    c, n = p.num_cams, p.max_keypoints
    flat_pts = state.lm_pos_w.reshape(c * n, 3)
    flat_obs = hot.obs_norm.reshape(c * n, 2)
    pnp_valid = hot.corr_valid
    if p.mono_bootstrap:
        # Pending slots are 2D-only — no 3D position to constrain PnP.
        pnp_valid = pnp_valid & ~state.lm_pending
    flat_valid = pnp_valid.reshape(c * n)
    flat_rot = jnp.repeat(setup.cam_r_body, n, axis=0)  # (C*N, 3, 3)
    flat_trans = jnp.repeat(setup.cam_t_body, n, axis=0)
    obs_weight = None
    if p.has_mono:
        # Per-landmark weights (mono-seeded slots carry their projected
        # triangulation-error variance; stereo slots are 1.0 — minted so
        # in mint_bank).
        obs_weight = state.lm_weight.reshape(c * n)

    # ------------------------------------------------------------------ 7
    key, subkey = jax.random.split(state.key)
    # Normalized-coordinate inlier gate derived from the pixel budget
    # (conservatively uses the largest-focal camera).
    inlier_threshold = p.inlier_threshold_px / jnp.max(setup.k_left[:, 0])
    result = pnp.ransac_pnp(
        subkey,
        flat_pts,
        flat_obs,
        flat_valid,
        flat_rot,
        flat_trans,
        init_body_t_world,
        num_hypotheses=p.ransac_hypotheses,
        sample_size=p.ransac_sample_size,
        inlier_threshold=inlier_threshold,
        obs_weight=obs_weight,
    )

    return _finish_step(
        params, setup, state, hot, images,
        body_t_world=result.body_t_world,
        num_inliers=result.num_inliers,
        inliers_cn=result.inliers.reshape(c, n),
        rms_error=result.rms_error,
        init_body_t_world=init_body_t_world,
        key=key,
        cam_active=cam_active,
        covariance=result.covariance,
        allow_refresh=allow_refresh,
    )


class HotProducts(NamedTuple):
    """Per-frame products: pyramids + KLT tracks (the every-tick path).

    Attributes:
        left/cur_pyr1/cur_pyr2: Left-image pyramid (C, H/2^l, W/2^l).
        tracks_xy/tracks_valid: KLT-tracked landmark positions (C, N, 2).
        obs_norm: Normalized tracked observations (C, N, 2).
        corr_valid: 2D-3D correspondence mask (C, N).
    """

    left: jnp.ndarray
    cur_pyr1: jnp.ndarray
    cur_pyr2: jnp.ndarray
    tracks_xy: jnp.ndarray
    tracks_valid: jnp.ndarray
    obs_norm: jnp.ndarray
    corr_valid: jnp.ndarray


class KeyframeProducts(NamedTuple):
    """Keyframe-only products: detections, descriptors, stereo geometry.

    Attributes:
        kp_xy/kp_valid: Fresh detections (C, N, 2)/(C, N).
        desc_bits: Left descriptors (C, N, 8) uint32.
        pts_cam/tri_valid: Stereo triangulation in raw-left camera frames.
        right_obs_px: Matched right-image observations (C, N, 2).
    """

    kp_xy: jnp.ndarray
    kp_valid: jnp.ndarray
    desc_bits: jnp.ndarray
    pts_cam: jnp.ndarray
    tri_valid: jnp.ndarray
    right_obs_px: jnp.ndarray


def run_hot_frontend(
    params: TrackerParams,
    setup: CameraSetup,
    state: TrackerState,
    images: jnp.ndarray,
    klt_body_t_world: jnp.ndarray,
) -> HotProducts:
    """The every-tick path: pyramids + KLT landmark tracking.

    Detection/description/stereo association live in
    :func:`run_keyframe_frontend` and execute only on keyframe ticks (a
    ``lax.cond`` branch): their products are consumed exclusively by the
    landmark-refresh logic, so ~80% of ticks skip them entirely.

    Embarrassingly parallel over the camera axis — this is the unit that
    shards across chips (each device runs its cameras; only the 6-DoF pose
    solve needs cross-device reduction). See parallel/mesh.py.
    """
    p = params
    left = images[:, 0]

    # Temporal association by pyramidal KLT: each landmark's patch (anchored
    # at its position in the previous left frame) is aligned into the
    # current frame, initialized at the pose-predicted reprojection. Local
    # photometric alignment is precise and unambiguous where descriptor
    # matching is not (repetitive texture), and the residual verifies it.
    pred_cam_t_world_r = jnp.einsum(
        "cij,jk->cik", setup.cam_r_body, klt_body_t_world[:3, :3]
    )  # (C,3,3)
    pred_cam_t_world_t = (
        jnp.einsum("cij,j->ci", setup.cam_r_body, klt_body_t_world[:3, 3])
        + setup.cam_t_body
    )  # (C,3)
    lm_cam = (
        jnp.einsum("cij,cnj->cni", pred_cam_t_world_r, state.lm_pos_w)
        + pred_cam_t_world_t[:, None, :]
    )  # (C,N,3)
    uv_pred, in_front = jax.vmap(calib.cam_points_to_raw_pixels)(
        lm_cam, setup.k_left, setup.dist_left
    )
    if p.mono_bootstrap:
        # Pending slots have no 3D position: initialize their KLT search
        # at the last tracked position (zero-motion init; the pyramid
        # levels absorb inter-frame displacement).
        uv_pred = jnp.where(state.lm_pending[..., None], state.lm_px, uv_pred)
        in_front = in_front | state.lm_pending

    cur_pyr1 = jax.vmap(downsample2)(left)
    cur_pyr2 = jax.vmap(downsample2)(cur_pyr1)
    tracks = klt.track_points_rig(
        (state.prev_left0, state.prev_left1, state.prev_left2),
        (left, cur_pyr1, cur_pyr2),
        state.lm_px, uv_pred,
        state.lm_valid & in_front,
        num_levels=p.klt_levels, radius=p.klt_radius, iters=p.klt_iters,
        max_residual=p.klt_max_residual,
    )

    # Per-landmark 2D-3D correspondences: undistorted normalized coords in
    # the raw left camera frame.
    obs_norm = jax.vmap(calib.raw_pixels_to_normalized)(
        tracks.xy, setup.k_left, setup.dist_left
    )  # (C, N, 2)
    corr_valid = tracks.valid & state.lm_valid  # (C, N)

    return HotProducts(
        left=left,
        cur_pyr1=cur_pyr1,
        cur_pyr2=cur_pyr2,
        tracks_xy=tracks.xy,
        tracks_valid=tracks.valid,
        obs_norm=obs_norm,
        corr_valid=corr_valid,
    )


def run_keyframe_frontend(
    params: TrackerParams,
    setup: CameraSetup,
    images: jnp.ndarray,
) -> KeyframeProducts:
    """Keyframe work: detect -> describe -> stereo associate -> triangulate."""
    p = params
    left = images[:, 0]
    right = images[:, 1]
    left_sm = jax.vmap(lambda im: gaussian_blur(im, 2.0, radius=4))(left)
    right_sm = jax.vmap(lambda im: gaussian_blur(im, 2.0, radius=4))(right)

    detect = lambda ims: fast.detect_keypoints_batched(
        ims,
        threshold=p.fast_threshold,
        max_keypoints=p.max_keypoints,
        cell_size=p.cell_size,
        per_cell=p.per_cell,
        border_margin=p.border_margin,
    )
    kp_l = detect(left)
    kp_r = detect(right)
    describe = lambda ims, xy, v: brief.compute_descriptors_batched(
        ims, xy, v, oriented=p.oriented_descriptors
    )
    desc_l = describe(left_sm, kp_l.xy, kp_l.valid)
    desc_r = describe(right_sm, kp_r.xy, kp_r.valid)

    # Stereo association on RECTIFIED COORDINATES (the images stay raw):
    # keypoints are lifted through undistortion + the rectifying rotation,
    # the epipolar gate and disparity live in rectified pixel space.
    rect_xy_l = jax.vmap(calib.raw_pixels_to_rect)(
        kp_l.xy, setup.k_left, setup.dist_left, setup.rect_left, setup.k_rect
    )  # (C, N, 2)
    rect_xy_r = jax.vmap(calib.raw_pixels_to_rect)(
        kp_r.xy, setup.k_right, setup.dist_right, setup.rect_right, setup.k_rect
    )
    dy_lr = jnp.abs(rect_xy_l[:, :, None, 1] - rect_xy_r[:, None, :, 1])  # (C,N,N)
    dx_lr = rect_xy_l[:, :, None, 0] - rect_xy_r[:, None, :, 0]
    stereo_gate = (dy_lr <= p.stereo_max_dy + 1.0) & (dx_lr > 0) & (dx_lr <= p.max_disparity_px)
    stereo_m = jax.vmap(
        lambda da, va, db, vb, g: match.match_descriptors(
            da, va, db, vb, max_distance=p.match_max_distance, ratio=p.match_ratio, allowed=g
        )
    )(desc_l.bits, desc_l.valid, desc_r.bits, desc_r.valid, stereo_gate)

    disp_rect, disp_valid = jax.vmap(
        lambda xl, xr, mi, mv: triangulate.match_disparities(
            xl, xr, mi, mv, max_dy=p.stereo_max_dy
        )
    )(rect_xy_l, rect_xy_r, stereo_m.idx, stereo_m.valid)

    # Subpixel: photometric refinement runs in RAW image space (epipolar
    # lines are locally ~horizontal for small distortion), then the refined
    # raw parallax is mapped back through the rectification.
    disp_raw = kp_l.xy[..., 0] - jnp.take_along_axis(kp_r.xy[..., 0], stereo_m.idx, axis=1)
    disp_raw_ref = jax.vmap(stereo_ops.refine_disparity_photometric)(
        left, right, kp_l.xy, disp_raw, disp_valid
    )
    disp = disp_rect + jnp.where(disp_valid, disp_raw_ref - disp_raw, 0.0)

    pts_rect, tri_valid = jax.vmap(
        lambda xy, d, k, b: triangulate.stereo_triangulate(
            xy, d, k[0], k[1], k[2], b,
            min_disparity=p.min_disparity, max_depth_m=p.max_depth_m,
        )
    )(rect_xy_l, disp, setup.k_rect, setup.baseline)
    # Mono sources have no stereo geometry: their "right" image is a zero
    # fill and the duplicated-left calibration is a placeholder — nothing
    # they triangulate is real.
    tri_valid = tri_valid & disp_valid & kp_l.valid & setup.stereo_mask[:, None]
    # Rectified-frame points -> raw left camera frame: p_cam = R_rect^T p_rect.
    pts_cam = jnp.einsum("cji,cnj->cni", setup.rect_left, pts_rect)

    # The matched right-image observation per left keypoint (subpixel x from
    # the refined raw disparity) — kept for the BA backend's stereo residual.
    right_y = jnp.take_along_axis(kp_r.xy[..., 1], stereo_m.idx, axis=1)
    right_obs_px = jnp.stack([kp_l.xy[..., 0] - disp_raw_ref, right_y], axis=-1)

    return KeyframeProducts(
        kp_xy=kp_l.xy,
        kp_valid=kp_l.valid,
        desc_bits=desc_l.bits,
        pts_cam=pts_cam,
        tri_valid=tri_valid,
        right_obs_px=right_obs_px,
    )


def mint_bank(
    params: TrackerParams,
    setup: CameraSetup,
    world_t_body: jnp.ndarray,
    kf: KeyframeProducts,
    anchor_ok: jnp.ndarray,
    cand_tracks_xy: jnp.ndarray,
    cand_pos_w: jnp.ndarray,
    cand_id: jnp.ndarray,
    fresh_ids: jnp.ndarray,
    cam_active: jnp.ndarray | None,
    cand_pending: jnp.ndarray | None = None,
    cand_anchor_px: jnp.ndarray | None = None,
    prev_kf_pose: jnp.ndarray | None = None,
    cand_weight: jnp.ndarray | None = None,
) -> tuple:
    """Mint a landmark bank from keyframe products + inheritance candidates.

    New landmarks are triangulated points lifted to world with the new
    pose — EXCEPT persistent ones: a freshly detected keypoint that lands
    on an inlier-tracked candidate's current position inherits that
    candidate's world coordinates (and id), anchoring the world frame
    across keyframes.

    Factored out of the keyframe branch so the SPMD slot-sharded path can
    mint its local bank slice against ALL-gathered candidates (a keypoint
    must be able to inherit a landmark owned by another device's shard —
    see parallel/mesh.py).

    Args:
        kf: Keyframe products for the slots being minted (possibly a
            device-local slice).
        anchor_ok: (C, M) trust mask over the inheritance candidates.
        cand_tracks_xy: (C, M, 2) candidates' current tracked positions.
        cand_pos_w: (C, M, 3) candidates' world positions.
        cand_id: (C, M) candidates' persistent ids.
        fresh_ids: (C, N_kf) ids to assign to non-inheriting keypoints.
        cam_active: Optional (C,) live-camera mask.
        cand_pending: (C, M) pending-depth mask over the candidates —
            all-mono rigs only (``mono_bootstrap``; None otherwise).
        cand_anchor_px: (C, M, 2) candidates' observations at the
            PREVIOUS keyframe (the frozen first rays).
        prev_kf_pose: (4, 4) that keyframe's body pose.
        cand_weight: (C, M) candidates' per-landmark observation weights
            (inherited with the position; None = ones).

    Returns:
        The 11-tuple (lm_pos, lm_desc, lm_valid, lm_px, lm_obs, lm_robs,
        lm_robs_valid, lm_id, lm_pending, lm_anchor_px, lm_weight) for
        the minted slots (pending all-False / anchors = lm_obs / weights
        one outside mono modes).
    """
    p = params
    world_t_cam = jnp.einsum("ij,cjk->cik", world_t_body, setup.body_t_cam)
    pts_w = (
        jnp.einsum("cij,cnj->cni", world_t_cam[:, :3, :3], kf.pts_cam)
        + world_t_cam[:, None, :3, 3]
    )

    if p.mono_bootstrap and cand_pending is not None:
        # MOTION TRIANGULATION (the all-mono minting path): promote every
        # pending candidate whose two views — its frozen anchor ray at
        # the previous keyframe pose and its tracked ray now — intersect
        # with enough parallax. Promoted candidates then take part in
        # inheritance like any landmark, so the fresh detection landing
        # on them adopts a REAL position (and their id).
        anchor_norm = jax.vmap(calib.raw_pixels_to_normalized)(
            cand_anchor_px, setup.k_left, setup.dist_left
        )
        cur_norm = jax.vmap(calib.raw_pixels_to_normalized)(
            cand_tracks_xy, setup.k_left, setup.dist_left
        )
        h0 = jnp.concatenate(
            [anchor_norm, jnp.ones_like(anchor_norm[..., :1])], -1
        )
        h1 = jnp.concatenate([cur_norm, jnp.ones_like(cur_norm[..., :1])], -1)
        world_t_cam_a = jnp.einsum("ij,cjk->cik", prev_kf_pose, setup.body_t_cam)
        cam_a_t_b = jnp.einsum(
            "cij,cjk->cik",
            jax.vmap(_se3_inv)(world_t_cam_a),
            world_t_cam,
        )
        tri_pts, tri_ok = jax.vmap(triangulate.two_view_midpoint)(
            h0, h1, cam_a_t_b
        )
        # Parallax floor: ray angle between the two views.
        r0n = h0 / jnp.linalg.norm(h0, axis=-1, keepdims=True)
        r1w = jnp.einsum("cij,cnj->cni", cam_a_t_b[:, :3, :3], h1)
        r1n = r1w / jnp.linalg.norm(r1w, axis=-1, keepdims=True)
        ang = jnp.arccos(
            jnp.clip(jnp.sum(r0n * r1n, axis=-1), -1.0, 1.0)
        )
        promoted = (
            cand_pending
            & tri_ok
            & (ang >= p.mono_min_parallax)
        )
        promoted_w = (
            jnp.einsum("cij,cnj->cni", world_t_cam_a[:, :3, :3], tri_pts)
            + world_t_cam_a[:, None, :3, 3]
        )
        cand_pos_w = jnp.where(promoted[..., None], promoted_w, cand_pos_w)
        anchor_ok = anchor_ok | promoted
        cand_pending = cand_pending & ~promoted

    d2 = jnp.sum(
        (kf.kp_xy[:, :, None, :] - cand_tracks_xy[:, None, :, :]) ** 2, axis=-1
    )  # (C, N_kf, M)
    d2 = jnp.where(anchor_ok[:, None, :], d2, jnp.inf)
    nearest = jnp.argmin(d2, axis=-1)
    near_d2 = jnp.min(d2, axis=-1)
    inherits = near_d2 <= p.persist_radius_px**2
    inherited_pos = jnp.take_along_axis(cand_pos_w, nearest[..., None], axis=1)
    lm_pos = jnp.where(inherits[..., None], inherited_pos, pts_w)
    lm_valid = kf.tri_valid | (inherits & kf.kp_valid)

    inherited_id = jnp.take_along_axis(cand_id, nearest, axis=1)
    lm_id = jnp.where(inherits, inherited_id, fresh_ids)

    lm_weight = jnp.ones_like(lm_valid, dtype=jnp.float32)
    if cand_weight is not None:
        inherited_w = jnp.take_along_axis(cand_weight, nearest, axis=1)
        lm_weight = jnp.where(inherits, inherited_w, lm_weight)

    lm_pending = jnp.zeros_like(lm_valid)
    if p.mono_bootstrap and cand_pending is not None:
        # Inherited slots keep their candidate's (possibly just-cleared)
        # pending flag; fresh non-inheriting detections enter the bank as
        # pending 2D tracks awaiting the NEXT keyframe's triangulation.
        inherited_pending = jnp.take_along_axis(cand_pending, nearest, axis=1)
        fresh_pending = kf.kp_valid & ~inherits
        lm_pending = jnp.where(inherits, inherited_pending, fresh_pending)
        lm_valid = lm_valid | fresh_pending

    if p.has_mono and not p.mono_bootstrap:
        # Cross-camera seeding (MIXED rigs; all-mono rigs instead promote
        # per camera by motion triangulation above, which shares the
        # bootstrap gauge through the common pose trajectory): a mono
        # camera cannot triangulate, so its
        # fresh detections inherit landmarks the STEREO cameras just
        # minted this keyframe — project every stereo-slot landmark into
        # the mono camera, match detections by proximity + descriptor
        # Hamming gate, and adopt the landmark's position AND id (the
        # shared id joins the two cameras' observations of the same point
        # in the BA window). Requires view overlap with a stereo camera;
        # the seeded landmark then persists via normal KLT tracking and
        # keyframe inheritance like any other.
        stereo = setup.stereo_mask
        src_valid = (lm_valid & stereo[:, None]).reshape(-1)  # post-inherit
        src_pts = lm_pos.reshape(-1, 3)
        src_desc = kf.desc_bits.reshape(-1, 8)
        src_ids = lm_id.reshape(-1)
        r_bw = world_t_body[:3, :3].T
        t_bw = -r_bw @ world_t_body[:3, 3]
        cam_r_w = jnp.einsum("cij,jk->cik", setup.cam_r_body, r_bw)
        cam_t_w = (
            jnp.einsum("cij,j->ci", setup.cam_r_body, t_bw) + setup.cam_t_body
        )
        p_cam = (
            jnp.einsum("cij,nj->cni", cam_r_w, src_pts) + cam_t_w[:, None, :]
        )  # (C, C*N, 3)
        uv, in_front = jax.vmap(calib.cam_points_to_raw_pixels)(
            p_cam, setup.k_left, setup.dist_left
        )
        sd2 = jnp.sum(
            (kf.kp_xy[:, :, None, :] - uv[:, None, :, :]) ** 2, axis=-1
        )  # (C, N_kf, C*N)
        # Mutual-NN + ratio descriptor matching inside the projection
        # gate — NOT nearest-projection: corners cluster, so a wrong
        # neighbor within the gate radius would pass the PnP inlier
        # threshold too and bias every subsequent solve (measured: naive
        # nearest-projection seeding made the mono camera NET-NEGATIVE).
        allowed = (
            src_valid[None, None, :]
            & in_front[:, None, :]
            & (sd2 <= p.mono_seed_radius_px**2)
        )
        seeds = jax.vmap(
            lambda da, va, g: match.match_descriptors(
                da, va, src_desc, src_valid,
                max_distance=p.mono_seed_max_hamming, ratio=0.9, allowed=g,
            )
        )(kf.desc_bits, kf.kp_valid, allowed)
        take = (~stereo)[:, None] & seeds.valid & ~inherits
        lm_pos = jnp.where(take[..., None], src_pts[seeds.idx], lm_pos)
        lm_id = jnp.where(take, src_ids[seeds.idx], lm_id)
        lm_valid = lm_valid | take

        # PER-LANDMARK observation weight for the seeded slots: the
        # source camera's triangulation depth error sigma_z = z^2 s_d /
        # (f b) is along its own ray; viewed from the mono camera it
        # projects laterally as sigma_z sin(theta) / rho radians (theta =
        # inter-ray angle, rho = mono range). Weight = relative inverse
        # variance against the nominal detector noise. A well-placed
        # landmark (small depth error or near-parallel rays) contributes
        # at ~full weight; a badly-placed one is nearly ignored — the
        # global scalar this replaces could do neither.
        import numpy as _np

        c_cams, n_per = lm_pos.shape[0], lm_pos.shape[1]
        # Host-side (static) camera index per flattened source slot: the
        # closed-over setup arrays are numpy, so the gather must use a
        # concrete index (a traced one would force numpy.__array__ on a
        # tracer).
        src_cam_idx = _np.repeat(_np.arange(c_cams), n_per)
        c_src = world_t_cam[:, :3, 3][src_cam_idx]  # (C*N, 3)
        dvec = src_pts - c_src
        z_src = jnp.maximum(jnp.linalg.norm(dvec, axis=-1), 1e-3)
        ray_s = dvec / z_src[:, None]
        fb = jnp.asarray(setup.k_rect)[:, 0] * jnp.asarray(setup.baseline)
        sigma_z = (
            z_src**2
            * p.mono_seed_disp_sigma_px
            / jnp.maximum(fb[src_cam_idx], 1e-6)
        )  # (C*N,) meters
        p_sel = src_pts[seeds.idx]  # (C, N_kf, 3)
        sz_sel = sigma_z[seeds.idx]
        ray_sel = ray_s[seeds.idx]
        dm = p_sel - world_t_cam[:, None, :3, 3]
        rho = jnp.maximum(jnp.linalg.norm(dm, axis=-1), 1e-3)
        ray_m = dm / rho[..., None]
        sin_t = jnp.linalg.norm(jnp.cross(ray_sel, ray_m), axis=-1)
        sigma_proj = sz_sel * sin_t / rho  # radians ~ normalized units
        # The DOMINANT mono error term is the seeding ASSOCIATION offset:
        # the mono detection may be a different corner than the projected
        # landmark, anywhere inside the mono_seed_radius_px gate — and
        # its own projection residual at seeding time MEASURES that
        # offset per landmark. (The depth-error projection term above is
        # near-zero at rig scale: the cameras sit centimeters apart, so
        # the rays to a meters-away landmark are almost parallel.)
        fx_c = jnp.asarray(setup.k_left)[:, 0][:, None]
        sigma0 = 1.0 / fx_c  # ~1 px detector noise
        # Composition: the global prior (mono_obs_weight) times the
        # per-landmark geometric term. The prior accounts for what no
        # per-observation variance can: a seeded observation's landmark
        # ERROR IS CORRELATED with the source camera's own observations
        # (same triangulated point), so a same-vantage mono ray adds
        # ~zero information while doubling that landmark's influence —
        # measured, weights near 1 are net-negative regardless of seed
        # quality. The geometric term downweights landmarks whose source
        # triangulation error becomes VISIBLE from the mono vantage
        # (sigma_proj: wide camera separation / close landmarks); at
        # centimeter rig baselines it is ~1 and the prior dominates.
        # (Weighting by the seeding projection RESIDUAL was measured
        # NET-NEGATIVE: a large residual usually flags an information-
        # bearing discrepancy of a CORRECT association, and suppressing
        # exactly those observations removes the signal.)
        w_seed = (
            p.mono_obs_weight * sigma0**2 / (sigma0**2 + sigma_proj**2)
        )
        lm_weight = jnp.where(take, w_seed, lm_weight)

    # BA observation: inherited landmarks keep their subpixel tracked
    # position (consistent with their 3D point); fresh ones the detection.
    inherited_track = jnp.take_along_axis(cand_tracks_xy, nearest[..., None], axis=1)
    lm_obs = jnp.where(inherits[..., None], inherited_track, kf.kp_xy)
    lm_robs = kf.right_obs_px + (lm_obs - kf.kp_xy)
    # Stereo right-obs is a MEASUREMENT only for freshly triangulated
    # landmarks: the inherited-slot value above is the detector's right
    # match shifted by the left-obs displacement — an approximation up
    # to persist_radius_px that, fed to BA at measurement weight,
    # biases the window (measured: catastrophic on fast sequences).
    lm_robs_valid = kf.tri_valid & lm_valid & ~inherits
    if cam_active is not None:  # dead cameras mint no landmarks
        lm_valid = lm_valid & cam_active[:, None]
        lm_robs_valid = lm_robs_valid & cam_active[:, None]
        lm_pending = lm_pending & cam_active[:, None]
    return (
        lm_pos, kf.desc_bits, lm_valid, kf.kp_xy, lm_obs,
        lm_robs, lm_robs_valid, lm_id, lm_pending, lm_obs, lm_weight,
    )


def _finish_step(
    params: TrackerParams,
    setup: CameraSetup,
    state: TrackerState,
    hot: HotProducts,
    images: jnp.ndarray,
    body_t_world: jnp.ndarray,
    num_inliers: jnp.ndarray,
    inliers_cn: jnp.ndarray,
    rms_error: jnp.ndarray,
    init_body_t_world: jnp.ndarray,
    key: jax.Array,
    cam_active: jnp.ndarray | None = None,
    fresh_id_base: jnp.ndarray | None = None,
    id_advance: int | None = None,
    covariance: jnp.ndarray | None = None,
    keyframe_minter=None,
    allow_refresh: bool = True,
) -> tuple[TrackerState, TrackOutput]:
    """Shared back half of a tick: acceptance, keyframing, state update.

    The keyframe front-end (detection/description/stereo) runs inside the
    ``lax.cond`` refresh branch — non-keyframe ticks skip it entirely.
    ``cam_active`` (see :func:`track_step`) additionally empties inactive
    cameras' landmark banks at refreshes: their detections come from a
    frozen frame, so minting landmarks from them would re-anchor the world
    on dead data. When the camera revives, the next keyframe re-mints its
    bank from live frames.

    ``fresh_id_base``/``id_advance`` keep landmark ids globally unique
    under SPMD: inside ``shard_map`` this function sees only the device's
    local camera shard while ``lm_id_counter`` is replicated, so every
    device would otherwise mint the same id range for different physical
    cameras. The sharded caller passes a per-device base offset
    (``counter + axis_index * local_cams * N``) and the *global* advance
    (``num_cams_global * N``); single-chip callers leave both None
    (base = counter, advance = C * N).
    """
    p = params

    # Accept the solve only with enough support; otherwise hold prediction.
    tracked = num_inliers >= p.min_track_inliers
    body_t_world = jnp.where(tracked, body_t_world, init_body_t_world)
    world_t_body = _se3_inv(body_t_world)
    untracked_streak = jnp.where(tracked, 0, state.untracked_streak + 1)
    # Keyframe policy. Landmarks are only re-anchored from a pose we
    # actually trust: a tracked solve (normal keyframing) — or a forced
    # restart after a long untracked streak (VO re-bootstrap from the
    # predicted pose; relative tracking resumes, drift is accepted).
    rel = _se3_inv(state.kf_world_t_body) @ world_t_body
    trans_dist = jnp.linalg.norm(rel[:3, 3])
    rot_angle = jnp.arccos(jnp.clip(0.5 * (jnp.trace(rel[:3, :3]) - 1.0), -1.0, 1.0))
    since_kf = state.frame_idx - state.last_kf_frame
    want_kf = (
        (
            (num_inliers < p.keyframe_min_inliers)
            & (since_kf >= p.keyframe_low_inlier_interval)
        )
        | (trans_dist > p.keyframe_max_translation)
        | (rot_angle > p.keyframe_max_rotation)
    )
    restart = untracked_streak >= p.restart_after_untracked
    if p.mono_bootstrap:
        # Bootstrap phase (no non-pending landmark anywhere): every tick
        # is "untracked" by construction, but a restart re-mint would
        # reset the pending anchors and parallax could never accumulate.
        # Re-mint only when the tracked anchor set itself decayed (the
        # scene left the view before enough baseline built up).
        bootstrapped = jnp.any(state.lm_valid & ~state.lm_pending)
        too_few = (
            jnp.sum(hot.tracks_valid & state.lm_valid)
            < p.mono_reboot_min_tracks
        )
        restart = restart & (bootstrapped | too_few)
    refresh = (state.frame_idx == 0) | (tracked & want_kf) | restart
    if not allow_refresh:
        # LIGHT tick: keyframing is host-scheduled onto full ticks; the
        # restart counter keeps accumulating and trips at the next full
        # tick (the engine force-schedules one under keyframe pressure).
        refresh = jnp.asarray(False)
        restart = jnp.asarray(False)
    untracked_streak = jnp.where(restart, 0, untracked_streak)

    c_, n_ = p.num_cams, p.max_keypoints

    def keyframe_branch(_):
        """Mint a new landmark bank (see :func:`mint_bank`).

        ``keyframe_minter`` overrides the whole branch for SPMD slot
        sharding, where detection runs on the full replicated images and
        each device mints only its slot slice against gathered candidates.
        """
        if keyframe_minter is not None:
            return keyframe_minter(world_t_body)
        kf = run_keyframe_frontend(p, setup, images)
        base = state.lm_id_counter if fresh_id_base is None else fresh_id_base
        fresh_ids = base + jnp.arange(c_ * n_, dtype=jnp.int32).reshape(c_, n_)
        return mint_bank(
            p, setup, world_t_body, kf,
            anchor_ok=hot.corr_valid & inliers_cn,  # trusted tracks
            cand_tracks_xy=hot.tracks_xy,
            cand_pos_w=state.lm_pos_w,
            cand_id=state.lm_id,
            fresh_ids=fresh_ids,
            cam_active=cam_active,
            cand_pending=state.lm_pending if p.mono_bootstrap else None,
            cand_anchor_px=state.lm_anchor_px if p.mono_bootstrap else None,
            prev_kf_pose=state.kf_world_t_body,
            cand_weight=state.lm_weight,
        )

    def continue_branch(_):
        """Non-keyframe tick: landmarks persist, anchors advance with KLT."""
        return (
            state.lm_pos_w, state.lm_desc, hot.corr_valid, hot.tracks_xy,
            hot.tracks_xy, state.lm_robs_px, state.lm_robs_valid, state.lm_id,
            state.lm_pending, state.lm_anchor_px, state.lm_weight,
        )

    if allow_refresh:
        (
            lm_pos_w, lm_desc, lm_valid, lm_px, lm_obs_px,
            lm_robs_px, lm_robs_valid, lm_id, lm_pending, lm_anchor_px,
            lm_weight,
        ) = jax.lax.cond(refresh, keyframe_branch, continue_branch, None)
    else:
        # Statically no keyframe: the detect/describe/stereo front-end is
        # never traced, so the right image is never consumed.
        (
            lm_pos_w, lm_desc, lm_valid, lm_px, lm_obs_px,
            lm_robs_px, lm_robs_valid, lm_id, lm_pending, lm_anchor_px,
            lm_weight,
        ) = continue_branch(None)

    advance = c_ * n_ if id_advance is None else id_advance
    new_counter = jnp.where(
        refresh, state.lm_id_counter + advance, state.lm_id_counter
    ).astype(jnp.int32)

    new_state = TrackerState(
        world_t_body=world_t_body,
        prev_world_t_body=state.world_t_body,
        velocity_w=state.velocity_w,  # updated by the host layer (knows dt)
        lm_pos_w=lm_pos_w,
        lm_desc=lm_desc,
        lm_valid=lm_valid,
        lm_px=lm_px,
        lm_obs_px=lm_obs_px,
        lm_robs_px=lm_robs_px,
        lm_robs_valid=lm_robs_valid,
        lm_id=lm_id,
        lm_id_counter=new_counter,
        kf_world_t_body=jnp.where(refresh, world_t_body, state.kf_world_t_body),
        prev_left0=hot.left,
        prev_left1=hot.cur_pyr1,
        prev_left2=hot.cur_pyr2,
        frame_idx=state.frame_idx + 1,
        untracked_streak=untracked_streak,
        key=key,
        lm_pending=lm_pending,
        lm_anchor_px=lm_anchor_px,
        lm_weight=lm_weight,
        last_kf_frame=jnp.where(refresh, state.frame_idx, state.last_kf_frame),
    )
    # Per-tick BA observation stream: the post-branch bank's pixel
    # positions lifted to undistorted normalized coordinates ON DEVICE
    # (cheap polynomial per point; saves the host the iterative
    # undistortion over C*N points every tick).
    obs_norm_out = jax.vmap(calib.raw_pixels_to_normalized)(
        lm_obs_px, setup.k_left, setup.dist_left
    )
    robs_norm_out = jax.vmap(calib.raw_pixels_to_normalized)(
        lm_robs_px, setup.k_right, setup.dist_right
    )
    # World-frame pose covariance: rotate the solve's [rho, phi] tangent
    # covariance (of body_t_world) into world axes — see TrackOutput docs.
    if covariance is None:
        covariance = jnp.eye(6) * 1e6
    r_wb = world_t_body[:3, :3]
    rot6 = jnp.zeros((6, 6)).at[:3, :3].set(r_wb).at[3:, 3:].set(r_wb)
    cov_world = rot6 @ covariance @ rot6.T
    cov_world = jnp.where(tracked, cov_world, jnp.eye(6) * 1e6)
    # Pending slots (mono bootstrap) are 2D-only: they are neither real
    # landmarks (count) nor BA/loop measurements (valid mask) until
    # promoted.
    lm_valid_out = lm_valid
    n_landmarks = jnp.sum(new_state.lm_valid)
    if p.mono_bootstrap:
        lm_valid_out = lm_valid & ~lm_pending
        n_landmarks = jnp.sum(new_state.lm_valid & ~new_state.lm_pending)
    output = TrackOutput(
        world_t_body=world_t_body,
        num_inliers=num_inliers,
        num_matches=jnp.sum(hot.corr_valid),
        num_landmarks=n_landmarks,
        rms_error=rms_error,
        refreshed=refresh,
        obs_norm=obs_norm_out,
        robs_norm=robs_norm_out,
        lm_id=lm_id,
        lm_valid=lm_valid_out,
        robs_valid=lm_robs_valid,
        covariance=cov_world,
    )
    return new_state, output


#: Length of the packed per-tick output vector (see ``pack_output``).
PACKED_LEN = 57


def pack_output(out: TrackOutput) -> jnp.ndarray:
    """Fuse the per-tick outputs into ONE fresh (57,) float32 vector.

    Layout: world_t_body.ravel() (16) | num_inliers | num_matches |
    num_landmarks | rms_error | refreshed | covariance.ravel() (36).

    Two reasons this exists:
    * a ``device_get`` that touches any member of the step's output tuple
      can materialize the entire output buffer set (~50 MB of state at
      4x720p) on the host; fetching one 228-byte vector costs one round
      trip;
    * with buffer donation the raw outputs may alias donated state memory
      and die at the next step — the concatenation below always
      materializes a fresh, alias-free buffer that stays valid.
    """
    scalars = jnp.stack(
        [
            out.num_inliers.astype(jnp.float32),
            out.num_matches.astype(jnp.float32),
            out.num_landmarks.astype(jnp.float32),
            out.rms_error.astype(jnp.float32),
            out.refreshed.astype(jnp.float32),
        ]
    )
    return jnp.concatenate(
        [out.world_t_body.reshape(-1), scalars, out.covariance.reshape(-1)]
    )


def unpack_output(vec) -> dict:
    """Host-side parse of a fetched ``pack_output`` vector."""
    import numpy as np

    v = np.asarray(vec)
    return {
        "world_t_body": v[:16].reshape(4, 4).astype(np.float64),
        "num_inliers": int(v[16]),
        "num_matches": int(v[17]),
        "num_landmarks": int(v[18]),
        "rms_error": float(v[19]),
        "refreshed": bool(v[20] > 0.5),
        "covariance": v[21:57].reshape(6, 6).astype(np.float64),
    }


def pack_ba_obs(out: TrackOutput, lm_pos_w: jnp.ndarray) -> jnp.ndarray:
    """Fuse the per-tick BA observations into ONE fresh (C, N, 10) array.

    Channels: obs_norm (2) | robs_norm (2) | lm_id (BITCAST) | lm_valid |
    robs_valid | lm_pos_w (3). Same rationale as :func:`pack_output` — one
    alias-free buffer, one device->host transfer for the whole tick's
    measurement set.

    ``lm_pos_w`` is the POST-tick landmark bank (``new_state.lm_pos_w``):
    shipping the positions with the observations lets the track-level BA
    backend initialize its landmark block from the finalized tick's own
    snapshot instead of reading the live device state — which is what
    makes BA legal (and sync-free) under deep pipelining, where the live
    state is ticks ahead of the tick being finalized.

    The landmark id channel is the int32 id BIT-PATTERN reinterpreted as
    float32 (``bitcast_convert_type``), NOT a numeric cast: float32 is
    exact only to 2^24, and a production run mints ids past that within
    ~20 minutes — a numeric cast would silently round distinct ids
    together and corrupt the BA join. The host side bitcasts back.
    """
    return jnp.concatenate(
        [
            out.obs_norm.astype(jnp.float32),
            out.robs_norm.astype(jnp.float32),
            jax.lax.bitcast_convert_type(out.lm_id, jnp.float32)[..., None],
            out.lm_valid.astype(jnp.float32)[..., None],
            out.robs_valid.astype(jnp.float32)[..., None],
            lm_pos_w.astype(jnp.float32),
        ],
        axis=-1,
    )


def unpack_ba_obs(arr) -> dict:
    """Host-side parse of a fetched ``pack_ba_obs`` array."""
    import numpy as np

    a = np.asarray(arr)
    return {
        "obs": a[..., 0:2].astype(np.float32),
        "robs": a[..., 2:4].astype(np.float32),
        # Bit-pattern reinterpretation, inverse of the pack-side bitcast.
        "ids": np.ascontiguousarray(a[..., 4], np.float32).view(np.int32),
        "valid": a[..., 5] > 0.5,
        "robs_valid": a[..., 6] > 0.5,
        "pos": a[..., 7:10].astype(np.float32),
    }


def pack_kf_sig(new_state: TrackerState) -> jnp.ndarray:
    """ALL-camera keyframe signature as ONE fresh (C, N, 14) array.

    Channels: desc bits (8, uint32 BITCAST) | obs_px (2) | lm_valid (1) |
    lm_pos_w (3) — everything the host's loop-closure/place-recognition
    backend stores per keyframe (the DB ``entry`` of
    ``TpuSlamEngine._loop_closure_tick``). Shipping it with the tick's
    outputs means loop closure reads the FINALIZED tick's bank, never the
    live device state — required under deep pipelining (the live bank is
    ticks ahead of the keyframe being recorded) and one less device sync
    per keyframe everywhere else.

    Every camera's bank is packed (not just camera 0): the place DB
    indexes all cameras, which is what makes revisits recognizable from
    ANY heading on a rig whose mounts cover the yaw space — a reverse-
    heading repass is matched by the query's forward camera against the
    entry a rear-facing camera recorded on the first pass (the viewpoint
    tolerance cuVSLAM's loop closure provides; reference
    launch/thor_visual_slam.launch.py:30-64).
    """
    return jnp.concatenate(
        [
            jax.lax.bitcast_convert_type(new_state.lm_desc, jnp.float32),
            new_state.lm_obs_px.astype(jnp.float32),
            # Pending (2D-only) slots have no position — never signatures.
            (new_state.lm_valid & ~new_state.lm_pending).astype(jnp.float32)[
                ..., None
            ],
            new_state.lm_pos_w.astype(jnp.float32),
        ],
        axis=-1,
    )


def unpack_kf_sig(arr) -> dict:
    """Host-side parse of a fetched ``pack_kf_sig`` array.

    Accepts the (C, N, 14) all-camera layout (arrays keep their leading
    camera axis) or a legacy single-camera (N, 14) signature (parsed with
    an inserted C=1 axis).
    """
    import numpy as np

    a = np.asarray(arr)
    if a.ndim == 2:
        a = a[None]
    return {
        "desc": np.ascontiguousarray(a[..., 0:8], np.float32).view(np.uint32),
        "obs_px": a[..., 8:10].astype(np.float32),
        "valid": a[..., 10] > 0.5,
        "pos": a[..., 11:14].astype(np.float64),
    }


def _pack_returns(pack: bool | str, new_state: TrackerState, out: TrackOutput):
    """Assemble the ``(state, out[, packed[, ba_obs][, kf_sig]])`` tuple
    for a pack mode (shared by the single-chip and SPMD step builders)."""
    if not pack:
        return new_state, out
    rets = [new_state, out, pack_output(out)]
    if pack in ("ba", "ba+kf"):
        rets.append(pack_ba_obs(out, new_state.lm_pos_w))
    if pack in ("kf", "ba+kf"):
        rets.append(pack_kf_sig(new_state))
    return tuple(rets)


#: Length of the packed mono-init result vector (see ``make_mono_init``).
MONO_INIT_PACKED_LEN = 4


def make_mono_init(params: TrackerParams, setup: CameraSetup):
    """Jitted all-mono bootstrap attempt: ``state -> (state, (4,) f32)``.

    The engine dispatches this against the live state while an all-mono
    rig is unbootstrapped (``mono_bootstrap``; reference mono capture
    path luxonis.py:551-568). Camera 0's pending anchors (observations at
    the last keyframe, pose ``kf_world_t_body``) and their current KLT
    tracks form the two views; :func:`epipolar.ransac_essential` recovers
    the relative pose (unit-|t| gauge — monocular scale is unobservable)
    and the inlier triangulation becomes the first landmark bank.

    The attempt self-gates: below ``mono_trigger_parallax`` mean 2D
    displacement, or under ``mono_init_min_inliers`` epipolar support,
    the state passes through unchanged and the flag vector reports why.

    Packed result layout: [success, num_inliers, mean_parallax,
    num_triangulated].
    """
    import numpy as np

    from thor_slam_tpu.engine import epipolar
    from thor_slam_tpu.ops import calib as calib_ops

    p = params
    setup_host = jax.tree.map(np.asarray, setup)

    def _init(state: TrackerState):
        s = setup_host
        anchor_norm = calib_ops.raw_pixels_to_normalized(
            state.lm_anchor_px[0], s.k_left[0], s.dist_left[0]
        )
        cur_norm = calib_ops.raw_pixels_to_normalized(
            state.lm_obs_px[0], s.k_left[0], s.dist_left[0]
        )
        valid = state.lm_valid[0] & state.lm_pending[0]
        n_valid = jnp.maximum(jnp.sum(valid), 1)
        disp = (
            jnp.sum(
                jnp.where(
                    valid,
                    jnp.linalg.norm(cur_norm - anchor_norm, axis=-1),
                    0.0,
                )
            )
            / n_valid
        )

        key, subkey = jax.random.split(state.key)
        res = epipolar.ransac_essential(
            subkey, anchor_norm, cur_norm, valid,
            min_parallax=p.mono_min_parallax,
        )
        success = (
            (disp >= p.mono_trigger_parallax)
            & (res.num_inliers >= p.mono_init_min_inliers)
            & (jnp.sum(res.tri_valid) >= p.mono_init_min_inliers // 2)
        )

        # Frames: A = camera 0 at the anchor keyframe, B = camera 0 now.
        world_t_cam_a = state.kf_world_t_body @ jnp.asarray(s.body_t_cam[0])
        a_t_b = epipolar._a_t_b(res.r_ba, res.t_ba)
        world_t_cam_b = world_t_cam_a @ a_t_b
        new_pose = world_t_cam_b @ _se3_inv(jnp.asarray(s.body_t_cam[0]))
        pts_w = (
            res.points_a @ world_t_cam_a[:3, :3].T + world_t_cam_a[:3, 3]
        )

        promote = res.tri_valid & valid
        lm_pos_w = state.lm_pos_w.at[0].set(
            jnp.where(
                (success & promote)[:, None], pts_w, state.lm_pos_w[0]
            )
        )
        lm_pending = state.lm_pending.at[0].set(
            jnp.where(success, state.lm_pending[0] & ~promote, state.lm_pending[0])
        )
        world_t_body = jnp.where(success, new_pose, state.world_t_body)
        new_state = state._replace(
            world_t_body=world_t_body,
            prev_world_t_body=jnp.where(
                success, state.world_t_body, state.prev_world_t_body
            ),
            lm_pos_w=lm_pos_w,
            lm_pending=lm_pending,
            untracked_streak=jnp.where(
                success, jnp.asarray(0, jnp.int32), state.untracked_streak
            ),
            key=key,
        )
        packed = jnp.stack(
            [
                success.astype(jnp.float32),
                res.num_inliers.astype(jnp.float32),
                disp.astype(jnp.float32),
                jnp.sum(res.tri_valid).astype(jnp.float32),
            ]
        )
        return new_state, packed

    return jax.jit(_init, donate_argnums=(0,))


def make_track_step(
    params: TrackerParams,
    setup: CameraSetup,
    donate: bool = False,
    pack: bool | str = False,
    light: bool = False,
    half_res: bool = False,
):
    """Bind params/setup and return a jitted ``(state, images) -> (state, out)``.

    The camera setup is closed over as HOST (numpy) arrays, so it traces
    into the executable as compile-time literals — on-device once, never
    re-transferred per tick. Do NOT capture *device* arrays here: an
    executable holding captured device buffers pins them for its lifetime.

    Args:
        params: Static tracker configuration.
        setup: Per-camera constants (host arrays).
        donate: Donate the input state's buffers to the output state. The
            streaming loop then reuses device memory in place instead of
            a per-tick alloc/free of the ~50 MB state. The caller must not
            reuse a state after passing it.
        pack: Also return ``pack_output(out)`` as a third element — the
            only output the host should sync on (see :func:`pack_output`).
            ``"ba"`` additionally appends ``pack_ba_obs`` (the track-level
            BA measurement stream); ``"kf"`` appends ``pack_kf_sig`` (the
            loop-closure keyframe signature); ``"ba+kf"`` appends both, in
            that order.
        light: Build the LIGHT-tick variant: images are (C, 1, H, W)
            left-only, keyframing statically disabled (see ``track_step``
            ``allow_refresh``). Same state pytree and output layout, so
            the engine interleaves light and full steps freely.
        half_res: Expect 2x-downsampled images and upsample on device
            (see ``track_step`` ``half_res``) — 1/4 the upload bytes.
    """
    import numpy as np

    setup_host = jax.tree.map(np.asarray, setup)

    def _step(state: TrackerState, images: jnp.ndarray, pose_prediction=None, cam_active=None):
        new_state, out = track_step(
            params, setup_host, state, images, pose_prediction, cam_active,
            allow_refresh=not light, half_res=half_res,
        )
        return _pack_returns(pack, new_state, out)

    # Only the state donates: the uint8 images buffer converts to f32
    # inside the graph, so XLA can never alias it ("donated buffers were
    # not usable") — donating it would be a no-op plus a warning per call.
    return jax.jit(_step, donate_argnums=(0,) if donate else ())
