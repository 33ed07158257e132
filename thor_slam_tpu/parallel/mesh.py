"""SPMD tracking over a device mesh: camera-sharded or slot-sharded.

The rig's natural parallel axis is the camera (SURVEY.md §2.4): the image
front-end (rectify/detect/describe/stereo/KLT) is embarrassingly parallel
per camera, while the 6-DoF pose solve couples them only through 6x6
normal equations. The multi-chip design follows directly:

* a 1-D ``Mesh`` with axis ``"d"``; every per-camera array (images,
  landmark banks, pyramids) is sharded on its camera axis, poses and
  scalars are replicated;
* the front-end runs unchanged inside ``shard_map`` — zero communication;
* the pose solve is distributed RANSAC + Gauss-Newton: each device solves
  hypotheses from its *local* correspondences (zero communication), the
  hypothesis poses are ``all_gather``'d (16 floats each), scored against
  local correspondences with one ``psum`` of the inlier counts, and the
  globally best hypothesis seeds a Huber-IRLS polish where each device
  reduces its correspondences to (J^T W J, J^T W r) — 6x6 + 6 floats —
  and one ``psum`` per iteration crosses the interconnect. Every update is computed
  identically on every device, keeping poses replicated by construction.
* keyframe decisions use psum'd global inlier counts, so all devices
  refresh their local landmark banks on the same frames.

When the mesh is LARGER than the camera count (e.g. an 8-chip host
tracking a single stereo camera — the EuRoC topology), the parallel axis
switches to landmark SLOTS: images and pyramids are replicated, each
device owns ``max_keypoints / n_devices`` landmark slots per camera, and
the hot path (KLT + the distributed pose solve — ~80% of ticks) shards
fully. Keyframe ticks run detection on the replicated images on every
device (redundant compute, zero communication) and each device mints only
its slot slice; inheritance candidates are all-gathered (~tens of KB) so
a keypoint can inherit a landmark owned by another device's shard.

Communication per tick: a few hundred bytes of psums (plus the small
keyframe gathers in slot mode) — the design scales to any rig size.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from thor_slam_tpu.engine import tracker as trk
from thor_slam_tpu.ops import lie, linalg

#: Mesh axis name used by every collective in this module.
AXIS = "d"


def make_camera_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A 1-D mesh over ``n_devices`` with the tracking axis."""
    if devices is None:
        devices = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.asarray(devices), axis_names=(AXIS,))


#: TrackerState fields sharded on the camera axis in "cam" mode; the same
#: fields shard on their SLOT axis (dim 1) in "slot" mode, except the
#: pyramids, which stay replicated there (KLT needs full images).
_CAM_SHARDED_FIELDS = frozenset(
    {
        "lm_pos_w", "lm_desc", "lm_valid", "lm_px", "lm_obs_px", "lm_robs_px",
        "lm_robs_valid", "lm_id", "lm_pending", "lm_anchor_px", "lm_weight",
        "prev_left0", "prev_left1", "prev_left2",
    }
)
_SLOT_SHARDED_FIELDS = _CAM_SHARDED_FIELDS - {"prev_left0", "prev_left1", "prev_left2"}


def choose_axis(num_cams: int, max_keypoints: int, n_devices: int) -> str:
    """Pick the sharding axis for a rig: cameras when they divide evenly,
    landmark slots otherwise."""
    if n_devices <= 1:
        raise ValueError("SPMD needs n_devices > 1")
    if num_cams % n_devices == 0:
        return "cam"
    if max_keypoints % n_devices == 0:
        return "slot"
    raise ValueError(
        f"neither num_cams={num_cams} nor max_keypoints={max_keypoints} "
        f"divisible by {n_devices} devices"
    )


def _state_specs(axis_mode: str) -> trk.TrackerState:
    def spec(f):
        if axis_mode == "cam":
            return P(AXIS) if f in _CAM_SHARDED_FIELDS else P()
        return P(None, AXIS) if f in _SLOT_SHARDED_FIELDS else P()

    return trk.TrackerState(**{f: spec(f) for f in trk.TrackerState._fields})


def shard_state(state: trk.TrackerState, mesh: Mesh, axis_mode: str = "cam") -> trk.TrackerState:
    """Place a tracker state on the mesh per the axis mode's specs."""
    specs = _state_specs(axis_mode)
    return trk.TrackerState(
        **{
            f: jax.device_put(getattr(state, f), NamedSharding(mesh, getattr(specs, f)))
            for f in trk.TrackerState._fields
        }
    )


def _distributed_robust_pnp(
    points_w: jnp.ndarray,
    obs: jnp.ndarray,
    valid: jnp.ndarray,
    cam_rot: jnp.ndarray,
    cam_trans: jnp.ndarray,
    init_body_t_world: jnp.ndarray,
    inlier_threshold: jnp.ndarray,
    axis_name: str,
    iters: int = 10,
    huber_delta: float = 0.01,
    damping: float = 1e-6,
    weights: jnp.ndarray | None = None,
):
    """Huber-IRLS Gauss-Newton with cross-device psum of the normal equations.

    Runs inside shard_map: ``points_w``/``obs``/... hold only this device's
    correspondences; every device computes the identical pose update from
    the psum'd 6x6 system. ``weights`` (defaults to ``valid``) selects which
    correspondences drive the solve; the final inlier census always gates on
    ``valid`` so RANSAC-polish callers report over the full set.
    """
    from thor_slam_tpu.engine.pnp import _huber_weights, _residuals_and_jacobian

    if weights is None:
        weights = valid.astype(jnp.float32)

    def step(_, x):
        r, j, behind = _residuals_and_jacobian(x, points_w, obs, cam_rot, cam_trans)
        r_norm = jnp.linalg.norm(r, axis=-1)
        w = weights * _huber_weights(r_norm, huber_delta) * (1.0 - behind.astype(jnp.float32))
        jw = j * w[:, None, None]
        h_local = jnp.einsum("nai,naj->ij", jw, j)
        g_local = jnp.einsum("nai,na->i", jw, r)
        h = jax.lax.psum(h_local, axis_name) + damping * jnp.eye(6)
        g = jax.lax.psum(g_local, axis_name)
        delta = -linalg.spd_solve(h, g)
        delta = jnp.where(jnp.all(jnp.isfinite(delta)), delta, jnp.zeros(6))
        return lie.se3_exp(delta) @ x

    x = jax.lax.fori_loop(0, iters, step, init_body_t_world)
    r, j, behind = _residuals_and_jacobian(x, points_w, obs, cam_rot, cam_trans)
    r_norm = jnp.linalg.norm(r, axis=-1) + behind * 1e3
    inliers = (r_norm <= inlier_threshold) & valid
    num_inliers = jax.lax.psum(jnp.sum(inliers), axis_name)
    sq = jnp.sum(jnp.where(inliers, r_norm**2, 0.0))
    rms = jnp.sqrt(jax.lax.psum(sq, axis_name) / jnp.maximum(num_inliers, 1))
    # Pose covariance = sigma^2 (psum J^T W J)^-1 over the GLOBAL inlier
    # set (same estimator as pnp.pose_covariance; one extra 6x6 psum).
    wi = inliers.astype(jnp.float32) * (1.0 - behind.astype(jnp.float32))
    jw = j * wi[:, None, None]
    h = jax.lax.psum(jnp.einsum("nai,naj->ij", jw, j), axis_name) + damping * jnp.eye(6)
    dof = jnp.maximum(2.0 * num_inliers.astype(jnp.float32) - 6.0, 1.0)
    sigma2 = jax.lax.psum(jnp.sum(wi[:, None] * r**2), axis_name) / dof
    cov = sigma2 * linalg.spd_inverse(h)
    cov = 0.5 * (cov + cov.T)
    cov = jnp.where(jnp.all(jnp.isfinite(cov)), cov, jnp.eye(6) * 1e6)
    return x, inliers, num_inliers, rms, cov


def _distributed_ransac_pnp(
    key: jax.Array,
    points_w: jnp.ndarray,
    obs: jnp.ndarray,
    valid: jnp.ndarray,
    cam_rot: jnp.ndarray,
    cam_trans: jnp.ndarray,
    init_body_t_world: jnp.ndarray,
    inlier_threshold: jnp.ndarray,
    axis_name: str,
    hyp_per_device: int = 4,
    sample_size: int = 6,
    hyp_iters: int = 5,
    refine_iters: int = 6,
):
    """Cross-device RANSAC PnP (the SPMD twin of ``pnp.ransac_pnp``).

    Hypothesis generation is communication-free: each device draws
    ``hyp_per_device`` minimal subsets from its own correspondences and
    solves them locally (a subset drawn from one camera still fully
    constrains the 6-DoF body pose). The global consensus step moves only
    poses and counts: one ``all_gather`` of (hyp_per_device, 4, 4) floats
    and one ``psum`` of the per-hypothesis inlier counts. The winning pose
    then seeds the psum'd Huber-IRLS polish over the global inlier set.
    """
    from thor_slam_tpu.engine.pnp import gauss_newton_pnp, project_points

    n = points_w.shape[0]
    # Replicated state key -> decorrelate the per-device hypothesis draws.
    key = jax.random.fold_in(key, jax.lax.axis_index(axis_name))
    gumbel = -jnp.log(-jnp.log(jax.random.uniform(key, (hyp_per_device, n)) + 1e-12) + 1e-12)
    scores = jnp.where(valid[None, :], gumbel, -jnp.inf)
    # Iterative top-k (see engine/pnp.py): avoids lax.top_k's full row sort.
    iota_n = jnp.arange(n, dtype=jnp.int32)[None, :]
    cols = []
    for _ in range(sample_size):
        i = jnp.argmax(scores, axis=1).astype(jnp.int32)
        cols.append(i)
        scores = jnp.where(iota_n == i[:, None], -jnp.inf, scores)
    subset_idx = jnp.stack(cols, axis=1)  # (Hl, S)

    sub_pts = points_w[subset_idx]
    sub_obs = obs[subset_idx]
    sub_rot = cam_rot[subset_idx]
    sub_tr = cam_trans[subset_idx]
    sub_w = valid[subset_idx].astype(jnp.float32)

    def solve_one(pts, ob, w, rot, tr):
        x, _ = gauss_newton_pnp(pts, ob, w, rot, tr, init_body_t_world, iters=hyp_iters)
        return x

    hyp_local = jax.vmap(solve_one)(sub_pts, sub_obs, sub_w, sub_rot, sub_tr)
    # (n_dev * Hl, 4, 4), identical on every device.
    hyps = jax.lax.all_gather(hyp_local, axis_name).reshape(-1, 4, 4)

    def count_local(x):
        _, _, uv = project_points(x, points_w, cam_rot, cam_trans)
        err = jnp.linalg.norm(uv - obs, axis=-1)
        return jnp.sum((err <= inlier_threshold) & valid)

    counts = jax.lax.psum(jax.vmap(count_local)(hyps), axis_name)  # (H,) global
    best_pose = hyps[jnp.argmax(counts)]

    _, _, uv = project_points(best_pose, points_w, cam_rot, cam_trans)
    best_inl = (jnp.linalg.norm(uv - obs, axis=-1) <= inlier_threshold) & valid
    return _distributed_robust_pnp(
        points_w, obs, valid, cam_rot, cam_trans, best_pose, inlier_threshold,
        axis_name, iters=refine_iters, weights=best_inl.astype(jnp.float32),
    )


def make_sharded_track_step(
    params: trk.TrackerParams,
    setup: trk.CameraSetup,
    mesh: Mesh,
    axis_mode: str | None = None,
    donate: bool = False,
    pack: bool | str = False,
):
    """Build the SPMD tick on ``mesh``, mirroring ``make_track_step``.

    Returns a jitted ``(state, images, pose_prediction=None,
    cam_active=None) -> (state, out[, packed[, ba_obs]])`` — the exact
    calling convention of the single-chip step, so ``TpuSlamEngine``
    swaps it in transparently (``devices=N``).

    Args:
        axis_mode: "cam" (camera sharding; ``num_cams`` divisible by the
            mesh size) or "slot" (landmark-slot sharding with replicated
            images; ``max_keypoints`` divisible). None picks automatically
            (:func:`choose_axis`).
        donate: Donate the state buffers (streaming reuse, as in
            ``make_track_step``).
        pack: ``True`` appends ``pack_output``; ``"ba"`` additionally
            appends ``pack_ba_obs`` (slot/camera-sharded — one gathered
            fetch on the host side); ``"kf"`` appends ``pack_kf_sig``
            (the all-camera loop-closure signature — XLA inserts the
            cross-shard gather); ``"ba+kf"`` appends both.
    """
    n_dev = mesh.devices.size
    if axis_mode is None:
        axis_mode = choose_axis(params.num_cams, params.max_keypoints, n_dev)

    c_full, n_full = params.num_cams, params.max_keypoints
    if axis_mode == "cam":
        if c_full % n_dev:
            raise ValueError(f"num_cams={c_full} not divisible by mesh size {n_dev}")
        local_params = trk.TrackerParams(**{**params.__dict__, "num_cams": c_full // n_dev})
        setup_spec = P(AXIS)
        images_spec = P(AXIS)
    elif axis_mode == "slot":
        if n_full % n_dev:
            raise ValueError(f"max_keypoints={n_full} not divisible by mesh size {n_dev}")
        local_params = trk.TrackerParams(**{**params.__dict__, "max_keypoints": n_full // n_dev})
        setup_spec = P()
        images_spec = P()
    else:
        raise ValueError(f"unknown axis_mode {axis_mode!r}")

    setup_sharded = trk.CameraSetup(
        *(jax.device_put(jnp.asarray(v), NamedSharding(mesh, setup_spec)) for v in setup)
    )
    state_specs = _state_specs(axis_mode)
    obs_spec = P(AXIS) if axis_mode == "cam" else P(None, AXIS)
    out_specs_out = trk.TrackOutput(
        world_t_body=P(), num_inliers=P(), num_matches=P(),
        num_landmarks=P(), rms_error=P(), refreshed=P(), covariance=P(),
        # The per-slot observation stream shards with its owners.
        obs_norm=obs_spec, robs_norm=obs_spec, lm_id=obs_spec,
        lm_valid=obs_spec, robs_valid=obs_spec,
    )
    setup_specs = trk.CameraSetup(*(setup_spec for _ in trk.CameraSetup._fields))

    def spmd_body(setup_c, state, images_c, cam_active_c, pose_prediction):
        p = local_params
        if images_c.dtype == jnp.uint8:  # same contract as track_step
            images_c = images_c.astype(jnp.float32) * (1.0 / 255.0)
        # Pose prediction (identical on all devices — replicated inputs).
        # Same two-use split as track_step: the KLT init takes the
        # prediction; PnP re-derives from the last SOLVED pose unless an
        # external (IMU) prediction was supplied.
        if pose_prediction is None:
            delta = state.world_t_body @ trk._se3_inv(state.prev_world_t_body)
            extrapolated = delta @ state.world_t_body
            klt_prediction = jnp.where(
                state.untracked_streak > 0, state.world_t_body, extrapolated
            )
            init_body_t_world = trk._se3_inv(state.world_t_body)
        else:
            klt_prediction = pose_prediction
            init_body_t_world = trk._se3_inv(pose_prediction)
        klt_body_t_world = trk._se3_inv(klt_prediction)

        hot = trk.run_hot_frontend(p, setup_c, state, images_c, klt_body_t_world)
        hot = hot._replace(
            corr_valid=hot.corr_valid & cam_active_c[:, None],
            tracks_valid=hot.tracks_valid & cam_active_c[:, None],
        )

        c, n = p.num_cams, p.max_keypoints
        flat_pts = state.lm_pos_w.reshape(c * n, 3)
        flat_obs = hot.obs_norm.reshape(c * n, 2)
        flat_valid = hot.corr_valid.reshape(c * n)
        flat_rot = jnp.repeat(setup_c.cam_r_body, n, axis=0)
        flat_trans = jnp.repeat(setup_c.cam_t_body, n, axis=0)

        k_max = jnp.max(setup_c.k_left[:, 0])
        if axis_mode == "cam":  # per-device camera shards: reduce across
            k_max = jax.lax.pmax(k_max, AXIS)
        inlier_threshold = p.inlier_threshold_px / k_max
        key, subkey = jax.random.split(state.key)
        body_t_world, inliers, num_inliers, rms, cov = _distributed_ransac_pnp(
            subkey, flat_pts, flat_obs, flat_valid, flat_rot, flat_trans,
            init_body_t_world, inlier_threshold, axis_name=AXIS,
            hyp_per_device=max(1, params.ransac_hypotheses // n_dev),
            sample_size=params.ransac_sample_size,
        )

        idx = jax.lax.axis_index(AXIS)
        if axis_mode == "cam":
            # lm_id is the global BA/loop join key: offset each device's
            # fresh-id range by its camera shard and advance the replicated
            # counter by the GLOBAL mint count so ids never collide.
            fresh_id_base = state.lm_id_counter + idx * jnp.asarray(c * n, jnp.int32)
            keyframe_minter = None
        else:
            fresh_id_base = None
            # Inheritance candidates must span ALL shards: a fresh keypoint
            # in this device's slot slice may sit on a landmark owned by
            # another device. Gathered OUTSIDE the keyframe cond (a
            # collective inside a branch is not legal SPMD); ~tens of KB.
            g_tracks = jax.lax.all_gather(hot.tracks_xy, AXIS, axis=1, tiled=True)
            g_pos = jax.lax.all_gather(state.lm_pos_w, AXIS, axis=1, tiled=True)
            g_id = jax.lax.all_gather(state.lm_id, AXIS, axis=1, tiled=True)
            g_anchor = jax.lax.all_gather(
                hot.corr_valid & inliers.reshape(c, n), AXIS, axis=1, tiled=True
            )
            lo = idx * n

            def keyframe_minter(world_t_body):
                # Full-image detection runs replicated (identical on every
                # device); this device mints only its slot slice of it.
                kf_full = trk.run_keyframe_frontend(params, setup_c, images_c)
                kf = trk.KeyframeProducts(
                    *(jax.lax.dynamic_slice_in_dim(v, lo, n, axis=1) for v in kf_full)
                )
                # Global slot ids: cam * N_full + slot_global.
                fresh_ids = (
                    state.lm_id_counter
                    + jnp.arange(c, dtype=jnp.int32)[:, None] * n_full
                    + lo.astype(jnp.int32)
                    + jnp.arange(n, dtype=jnp.int32)[None, :]
                )
                return trk.mint_bank(
                    local_params, setup_c, world_t_body, kf,
                    anchor_ok=g_anchor, cand_tracks_xy=g_tracks,
                    cand_pos_w=g_pos, cand_id=g_id, fresh_ids=fresh_ids,
                    cam_active=cam_active_c,
                )

        new_state, out = trk._finish_step(
            p, setup_c, state, hot, images_c,
            body_t_world=body_t_world,
            num_inliers=num_inliers,
            inliers_cn=inliers.reshape(c, n),
            rms_error=rms,
            init_body_t_world=init_body_t_world,
            key=key,
            cam_active=cam_active_c,
            fresh_id_base=fresh_id_base,
            id_advance=c_full * n_full,
            covariance=cov,
            keyframe_minter=keyframe_minter,
        )
        out = out._replace(
            num_matches=jax.lax.psum(out.num_matches, AXIS),
            num_landmarks=jax.lax.psum(out.num_landmarks, AXIS),
        )
        return new_state, out

    def body_nopred(setup_c, state, images_c, cam_active_c):
        return spmd_body(setup_c, state, images_c, cam_active_c, None)

    def body_pred(setup_c, state, images_c, cam_active_c, pred):
        return spmd_body(setup_c, state, images_c, cam_active_c, pred)

    def _shard(fn, with_pred):
        # cam_active shards with its cameras in cam mode (each device masks
        # its own shard); replicated in slot mode (every device sees all C).
        cam_active_spec = P(AXIS) if axis_mode == "cam" else P()
        in_specs = (setup_specs, state_specs, images_spec, cam_active_spec)
        if with_pred:
            in_specs = in_specs + (P(),)
        return jax.shard_map(
            fn, mesh=mesh, in_specs=in_specs,
            out_specs=(state_specs, out_specs_out), check_vma=False,
        )

    def _step(state, images, pose_prediction=None, cam_active=None):
        if cam_active is None:  # resolved at trace time: all-live mask
            cam_active = jnp.ones(params.num_cams, bool)
        if pose_prediction is None:
            new_state, out = _shard(body_nopred, False)(
                setup_sharded, state, images, cam_active
            )
        else:
            new_state, out = _shard(body_pred, True)(
                setup_sharded, state, images, cam_active, pose_prediction
            )
        return trk._pack_returns(pack, new_state, out)

    return jax.jit(_step, donate_argnums=(0,) if donate else ())
