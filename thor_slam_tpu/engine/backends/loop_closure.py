"""Loop-closure / place-recognition backend.

The cuVSLAM loop-closure role (reference
launch/thor_visual_slam.launch.py:30-64 — the capability the reference
delegates wholesale). Owns the place database (host entries + a
device-resident descriptor ring), the ASYNC detect -> verify machine,
the noise-floor discrepancy gate, the pose-graph solve, and
relocalization against a loaded map.

Consumes only FINALIZED keyframe signatures (``pack_kf_sig``) — never
the live device state — so it runs unchanged at any pipeline depth. All
map-side artifacts it stores (entry poses, landmark positions) live in
the MAP frame; the engine composes returned corrections into its
``map_t_odom`` and rewrites its keyframe trajectory.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np

from thor_slam_tpu.engine import loop, posegraph
from thor_slam_tpu.ops import rectify

logger = logging.getLogger(__name__)


def _next_pow2(k: int, floor: int = 8) -> int:
    """Smallest power of two >= max(k, floor) (jit shape bucketing)."""
    cap = floor
    while cap < k:
        cap *= 2
    return cap


class LoopBackend:
    """Place DB + async loop detection/verification + pose graph.

    Args mirror the engine's ``loop_*`` parameters (see
    :class:`~thor_slam_tpu.engine.tpu_engine.TpuSlamEngine`).

    The DB is **multi-camera**: each keyframe entry stores EVERY camera's
    signature (descriptors + map-frame landmarks), and detection looks the
    query camera up against all of them — one camera axis folded into the
    matmul lookup's keyframe axis. On a rig whose mounts cover the yaw space
    (the reference's 4 cameras at spread yaws, examples/assets/
    brackets.urdf) this is what makes revisits recognizable from ANY
    heading: a reverse-heading repass is matched by the forward camera
    against what a rear-facing camera recorded on the first pass.
    Verification needs no special casing — stored landmarks are world
    (map)-frame, so PnP of the query camera's observations against them
    yields the body pose regardless of which camera minted them.
    """

    def __init__(
        self,
        capacity: int = 256,
        min_votes: int = 60,
        min_inliers: int = 40,
        exclude_recent: int = 12,
        cooldown_kfs: int = 20,
        min_correction_m: float = 0.05,
        noise_gate_sigma: float = 3.0,
    ) -> None:
        self.capacity = capacity
        self.min_votes = min_votes
        self.min_inliers = min_inliers
        self.exclude_recent = exclude_recent
        self.cooldown_kfs = cooldown_kfs
        self.min_correction_m = min_correction_m
        self.noise_gate_sigma = noise_gate_sigma
        self.db: list[dict] = []
        self.loops_closed = 0
        self.kf_total = 0
        self._cooldown = 0
        #: In-flight async loop detection/verification (see poll).
        self._pending: dict | None = None
        # Device-resident place-DB descriptor ring (fixed CAP shape,
        # donated in-place inserts): detection reads it where it lives
        # instead of re-uploading the multi-MB database per keyframe.
        self._dev_desc = None
        self._dev_valid = None
        self._insert = None
        self._setup = None
        self._max_keypoints = 0
        self._num_cams = 1

    def bind(self, setup, max_keypoints: int) -> None:
        self._setup = setup
        self._max_keypoints = max_keypoints
        self._num_cams = int(np.asarray(setup.k_left).shape[0])

    def reset(self) -> None:
        self.db = []
        self.loops_closed = 0
        self.kf_total = 0
        self._cooldown = 0
        self._pending = None
        self._dev_desc = None
        self._dev_valid = None

    @property
    def has_pending(self) -> bool:
        return self._pending is not None

    # ------------------------------------------------------ device ring

    def _ensure_dev_db(self) -> None:
        """Allocate the device-resident entry ring + insert kernel.

        The ring is FLAT over (keyframe slot, camera): shape
        (capacity * C, N, 8) — keyframe ``slot`` owns rows
        ``[slot*C, (slot+1)*C)``. ``find_candidate`` consumes it as-is
        (entries are just rows to it); the host decodes a winning row
        back to (slot, camera).
        """
        if self._dev_desc is not None:
            return
        cap, n, c = self.capacity, self._max_keypoints, self._num_cams
        self._dev_desc = jnp.zeros((cap * c, n, 8), jnp.uint32)
        self._dev_valid = jnp.zeros((cap * c, n), bool)

        def insert(db_d, db_v, row0, d, v):
            return (
                jax.lax.dynamic_update_slice_in_dim(db_d, d, row0, 0),
                jax.lax.dynamic_update_slice_in_dim(db_v, v, row0, 0),
            )

        self._insert = jax.jit(insert, donate_argnums=(0, 1))

    def _fit_cams(self, arr: np.ndarray) -> np.ndarray:
        """Crop/zero-pad an entry array's camera axis to this session's C
        (a loaded map may have been recorded on a different rig)."""
        c = self._num_cams
        if arr.shape[0] == c:
            return arr
        out = np.zeros((c,) + arr.shape[1:], arr.dtype)
        out[: min(c, arr.shape[0])] = arr[:c]
        return out

    def rebuild_dev_db(self) -> None:
        """Re-seed the device ring from the host DB (map load / reset)."""
        self._dev_desc = None
        if not self.db:
            return
        self._ensure_dev_db()
        cap = self.capacity
        n = self._max_keypoints
        c = self._num_cams
        desc = np.zeros((cap, c, n, 8), np.uint32)
        valid = np.zeros((cap, c, n), bool)
        for e in self.db:
            # A loaded map may have been recorded at a different keypoint
            # budget — crop/zero-pad its rows into this session's shape.
            ed, ev = self._fit_cams(e["desc"]), self._fit_cams(e["valid"])
            k = min(n, ed.shape[1])
            desc[e["slot"], :, :k] = ed[:, :k]
            valid[e["slot"], :, :k] = ev[:, :k]
        self._dev_desc = jnp.asarray(desc.reshape(cap * c, n, 8))
        self._dev_valid = jnp.asarray(valid.reshape(cap * c, n))

    # -------------------------------------------------------- keyframes

    def on_keyframe(
        self,
        world_t_body: np.ndarray,
        ts: float,
        sig: dict,
        map_t_odom: np.ndarray,
        frame_count: int,
    ) -> None:
        """Record a keyframe signature; maybe start an async detection.

        ``world_t_body`` is the MAP-frame keyframe pose; ``sig`` the
        unpacked finalized ALL-camera keyframe signature (arrays carry a
        leading camera axis). Landmark positions are stored in the MAP
        frame so verification against them yields map-frame constraints
        directly. The detection query is the camera-0 bank; the DB it
        searches holds every camera's signature of every keyframe.
        """
        m = map_t_odom
        c = self._num_cams
        slot = self.kf_total % self.capacity
        self.kf_total += 1
        entry = {
            "desc": self._fit_cams(sig["desc"]),
            "valid": self._fit_cams(sig["valid"]),
            "lm_w": self._fit_cams(sig["pos"] @ m[:3, :3].T + m[:3, 3]),
            "obs_px": self._fit_cams(sig["obs_px"]),
            "world_t_body": world_t_body.copy(),
            "ts": ts,
            "slot": slot,
        }
        self.db.append(entry)
        if len(self.db) > self.capacity:
            # Insertion order == slot order, so truncating the host list
            # drops exactly the entry whose ring slot is being reused.
            self.db = self.db[-self.capacity :]
        # Device-resident descriptor ring: ONE incremental ~C x 10 KB
        # insert per keyframe instead of re-uploading the whole multi-MB
        # database at every detection (donated in-place update, fixed
        # CAP*C shape — compiles once).
        self._ensure_dev_db()
        self._dev_desc, self._dev_valid = self._insert(
            self._dev_desc, self._dev_valid,
            jnp.asarray(slot * c, jnp.int32),
            jnp.asarray(entry["desc"]), jnp.asarray(entry["valid"]),
        )

        if self._cooldown > 0:
            self._cooldown -= 1
            return
        if len(self.db) <= self.exclude_recent + 1:
            return
        if self._pending is not None:
            return  # a detection/verification is still in flight

        # Eligibility mask over ring rows: present entries minus the
        # recent temporal neighbors (and the query itself) — every
        # camera lane of an eligible keyframe slot.
        mask = np.zeros((self.capacity, c), np.float32)
        for e in self.db[: -self.exclude_recent - 1]:
            mask[e["slot"], :] = 1.0

        # ASYNC detection: dispatch the matmul lookup against the resident
        # ring and poll `votes.is_ready()` on later finalizes — the host
        # never blocks on it, so a keyframe costs zero device syncs here
        # (a closure lands a tick or two after its keyframe; loop
        # corrections are latency-tolerant by construction).
        cand = loop.find_candidate(
            jnp.asarray(entry["desc"][0]), jnp.asarray(entry["valid"][0]),
            self._dev_desc, self._dev_valid, jnp.asarray(mask.reshape(-1)),
        )
        self._pending = {
            "stage": "find",
            "cand": cand,
            "query": entry,
            "query_map_pose": world_t_body.copy(),
            "frame_count": frame_count,
        }

    def _match_pose(self, cand_e: dict, cam: int) -> np.ndarray:
        """Heading-aware initial body pose for verifying a DB hit.

        The candidate entry was recorded by camera ``cam``; the query sees
        the same content through camera 0. If both cameras faced the scene
        from (approximately) the same spot, the query body pose satisfies
        ``W_T_qb @ B_T_c0 ~= W_T_cb @ B_T_ccam``, i.e.::

            W_T_qb ~= cand_pose @ body_t_cam[cam] @ inv(body_t_cam[0])

        For a same-camera hit (cam == 0) this degenerates to the
        candidate's own pose — already the right init (the query is near
        the revisited keyframe; its own live pose carries exactly the
        drift the constraint is supposed to measure, so initializing from
        it biases the solve by that drift). For a CROSS-camera hit the
        mount composition rotates the init by the inter-camera yaw — a
        reverse-heading revisit initializes ~pi away from the query's
        live heading, far outside what a fixed-iteration Gauss-Newton
        refinement could recover on its own (measured: initializing from
        the drifted query pose found 0 inliers on every reverse-heading
        candidate; this init verifies them).
        """
        b_t_cam = np.asarray(self._setup.body_t_cam, np.float64)
        return cand_e["world_t_body"] @ b_t_cam[cam] @ np.linalg.inv(b_t_cam[0])

    # ------------------------------------------------------------- poll

    def poll(self, block: bool = False, diagnostics: dict | None = None):
        """Advance the async machine; returns an applied-closure record.

        Stages: ``find`` (appearance lookup in flight) -> ``verify``
        (geometric RANSAC in flight) -> apply (pose graph, host-gated).
        Call at every finalize; with ``block=True`` (stream flush) it
        drains to completion.

        Returns:
            None, or ``(t_corr, opt_poses, kk, info)`` where ``t_corr``
            is the map<-map delta for the newest node (compose into
            ``map_t_odom``), ``opt_poses`` the smoothed MAP-frame DB
            trajectory (the engine rewrites its keyframe tail with it),
            ``kk`` its length, and ``info`` a log dict. The backend's own
            DB has already been rewritten.
        """
        p = self._pending
        if p is None:
            return None
        if p["stage"] == "find":
            if not (block or p["cand"].votes.is_ready()):
                return None
            votes_a, row_a = jax.device_get(
                (p["cand"].votes, p["cand"].keyframe)
            )  # one round trip
            votes = int(votes_a)
            if votes < self.min_votes:
                self._pending = None
                return None
            slot, cam = divmod(int(row_a), self._num_cams)
            cand_e = next((e for e in self.db if e["slot"] == slot), None)
            if cand_e is None:  # evicted while the lookup was in flight
                self._pending = None
                return None
            entry = p["query"]
            # Geometric verification: the winning CAMERA's stored landmarks
            # (map frame — camera-agnostic) vs the query camera-0
            # observations — dispatched async, polled like the lookup.
            k0 = np.asarray(self._setup.k_left[0])
            d0 = np.asarray(self._setup.dist_left[0])
            xn = np.stack(
                [
                    (entry["obs_px"][0][:, 0] - k0[2]) / k0[0],
                    (entry["obs_px"][0][:, 1] - k0[3]) / k0[1],
                ],
                -1,
            )
            obs_norm = rectify.undistort_normalized(xn, d0).astype(np.float32)
            p["ver"] = loop.verify_candidate(
                jax.random.PRNGKey(p["frame_count"]),
                jnp.asarray(cand_e["lm_w"][cam], jnp.float32),
                jnp.asarray(cand_e["valid"][cam]),
                jnp.asarray(cand_e["desc"][cam]),
                jnp.asarray(obs_norm),
                jnp.asarray(entry["desc"][0]),
                jnp.asarray(entry["valid"][0]),
                jnp.asarray(self._setup.cam_r_body[0]),
                jnp.asarray(self._setup.cam_t_body[0]),
                jnp.asarray(
                    np.linalg.inv(self._match_pose(cand_e, cam)), jnp.float32
                ),
                min_inliers=self.min_inliers,
            )
            p["votes"] = votes
            p["cand_e"] = cand_e
            p["stage"] = "verify"
            if not block:
                return None
        if p["stage"] == "verify":
            if not (block or p["ver"].accepted.is_ready()):
                return None
            ver = loop.LoopVerification(*jax.device_get(tuple(p["ver"])))
            self._pending = None
            if not bool(ver.accepted):
                return None
            return self._apply(p, ver, diagnostics)
        return None

    def _apply(self, p: dict, ver, diagnostics: dict | None):
        """Gate and apply a verified loop constraint (MAP side only)."""
        entry = p["query"]
        cand_e = p["cand_e"]
        world_t_body = p["query_map_pose"]
        # Discrepancy gate: the loop constraint must disagree with the
        # query's map-frame pose by more than the constraint's OWN noise
        # floor — the verification solve's covariance (its residual-scaled
        # inverse Hessian), not an arbitrary constant. A constraint that
        # cannot distinguish the drift from its own noise has nothing to
        # correct; "closing" it would only inject that noise into the map.
        loop_pose_est = np.linalg.inv(np.asarray(ver.body_t_candidate, np.float64))
        disc = np.linalg.norm(loop_pose_est[:3, 3] - world_t_body[:3, 3])
        sigma_t = float(np.sqrt(max(np.trace(np.asarray(ver.covariance)[:3, :3]), 0.0)))
        noise_floor = max(self.min_correction_m, self.noise_gate_sigma * sigma_t)
        if disc < noise_floor:
            self._cooldown = self.cooldown_kfs
            if diagnostics is not None:
                diagnostics["loop_skip"] = (
                    f"disc {disc:.4f} m < floor {noise_floor:.4f} m (sigma {sigma_t:.4f})"
                )
            return None
        try:
            ci = next(i for i, e in enumerate(self.db) if e is cand_e)
            qi = next(i for i, e in enumerate(self.db) if e is entry)
        except StopIteration:
            return None  # evicted while verification was in flight

        # Pose-graph over the loop DB trajectory: odometry chain + loop
        # edge. Node/edge arrays are padded to a power of two (masked) so
        # the jitted solve compiles O(log capacity) times, not per-closure.
        # The loop edge sits between the CURRENT indices of the candidate
        # and the query (keyframes may have been appended while the
        # verification was in flight — the query need not be the last
        # node).
        poses = np.stack([e["world_t_body"] for e in self.db]).astype(np.float32)
        kk = poses.shape[0]
        kk_pad = _next_pow2(kk)
        e_cap = kk_pad  # chain (kk-1 edges) + 1 loop edge + masked padding
        ei, ej, et, w = posegraph.sequential_graph(poses, capacity_edges=e_cap)
        ei[kk - 1], ej[kk - 1] = ci, qi
        et[kk - 1] = np.linalg.inv(cand_e["world_t_body"]) @ loop_pose_est
        w[kk - 1] = 3.0
        poses_pad = np.tile(np.eye(4, dtype=np.float32), (kk_pad, 1, 1))
        poses_pad[:kk] = poses
        node_mask = np.zeros(kk_pad, np.float32)
        node_mask[:kk] = 1.0
        graph = posegraph.PoseGraph(
            poses=jnp.asarray(poses_pad), node_mask=jnp.asarray(node_mask),
            edge_i=jnp.asarray(ei), edge_j=jnp.asarray(ej),
            edge_t=jnp.asarray(et), edge_weight=jnp.asarray(w),
        )
        opt_poses, _ = posegraph.optimize(graph)
        opt_poses = np.asarray(opt_poses, np.float64)[:kk]

        # Apply — MAP side only. The newest node's correction composes
        # into the map<-odom transform (by the CALLER), the pose graph's
        # smoothed poses rewrite the DB here. The live tracker state
        # (odom) is deliberately untouched: rewriting the landmark bank
        # mid-flight perturbed KLT/PnP and measurably REGRESSED the live
        # stream at low-drift operating points (BASELINE.md ablation round
        # 2: odometry ATE 14.55 -> 15.98 cm) while the map barely gained.
        t_corr = opt_poses[-1] @ np.linalg.inv(poses[-1].astype(np.float64))
        for idx, e in enumerate(self.db):
            e["world_t_body"] = opt_poses[idx]
            # Keep stored landmarks consistent with their rewritten anchor.
            node_corr = opt_poses[idx] @ np.linalg.inv(poses[idx].astype(np.float64))
            e["lm_w"] = e["lm_w"] @ node_corr[:3, :3].T + node_corr[:3, 3]

        self.loops_closed += 1
        self._cooldown = self.cooldown_kfs
        info = {"ci": ci, "qi": qi, "votes": p["votes"], "inliers": int(ver.num_inliers)}
        logger.info(
            "Loop closed: kf %d <-> %d (votes=%d inliers=%d), |corr|=%.3f m",
            ci, qi, info["votes"], info["inliers"], float(np.linalg.norm(t_corr[:3, 3])),
        )
        return t_corr, opt_poses, kk, info

    # ----------------------------------------------------- relocalization

    def relocalize_attempt(self, img, params, frame_count: int):
        """One relocalization attempt against the DB. MAP-frame pose or None.

        ``img`` is the camera-0 left image (host or device, [0,1] f32);
        detection/description run on device, the verified PnP pose is the
        recovered MAP-frame body pose.
        """
        if not self.db:
            return None
        from thor_slam_tpu.ops import brief, fast
        from thor_slam_tpu.ops.image import gaussian_blur

        p = params
        img = jnp.asarray(img)
        if p.median_prefilter:
            # The DB signatures were built from median-filtered frames
            # (tracker prefilter); descriptors must live in the same
            # space or salt noise blows every Hamming gate exactly in
            # the regime the flag exists for.
            from thor_slam_tpu.ops.image import median3x3

            img = median3x3(img)
        kp = fast.detect_keypoints(
            img, threshold=p.fast_threshold, max_keypoints=p.max_keypoints,
            cell_size=p.cell_size, per_cell=p.per_cell, border_margin=p.border_margin,
        )
        desc = brief.compute_descriptors(
            gaussian_blur(img, 2.0, radius=4), kp.xy, kp.valid,
            oriented=p.oriented_descriptors,
        )

        if self._dev_desc is None:
            self.rebuild_dev_db()
        c = self._num_cams
        mask = np.zeros((self.capacity, c), np.float32)
        for e in self.db:
            mask[e["slot"], :] = 1.0
        cand = loop.find_candidate(
            desc.bits, desc.valid, self._dev_desc, self._dev_valid,
            jnp.asarray(mask.reshape(-1)),
        )
        if int(cand.votes) < self.min_votes:
            return None
        slot, cam = divmod(int(cand.keyframe), c)
        cand_e = next((e for e in self.db if e["slot"] == slot), None)
        if cand_e is None:
            return None

        k0 = np.asarray(self._setup.k_left[0])
        d0 = np.asarray(self._setup.dist_left[0])
        xy = np.asarray(kp.xy)
        xn = np.stack([(xy[:, 0] - k0[2]) / k0[0], (xy[:, 1] - k0[3]) / k0[1]], -1)
        obs_norm = rectify.undistort_normalized(xn, d0).astype(np.float32)
        ver = loop.verify_candidate(
            jax.random.PRNGKey(frame_count),
            jnp.asarray(cand_e["lm_w"][cam], jnp.float32),
            jnp.asarray(cand_e["valid"][cam]),
            jnp.asarray(cand_e["desc"][cam]),
            jnp.asarray(obs_norm),
            desc.bits,
            desc.valid,
            jnp.asarray(self._setup.cam_r_body[0]),
            jnp.asarray(self._setup.cam_t_body[0]),
            jnp.asarray(
                np.linalg.inv(self._match_pose(cand_e, cam)), jnp.float32
            ),
            min_inliers=self.min_inliers,
        )
        if not bool(ver.accepted):
            return None
        pose = np.linalg.inv(np.asarray(ver.body_t_candidate, np.float64))
        logger.info(
            "Relocalized against keyframe slot %d cam %d (votes=%d inliers=%d)",
            slot, cam, int(cand.votes), int(ver.num_inliers),
        )
        return pose

    # ----------------------------------------------------- serialization

    def export_arrays(self) -> dict:
        """The place DB as savez-ready arrays (travels with save_map)."""
        if not self.db:
            return {}
        # _fit_cams: entries restored from a legacy (single-camera) map may
        # carry fewer camera lanes than fresh ones — pad to a dense stack.
        return {
            "db_desc": np.stack([self._fit_cams(e["desc"]) for e in self.db]),
            "db_valid": np.stack([self._fit_cams(e["valid"]) for e in self.db]),
            "db_lm_w": np.stack([self._fit_cams(e["lm_w"]) for e in self.db]),
            "db_poses": np.stack([e["world_t_body"] for e in self.db]),
            "db_ts": np.asarray([e["ts"] for e in self.db]),
        }

    def load_arrays(self, data) -> None:
        """Restore the DB from :meth:`export_arrays` output (map load).

        A map saved with a larger ``loop_db_capacity`` than this
        session's is truncated to the NEWEST ``capacity`` keyframes —
        wrapping slots modulo capacity would alias two keyframes onto
        one slot and slot-based candidate resolution would verify one
        keyframe's descriptors against another's landmarks.

        Maps saved before the multi-camera DB (per-keyframe arrays with
        no camera axis) load as single-camera entries; ``_fit_cams``
        pads them to the session's camera count at use.
        """
        n = int(data["db_desc"].shape[0])
        legacy = data["db_desc"].ndim == 3  # (K, N, 8): no camera axis
        start = max(0, n - self.capacity)
        if start:
            logger.warning(
                "Loaded place DB has %d keyframes > capacity %d; keeping the newest %d",
                n, self.capacity, self.capacity,
            )

        def cams(arr):
            return arr[None] if legacy else arr

        self.db = [
            {
                "desc": cams(data["db_desc"][i]),
                "valid": cams(data["db_valid"][i]),
                "lm_w": cams(data["db_lm_w"][i]),
                "obs_px": np.zeros(cams(data["db_lm_w"][i]).shape[:-1] + (2,)),
                "world_t_body": data["db_poses"][i],
                "ts": float(data["db_ts"][i]),
                "slot": i - start,
            }
            for i in range(start, n)
        ]
        self.kf_total = len(self.db)
        self._pending = None
        self.rebuild_dev_db()
