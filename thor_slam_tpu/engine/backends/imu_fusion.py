"""IMU fusion backend: buffering, gravity estimation, pose prediction.

The cuVSLAM IMU-fusion role (reference
launch/thor_visual_slam.launch.py:80-104) re-housed as an explicit
engine backend. Everything here is host-side scalar math on finalized
data — a device dispatch would cost a host–device round trip per tick,
and the windows are <=64 samples.

Owns the finalized-pose SHADOW: the last pose/timestamp/velocity the
host has actually finalized. Every prediction integrates from the
shadow, never from the live device state (which would sync on in-flight
ticks and, at pipeline depth > 1, read the wrong tick).
"""

from __future__ import annotations

import logging

import numpy as np

logger = logging.getLogger(__name__)

#: Gravity-filter process noise for odom-frame attitude drift,
#: (m/s^2)^2 per second. VO yaw/pitch drift slowly rotates the odom frame
#: the gravity vector is expressed in, so the filter must keep a gain
#: floor; this value reproduces the empirically tuned round-3 EMA floor
#: (alpha 0.005/window at the flagship 30 fps / 2 mm solve-noise point:
#: alpha_ss = sqrt(Q dt / R) with R = 4 sigma_p^2/dt^4 ~ 13 (m/s^2)^2
#: => Q = alpha_ss^2 R / dt ~ 1e-2).
GRAVITY_DRIFT_Q = 9.8e-3


def _rot_log_np(r: np.ndarray) -> np.ndarray:
    """SO(3) log map (numpy): rotation matrix -> axis-angle vector."""
    from thor_slam_tpu import geometry

    q = geometry.matrix_to_quat(np.asarray(r, np.float64))
    if q[3] < 0.0:
        q = -q
    s = float(np.linalg.norm(q[:3]))
    if s < 1e-12:
        return np.zeros(3)
    return q[:3] * (2.0 * np.arctan2(s, float(q[3])) / s)


class ImuFusion:
    """IMU ingest + online gravity/bias estimation + pose prediction.

    The noise model is the reference's measured OAK-D Pro densities
    (reference launch/thor_visual_slam.launch.py:82-104, re-exported as
    the ``engine.imu`` module constants): the gyro noise density and
    random walk set the gyro-bias Kalman gain, the accel noise density
    and random walk set the gravity filter gain, and the densities
    propagate the held-pose covariance over untracked windows
    (:meth:`window_covariance`).

    Args:
        body_r_imu: (3, 3) rotation IMU -> body frame.
        use_accel: Enable the accelerometer path (gravity estimation +
            Forster translation prediction); gyro-only otherwise.
        gravity_min_ticks: Gravity observations required before the accel
            term engages (constant-velocity fallback until then).
        capacity: Raw-sample ring length.
        pred_capacity: Fixed preintegration-window size (samples).
        gyro_noise_density: rad/s/sqrt(Hz); None = the declared default.
        gyro_random_walk: rad/s^2/sqrt(Hz); None = the declared default.
        accel_noise_density: m/s^2/sqrt(Hz); None = the declared default.
        accel_random_walk: m/s^3/sqrt(Hz); None = the declared default.
        vis_rot_sigma: Per-solve visual rotation error std (rad) — the
            other noise source in the bias observation.
        vis_pos_sigma: Per-solve visual position error std (m) — enters
            the gravity observation's double-differencing variance.
        estimate_gyro_bias: Estimate the gyro bias online from
            visual-vs-gyro window rotation residuals (Kalman; consumed by
            every host preintegration). Off = zero bias, the round-3
            behavior.
    """

    def __init__(
        self,
        body_r_imu: np.ndarray | None = None,
        use_accel: bool = True,
        gravity_min_ticks: int = 30,
        capacity: int = 256,
        pred_capacity: int = 64,
        gyro_noise_density: float | None = None,
        gyro_random_walk: float | None = None,
        accel_noise_density: float | None = None,
        accel_random_walk: float | None = None,
        vis_rot_sigma: float = 5e-4,
        vis_pos_sigma: float = 2e-3,
        estimate_gyro_bias: bool = True,
    ) -> None:
        from thor_slam_tpu.engine import imu as imu_mod

        self.body_r_imu = np.eye(3) if body_r_imu is None else np.asarray(body_r_imu, np.float64)
        self.use_accel = use_accel
        self._gravity_min_ticks = int(gravity_min_ticks)
        self._capacity = capacity
        self._pred_capacity = pred_capacity
        self.gyro_nd = (
            imu_mod.GYRO_NOISE_DENSITY if gyro_noise_density is None else float(gyro_noise_density)
        )
        self.gyro_rw = (
            imu_mod.GYRO_RANDOM_WALK if gyro_random_walk is None else float(gyro_random_walk)
        )
        self.accel_nd = (
            imu_mod.ACCEL_NOISE_DENSITY
            if accel_noise_density is None
            else float(accel_noise_density)
        )
        self.accel_rw = (
            imu_mod.ACCEL_RANDOM_WALK if accel_random_walk is None else float(accel_random_walk)
        )
        self.vis_rot_sigma = float(vis_rot_sigma)
        self.vis_pos_sigma = float(vis_pos_sigma)
        self.estimate_gyro_bias = bool(estimate_gyro_bias)
        self._ts: list[float] = []
        self._gyro: list[np.ndarray] = []
        self._accel: list[np.ndarray] = []
        #: Online gyro-bias estimate (IMU frame, rad/s) and its per-axis
        #: variance. Scalar isotropic Kalman: each tracked window yields a
        #: bias observation b = Log(dR_vis^T dR_gyro)/tau whose variance
        #: is 2 (vis_rot_sigma/tau)^2 (two solved endpoint rotations) +
        #: gyro_nd^2/tau (integrated white noise); the state random-walks
        #: at gyro_rw^2 tau per window. Prior: (0.02 rad/s)^2, a typical
        #: MEMS turn-on bias.
        self.gyro_bias = np.zeros(3)
        self.bias_p = 4e-4
        # Online gravity estimate in the ODOM frame (scalar Kalman over
        # per-tick observations g = a_w - R f; see _observe_gravity).
        # None until the first observation.
        self.gravity_w: np.ndarray | None = None
        #: Gravity-estimate per-axis variance ((m/s^2)^2). Prior is huge
        #: (first observation is adopted outright); the process noise per
        #: window is the accel-bias random walk (the estimate absorbs the
        #: accel bias) plus GRAVITY_DRIFT_Q for odom-frame attitude drift
        #: — the term that keeps the steady-state gain from freezing.
        self.grav_p = 1e4
        self.gravity_n = 0
        # Finalized-pose shadow (see module docstring). ``fin_vel`` is the
        # INSTANTANEOUS velocity estimate at fin_ts (what the prediction's
        # constant-velocity term wants); ``_fin_vel_avg`` the previous
        # window's AVERAGE velocity (what the gravity double-difference
        # derivation is written in terms of).
        self.fin_pose: np.ndarray | None = None
        self.fin_ts: float | None = None
        self.fin_vel = np.zeros(3)
        self._fin_vel_avg = np.zeros(3)
        #: Timestamp of the finalized pose BEFORE the last one (None until
        #: two windows exist) — the gravity observation differentiates the
        #: average velocities of two consecutive finalized windows.
        self.fin_ts_prev: float | None = None
        # Correction-epoch identities at the last two finalizes. The
        # gravity observation double-differences three finalized poses; a
        # BA correction landing anywhere across that span would enter a_w
        # amplified 2/dt^2-fold (a 5 mm nudge at 30 fps reads as ~9 m/s^2
        # — inside the junk gate, and BA corrections are not zero-mean, so
        # the EMA would be directionally biased). Epochs are replaced,
        # never mutated, so identity comparison detects any correction.
        self._fin_epoch = None
        self._fin_epoch_prev = None
        #: Count of preintegration windows that contained no samples
        #: (nonzero growth while enabled means the IMU path is dead).
        self.empty_windows = 0

    def reset(self) -> None:
        """Drop samples, the gravity/bias estimates, and the pose shadow."""
        self._ts, self._gyro, self._accel = [], [], []
        self.gravity_w = None
        self.grav_p = 1e4
        self.gravity_n = 0
        self.gyro_bias = np.zeros(3)
        self.bias_p = 4e-4
        self.empty_windows = 0
        self.reset_shadow()

    def reset_shadow(self) -> None:
        """Invalidate the finalized-pose shadow (pose discontinuity:
        relocalization, state restore) — prediction waits for the next
        finalize; the gravity EMA restarts (the odom frame moved)."""
        self.fin_pose = None
        self.fin_ts = None
        self.fin_vel = np.zeros(3)
        self._fin_vel_avg = np.zeros(3)
        self.fin_ts_prev = None
        self._fin_epoch = None
        self._fin_epoch_prev = None
        # The odom frame moved: gravity (expressed in it) restarts. The
        # gyro bias is an IMU-frame quantity and survives.
        self.gravity_w = None
        self.grav_p = 1e4
        self.gravity_n = 0

    # --------------------------------------------------------- ingest

    def ingest(self, sensor_data: dict, sensor_ts: float | None) -> None:
        """Buffer IMU samples (single dict or driver-batched arrays)."""
        # Guard the RAW dict values: np.asarray(None) is an object array
        # (never None), so converting first would let a malformed payload
        # through to crash pack_imu_window ticks later.
        raw_acc = sensor_data.get("accelerometer")
        raw_gyr = sensor_data.get("gyroscope")
        if raw_acc is None or raw_gyr is None:
            return
        acc = np.asarray(raw_acc, np.float64)
        gyr = np.asarray(raw_gyr, np.float64)
        if acc.ndim == 2:  # batched packet (synthetic source / DepthAI batching)
            raw_ts = sensor_data.get("timestamps")
            ts = None if raw_ts is None else np.asarray(raw_ts, np.float64)
            if ts is not None and len(ts) < acc.shape[0]:
                return  # malformed batch: fewer timestamps than samples
            for i in range(acc.shape[0]):
                t = float(ts[i]) if ts is not None else (sensor_ts or 0.0)
                if not self._ts or t > self._ts[-1]:
                    self._ts.append(t)
                    self._gyro.append(gyr[i])
                    self._accel.append(acc[i])
        else:
            t = float(sensor_data.get("timestamp", sensor_ts or 0.0))
            if not self._ts or t > self._ts[-1]:
                self._ts.append(t)
                self._gyro.append(gyr)
                self._accel.append(acc)
        if len(self._ts) > self._capacity:
            del self._ts[: -self._capacity]
            del self._gyro[: -self._capacity]
            del self._accel[: -self._capacity]

    @property
    def num_samples(self) -> int:
        return len(self._ts)

    # --------------------------------------------- finalized-pose shadow

    def on_finalized(
        self,
        world_t_body: np.ndarray,
        ts: float,
        tracked: bool,
        epoch,
    ) -> None:
        """Advance the shadow with one finalized pose.

        Args:
            world_t_body: The finalized (epoch-lifted) odom-frame pose.
            ts: Its timestamp.
            tracked: Whether the solve had enough inliers — only tracked
                solves observe gravity (warm-up poses are noise and
                double-differencing amplifies them 2/dt^2-fold).
            epoch: The CURRENT correction-epoch object (identity-compared
                across finalizes; see ``_fin_epoch`` above).
        """
        if self.fin_ts is not None and ts > self.fin_ts:
            from thor_slam_tpu.engine import imu as imu_mod

            dt = ts - self.fin_ts
            v_avg = (world_t_body[:3, 3] - self.fin_pose[:3, 3]) / dt
            g_, a_, d_, m_ = imu_mod.pack_imu_window(
                self._ts, self._gyro, self._accel,
                t_start=self.fin_ts, t_end=ts, capacity=self._pred_capacity,
            )
            if (
                self.estimate_gyro_bias
                and tracked
                and self._fin_epoch is epoch
                and m_.sum() >= 3
            ):
                self._observe_gyro_bias(world_t_body, g_, d_, m_, dt)
            if (
                self.use_accel
                and self.fin_ts_prev is not None
                and tracked
                and self._fin_epoch_prev is epoch
            ):
                self._observe_gravity(v_avg, ts)
            # Half-step propagation: v_avg lags the instantaneous v(ts)
            # by ~a*dt/2 (under constant acceleration v(ts) = v_avg +
            # 0.5*a*dt with a*dt = g*dt + R0*delta_v); without it the
            # Forster term cancels only about half the constant-velocity
            # prediction error. Engaged with the accel term (needs the
            # gravity estimate); v_avg otherwise.
            v_inst = v_avg
            if self.accel_pred_active() and m_.sum() >= 1:
                pre = imu_mod.preintegrate_fast_np(
                    g_, a_, d_, m_, gyro_bias=self.gyro_bias
                )
                v_inst = v_avg + 0.5 * (
                    self.gravity_w * dt
                    + self.fin_pose[:3, :3] @ (self.body_r_imu @ pre.delta_v)
                )
            self.fin_ts_prev = self.fin_ts
            self._fin_epoch_prev = self._fin_epoch
            self.fin_vel = v_inst
            self._fin_vel_avg = v_avg
        self.fin_pose = world_t_body
        self.fin_ts = ts
        self._fin_epoch = epoch

    def on_correction(self, world_t_body: np.ndarray, t_corr: np.ndarray, epoch) -> None:
        """A BA correction just moved the live state: re-anchor the shadow.

        The next prediction must integrate from where the device actually
        is; the shadow velocity transforms like a free vector under the
        left-applied correction (translation cancels in the difference of
        two corrected endpoints) — same rotation the device's velocity_w
        receives.
        """
        self.fin_pose = world_t_body
        self._fin_epoch = epoch
        self.fin_vel = t_corr[:3, :3] @ self.fin_vel

    # ---------------------------------------------------- gyro bias

    def _observe_gyro_bias(
        self,
        world_t_body: np.ndarray,
        g_: np.ndarray,
        d_: np.ndarray,
        m_: np.ndarray,
        dt: float,
    ) -> None:
        """Kalman-update the gyro bias from one finalized window.

        Integrating the RAW gyro over the window over-rotates the visual
        relative rotation by ~Exp(b tau) (first order in the bias; the
        BCH correction is negligible at 30 fps window angles), so the
        log-rotation difference observes the bias in the IMU frame. The
        gyro coverage tau (last sample - window start) trails the pose
        gap dt by up to one sample period, so the visual log-rotation is
        RESCALED to tau before differencing — comparing unequal spans
        would alias the true angular rate into the bias (at 200 Hz / 30
        fps / 0.5 rad/s the aliasing is ~0.037 rad/s, 4x the OAK's
        typical turn-on bias). The gain comes from the DECLARED noise
        model: the observation variance is two solved endpoint rotations
        (2 (vis_rot_sigma/tau)^2) plus the integrated gyro white noise
        (gyro_nd^2/tau); the state random-walks at gyro_rw^2 tau.
        """
        from thor_slam_tpu.engine import imu as imu_mod

        tau = float(d_.sum())
        if tau < 0.5 * dt or tau <= 1e-6:
            return  # samples cover too little of the pose gap
        dr_gyro = imu_mod.gyro_delta_r_np(g_, d_, m_)  # IMU frame, raw
        rbi = self.body_r_imu
        dr_vis = rbi.T @ (self.fin_pose[:3, :3].T @ world_t_body[:3, :3]) @ rbi
        phi_vis = _rot_log_np(dr_vis) * (tau / dt)  # rescaled to coverage
        b_obs = (_rot_log_np(dr_gyro) - phi_vis) / tau
        if float(np.linalg.norm(b_obs - self.gyro_bias)) > 0.5:
            return  # junk gate: solve glitch / clock skew (rad/s)
        r_meas = 2.0 * (self.vis_rot_sigma / tau) ** 2 + self.gyro_nd**2 / tau
        self.bias_p += self.gyro_rw**2 * tau
        k = self.bias_p / (self.bias_p + r_meas)
        self.gyro_bias = self.gyro_bias + k * (b_obs - self.gyro_bias)
        self.bias_p *= 1.0 - k

    # ------------------------------------------------------ gravity

    def _observe_gravity(self, v_new: np.ndarray, ts: float) -> None:
        """Kalman-update the gravity estimate (odom frame).

        Between the midpoints of two consecutive finalized windows the
        differenced average velocities measure the TOTAL world-frame
        acceleration; subtracting the rotated mean specific force over the
        same interval leaves gravity: ``f = R^T (a_w - g)`` so
        ``g = a_w - R f``. Valid under arbitrary motion — centripetal and
        linear acceleration appear identically in both terms and cancel —
        so no quasi-static gate is needed.

        The gain comes from the DECLARED noise model: the observation
        variance is double-differencing of solved positions
        (4 vis_pos_sigma^2/dt^4 — tens of (m/s^2)^2 at millimeter solve
        noise, which is why single observations look like junk yet the
        filter converges) plus the windowed accel white noise
        (accel_nd^2/dt); the state random-walks at the accel-bias walk
        (the gravity estimate absorbs the accel bias) plus
        GRAVITY_DRIFT_Q for odom-frame attitude drift. With the huge
        prior this behaves as a running mean early and floors at the
        drift-tracking gain — the round-3 EMA schedule, now derived.
        """
        m0 = 0.5 * (self.fin_ts_prev + self.fin_ts)
        m1 = 0.5 * (self.fin_ts + ts)
        dt = m1 - m0
        if dt <= 1e-6 or not self._ts:
            return
        ts_arr = np.asarray(self._ts)
        sel = (ts_arr > m0) & (ts_arr <= m1)
        if not np.any(sel):
            return
        f_imu = np.mean(np.asarray(self._accel)[sel], axis=0)
        a_w = (v_new - self._fin_vel_avg) / dt
        g_obs = a_w - self.fin_pose[:3, :3] @ (self.body_r_imu @ f_imu)
        # Junk-only guard (solve glitch, clock skew, teleport). The
        # double-differencing noise is zero-mean; a TIGHT norm gate here
        # would clip the distribution asymmetrically and bias the mean
        # low (measured: a (4, 16) gate converged to |g| = 6.3).
        if float(np.linalg.norm(g_obs)) > 60.0:
            return
        r_meas = 4.0 * self.vis_pos_sigma**2 / dt**4 + self.accel_nd**2 / dt
        if self.gravity_w is None:
            self.gravity_w = g_obs
            self.grav_p = r_meas
        else:
            self.grav_p += (self.accel_rw**2 + GRAVITY_DRIFT_Q) * dt
            k = self.grav_p / (self.grav_p + r_meas)
            self.gravity_w = self.gravity_w + k * (g_obs - self.gravity_w)
            self.grav_p *= 1.0 - k
        self.gravity_n += 1

    def window_covariance(self, dt: float) -> np.ndarray:
        """6x6 pose-covariance growth over one UNTRACKED window of ``dt``.

        When the solve lacks support the tracker holds the IMU/constant-
        velocity prediction; the reported covariance must then grow by the
        prediction's own uncertainty instead of quoting the meaningless
        low-inlier solve covariance. Diagonal, from the declared noise
        model: rotation = integrated gyro white noise + bias uncertainty
        (gyro_nd^2 dt + bias_p dt^2); translation = velocity-estimate
        noise carried over dt (2 vis_pos_sigma^2 — the differenced solved
        endpoints — the dominant term) + gravity uncertainty and accel
        noise double-integrated.
        """
        dt = max(float(dt), 1e-4)
        rot_var = self.gyro_nd**2 * dt + float(self.bias_p) * dt * dt
        grav_p = float(self.grav_p) if self.gravity_w is not None else 0.0
        pos_var = (
            2.0 * self.vis_pos_sigma**2
            + grav_p * (0.5 * dt * dt) ** 2
            + self.accel_nd**2 * dt**3
        )
        return np.diag([pos_var] * 3 + [rot_var] * 3)

    def accel_pred_active(self) -> bool:
        """Whether the accel term of the pose prediction is engaged."""
        return (
            self.use_accel
            and self.gravity_w is not None
            and self.gravity_n >= self._gravity_min_ticks
            and 8.0 < float(np.linalg.norm(self.gravity_w)) < 12.0
        )

    # ----------------------------------------------------- prediction

    def predict(self, ts: float) -> np.ndarray | None:
        """Preintegrated IMU pose prediction from the finalized shadow.

        Rotation is always gyro-preintegrated (the part that breaks
        constant-velocity models). Translation upgrades from
        constant-velocity extrapolation to the full Forster form
        ``p + v dt + 1/2 g dt^2 + R delta_p`` once the online odom-frame
        gravity estimate has converged (see :meth:`_observe_gravity`) —
        the cuVSLAM IMU-fusion role (reference
        launch/thor_visual_slam.launch.py:80-104).

        ``fin_vel`` is the finalized-window average velocity propagated
        to the window end by the half-step correction in
        :meth:`on_finalized` (once the accel term is active), so the
        constant-velocity term extrapolates from the INSTANTANEOUS
        velocity rather than one lagging by ~a*dt/2.
        """
        if self.fin_ts is None or len(self._ts) < 2:
            return None
        from thor_slam_tpu.engine import imu as imu_mod

        # Window starts at the last FINALIZED tick (the pose shadow's
        # timestamp): at pipeline depth d the window spans d+1 ticks of
        # samples, so the prediction always integrates from a pose the
        # host actually has (never the in-flight live state).
        g, a, d, m = imu_mod.pack_imu_window(
            self._ts, self._gyro, self._accel,
            t_start=self.fin_ts, t_end=ts, capacity=self._pred_capacity,
        )
        if m.sum() < 1:
            # A dead IMU path must be VISIBLE: with use_imu=True the engine
            # silently degrades to constant-velocity when every window is
            # empty (e.g. a source delivering samples one tick late).
            self.empty_windows += 1
            if self.empty_windows in (10, 100) or self.empty_windows % 1000 == 0:
                logger.warning(
                    "IMU enabled but %d preintegration windows were empty — "
                    "samples may be arriving late or not at all",
                    self.empty_windows,
                )
            return None
        # Host (no device round trip). Before gravity convergence the
        # accel integral would be meaningless, so only delta_r is
        # integrated and translation stays constant-velocity.
        rbi = self.body_r_imu
        accel_active = self.accel_pred_active()
        if accel_active:
            pre = imu_mod.preintegrate_fast_np(g, a, d, m, gyro_bias=self.gyro_bias)
            delta_r_body = rbi @ pre.delta_r @ rbi.T
        else:
            delta_r_body = (
                rbi @ imu_mod.gyro_delta_r_np(g, d, m, gyro_bias=self.gyro_bias) @ rbi.T
            )

        # Integrate forward from the finalized-pose SHADOW: reading the
        # live device state here would block on every in-flight tick (a
        # host–device round trip per tick) and at depth > 1
        # would read a pose ticks ahead of the IMU window's start.
        fin = self.fin_pose
        pred = np.eye(4)
        pred[:3, :3] = fin[:3, :3] @ delta_r_body
        pred[:3, 3] = fin[:3, 3] + self.fin_vel * (ts - self.fin_ts)
        if accel_active:
            # Forster propagation: the specific-force double integral
            # (rotated into the body frame at the window start) plus the
            # gravity parabola over the integrated span. delta_p spans
            # pre.dt (the samples' coverage), which may trail ts by a
            # fraction of a sample period — the constant-velocity term
            # above already covers the full (fin_ts, ts] gap.
            pred[:3, 3] += 0.5 * self.gravity_w * pre.dt * pre.dt + fin[
                :3, :3
            ] @ (rbi @ pre.delta_p)
        # numpy, NOT jnp.asarray(..., f32): an eager dtype-converting
        # device op costs a dispatch per tick; the jitted step's call
        # boundary uploads the 64-byte operand for free.
        return pred.astype(np.float32)
