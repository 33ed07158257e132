"""IMU preintegration (Forster-style) — jit-safe, masked, fixed-capacity.

Replaces cuVSLAM's IMU fusion (``enable_imu_fusion``, reference
launch/thor_visual_slam.launch.py:80-93, with measured OAK-D Pro noise
densities). Samples between two frames are integrated on-device with a
`lax.scan` over a fixed-size, mask-padded window, producing the relative
motion increments (delta_r, delta_v, delta_p) used to seed the visual
tracker's pose prediction.

Conventions: body frame measurements; accel measures specific force
(a_body - R^T g); gravity is ``GRAVITY_W`` (z-up world).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from thor_slam_tpu.ops import lie

# numpy, NOT jnp: no module-level device arrays (see ops/match.py).
GRAVITY_W = np.asarray([0.0, 0.0, -9.81])

#: Default noise parameters: the reference's measured OAK-D Pro values
#: (reference launch/thor_visual_slam.launch.py:82-104).
GYRO_NOISE_DENSITY = 8.272e-5  # rad/s/sqrt(Hz)
ACCEL_NOISE_DENSITY = 2.553e-3  # m/s^2/sqrt(Hz)
GYRO_RANDOM_WALK = 1e-8  # rad/s^2/sqrt(Hz)
ACCEL_RANDOM_WALK = 1.0493e-4  # m/s^3/sqrt(Hz)


class Preintegrated(NamedTuple):
    """Relative motion integrated over a window of IMU samples.

    With body frame b0 at the window start and b1 at its end:
    ``delta_r`` maps b1 vectors into b0 (R_{b0 b1}); ``delta_v``/``delta_p``
    are the gravity-free velocity/position increments expressed in b0.

    Attributes:
        delta_r: (3, 3).
        delta_v: (3,).
        delta_p: (3,).
        dt: () total integrated time.
        count: () number of samples actually integrated.
    """

    delta_r: jnp.ndarray
    delta_v: jnp.ndarray
    delta_p: jnp.ndarray
    dt: jnp.ndarray
    count: jnp.ndarray


@jax.jit
def preintegrate(
    gyro: jnp.ndarray,
    accel: jnp.ndarray,
    dts: jnp.ndarray,
    mask: jnp.ndarray,
    gyro_bias: jnp.ndarray | None = None,
    accel_bias: jnp.ndarray | None = None,
) -> Preintegrated:
    """Integrate a masked window of IMU samples.

    Args:
        gyro: (N, 3) angular rates (rad/s), body frame.
        accel: (N, 3) specific force (m/s^2), body frame.
        dts: (N,) per-sample integration intervals (s).
        mask: (N,) 1.0/0.0 — padding slots contribute nothing.
        gyro_bias: Optional (3,) gyro bias estimate.
        accel_bias: Optional (3,) accel bias estimate.

    Returns:
        A :class:`Preintegrated` increment.
    """
    bg = jnp.zeros(3) if gyro_bias is None else gyro_bias
    ba = jnp.zeros(3) if accel_bias is None else accel_bias

    def step(carry, inp):
        r, v, p, t = carry
        w, a, dt, m = inp
        dt = dt * m
        a_corr = a - ba
        # Position/velocity with the *current* orientation (midpoint-free
        # Euler; sample rates of 200-400 Hz make the error negligible).
        acc0 = r @ a_corr
        p = p + v * dt + 0.5 * acc0 * dt * dt
        v = v + acc0 * dt
        r = r @ lie.so3_exp((w - bg) * dt)
        return (r, v, p, t + dt), None

    init = (jnp.eye(3), jnp.zeros(3), jnp.zeros(3), jnp.asarray(0.0))
    (r, v, p, t), _ = jax.lax.scan(step, init, (gyro, accel, dts, mask))
    return Preintegrated(delta_r=r, delta_v=v, delta_p=p, dt=t, count=jnp.sum(mask).astype(jnp.int32))


@jax.jit
def predict_pose(
    world_t_body: jnp.ndarray,
    velocity_w: jnp.ndarray,
    pre: Preintegrated,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Propagate a world pose + velocity through a preintegrated increment.

    Args:
        world_t_body: (4, 4) pose at the window start.
        velocity_w: (3,) world-frame linear velocity at the window start.
        pre: The integrated increment.

    Returns:
        (world_t_body_end, velocity_w_end).
    """
    r0 = world_t_body[:3, :3]
    p0 = world_t_body[:3, 3]
    dt = pre.dt
    r1 = r0 @ pre.delta_r
    p1 = p0 + velocity_w * dt + 0.5 * GRAVITY_W * dt * dt + r0 @ pre.delta_p
    v1 = velocity_w + GRAVITY_W * dt + r0 @ pre.delta_v
    out = jnp.eye(4).at[:3, :3].set(r1).at[:3, 3].set(p1)
    return out, v1


def preintegrate_np(gyro, accel, dts, mask, gyro_bias=None, accel_bias=None):
    """NumPy twin of :func:`preintegrate` for host-side use.

    The per-frame pose *prediction* integrates <=64 samples of scalar math —
    cheaper on the host than a device dispatch (a host–device round trip).
    Device preintegration remains the right choice
    inside fused graphs (tight VIO, batch evaluation).
    """
    import numpy as np

    from thor_slam_tpu import geometry

    bg = np.zeros(3) if gyro_bias is None else np.asarray(gyro_bias)
    ba = np.zeros(3) if accel_bias is None else np.asarray(accel_bias)
    r = np.eye(3)
    v = np.zeros(3)
    p = np.zeros(3)
    t = 0.0
    for w, a, dt, m in zip(np.asarray(gyro), np.asarray(accel), np.asarray(dts), np.asarray(mask)):
        dt = float(dt) * float(m)
        if dt == 0.0:
            continue
        acc0 = r @ (a - ba)
        p = p + v * dt + 0.5 * acc0 * dt * dt
        v = v + acc0 * dt
        phi = (w - bg) * dt
        angle = float(np.linalg.norm(phi))
        if angle > 0:
            r = r @ geometry.quat_to_matrix(geometry.axis_angle_to_quat(phi, angle))
        t += dt
    return Preintegrated(
        delta_r=r, delta_v=v, delta_p=p, dt=t, count=int(np.sum(mask))
    )


def _quats_to_matrices(q: "np.ndarray") -> "np.ndarray":
    """Batched xyzw quaternion -> rotation matrix ((N, 4) -> (N, 3, 3))."""
    import numpy as np

    x, y, z, w = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    out = np.empty((len(q), 3, 3), np.float64)
    out[:, 0, 0] = 1 - 2 * (y * y + z * z)
    out[:, 0, 1] = 2 * (x * y - z * w)
    out[:, 0, 2] = 2 * (x * z + y * w)
    out[:, 1, 0] = 2 * (x * y + z * w)
    out[:, 1, 1] = 1 - 2 * (x * x + z * z)
    out[:, 1, 2] = 2 * (y * z - x * w)
    out[:, 2, 0] = 2 * (x * z - y * w)
    out[:, 2, 1] = 2 * (y * z + x * w)
    out[:, 2, 2] = 1 - 2 * (x * x + y * y)
    return out


def preintegrate_fast_np(gyro, accel, dts, mask, gyro_bias=None, accel_bias=None):
    """Vectorized host twin of :func:`preintegrate` — full increments.

    Same math as :func:`preintegrate_np` (delta_r AND delta_v/delta_p) at
    :func:`gyro_delta_r_np` cost: the axis-angle -> quaternion map, the
    world-frame accel rotation and the velocity/position accumulation are
    all vectorized over the window; only the inherently sequential
    quaternion Hamilton fold runs per sample, on plain floats. Feeds the
    engine's full-IMU pose prediction, which runs every tick on the host
    (a device dispatch costs a host–device round trip).
    """
    import numpy as np

    from thor_slam_tpu import geometry

    g = np.asarray(gyro, np.float64).reshape(-1, 3)
    a = np.asarray(accel, np.float64).reshape(-1, 3)
    m = np.asarray(mask, np.float64)
    d = np.asarray(dts, np.float64) * m
    if gyro_bias is not None:
        g = g - np.asarray(gyro_bias, np.float64)
    if accel_bias is not None:
        a = a - np.asarray(accel_bias, np.float64)
    n = len(d)
    phi = g * d[:, None]
    angles = np.sqrt(np.einsum("ij,ij->i", phi, phi))
    half = 0.5 * angles
    safe = np.where(angles > 0.0, angles, 1.0)
    k = np.where(angles > 0.0, np.sin(half) / safe, 0.5)  # -> 0.5 as angle -> 0
    qs = np.concatenate([phi * k[:, None], np.cos(half)[:, None]], 1)
    # Cumulative orientations: cum[i] = R(b0 -> frame BEFORE sample i).
    cum = np.empty((n + 1, 4))
    cum[0] = (0.0, 0.0, 0.0, 1.0)
    x, y, z, w = 0.0, 0.0, 0.0, 1.0
    for i, (qx, qy, qz, qw) in enumerate(qs.tolist()):  # q <- q * q_i
        x, y, z, w = (
            w * qx + x * qw + y * qz - z * qy,
            w * qy - x * qz + y * qw + z * qx,
            w * qz + x * qy - y * qx + z * qw,
            w * qw - x * qx - y * qy - z * qz,
        )
        cum[i + 1] = (x, y, z, w)
    r_before = _quats_to_matrices(cum[:-1])
    acc0 = np.einsum("nij,nj->ni", r_before, a) * (d[:, None] > 0.0)
    dv = acc0 * d[:, None]
    v_before = np.concatenate([np.zeros((1, 3)), np.cumsum(dv, 0)[:-1]], 0)
    delta_p = np.sum(v_before * d[:, None] + 0.5 * acc0 * d[:, None] ** 2, 0)
    return Preintegrated(
        delta_r=geometry.quat_to_matrix(cum[-1]),
        delta_v=dv.sum(0),
        delta_p=delta_p,
        dt=float(d.sum()),
        count=int(m.sum()),
    )


def gyro_delta_r_np(gyro, dts, mask, gyro_bias=None):
    """Rotation-only preintegration on the host: vectorized + scalar fold.

    The per-tick pose *prediction* consumes only ``delta_r``
    (translation stays constant-velocity — see
    ``TpuSlamEngine._imu_pose_prediction``), and at pipeline depth d the
    window re-integrates ~d+1 ticks of samples every tick. The generic
    :func:`preintegrate_np` loop costs ~0.1 ms of numpy overhead per
    SAMPLE (measured ~10 ms/tick at depth 6); here the axis-angle ->
    quaternion map is vectorized over the window and only the inherently
    sequential Hamilton fold runs per sample, on plain floats.

    Matches ``preintegrate_np``'s delta_r to f64 round-off (same
    right-composition order r <- r @ R(q_i)).
    """
    import numpy as np

    from thor_slam_tpu import geometry

    g = np.asarray(gyro, np.float64).reshape(-1, 3)
    d = np.asarray(dts, np.float64) * np.asarray(mask, np.float64)
    if gyro_bias is not None:
        g = g - np.asarray(gyro_bias, np.float64)
    phi = g * d[:, None]
    angles = np.sqrt(np.einsum("ij,ij->i", phi, phi))
    sel = angles > 0.0
    if not np.any(sel):
        return np.eye(3)
    half = 0.5 * angles[sel]
    k = np.sin(half) / angles[sel]
    qs = np.concatenate([phi[sel] * k[:, None], np.cos(half)[:, None]], 1)
    x, y, z, w = 0.0, 0.0, 0.0, 1.0
    for qx, qy, qz, qw in qs.tolist():  # Hamilton fold: q <- q * q_i
        x, y, z, w = (
            w * qx + x * qw + y * qz - z * qy,
            w * qy - x * qz + y * qw + z * qx,
            w * qz + x * qy - y * qx + z * qw,
            w * qw - x * qx - y * qy - z * qz,
        )
    return geometry.quat_to_matrix(np.array([x, y, z, w]))


def pack_imu_window(
    samples_ts: list[float] | jnp.ndarray,
    gyros,
    accels,
    t_start: float,
    t_end: float,
    capacity: int,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Host-side: pack raw samples in (t_start, t_end] into fixed arrays.

    Returns (gyro (cap,3), accel (cap,3), dts (cap,), mask (cap,)) numpy-
    compatible arrays ready for :func:`preintegrate`.
    """
    import numpy as np

    ts = np.asarray(samples_ts, dtype=np.float64)
    gy = np.asarray(gyros, dtype=np.float32).reshape(-1, 3)
    ac = np.asarray(accels, dtype=np.float32).reshape(-1, 3)
    sel = (ts > t_start) & (ts <= t_end)
    ts_s, gy_s, ac_s = ts[sel], gy[sel], ac[sel]
    n = min(len(ts_s), capacity)

    g = np.zeros((capacity, 3), np.float32)
    a = np.zeros((capacity, 3), np.float32)
    d = np.zeros(capacity, np.float32)
    m = np.zeros(capacity, np.float32)
    if n:
        g[:n] = gy_s[-n:]
        a[:n] = ac_s[-n:]
        tsel = ts_s[-n:]
        prev = np.concatenate([[t_start], tsel[:-1]])
        d[:n] = (tsel - prev).astype(np.float32)
        m[:n] = 1.0
    return g, a, d, m
