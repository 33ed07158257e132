"""Device-side camera calibration math: distort/undistort/rectify coordinates.

The tracking architecture rectifies *coordinates, not images*:
full-frame remapping is a multi-megapixel gather per camera per tick,
while the same geometry applied to 512 keypoints is a few thousand FLOPs. Detection
and KLT run on raw frames; stereo gating, triangulation, and PnP
observations use these per-point transforms.

jnp mirror of the NumPy model in :mod:`thor_slam_tpu.ops.rectify`
(plumb-bob k1,k2,p1,p2,k3 — reference distortion-model selection,
isaac_ros.py:372-383).
"""

from __future__ import annotations

import jax.numpy as jnp


def distort_normalized(pts: jnp.ndarray, coeffs: jnp.ndarray) -> jnp.ndarray:
    """Apply plumb-bob distortion to normalized points (..., 2)."""
    k1, k2, p1, p2, k3 = coeffs[0], coeffs[1], coeffs[2], coeffs[3], coeffs[4]
    x, y = pts[..., 0], pts[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return jnp.stack([xd, yd], axis=-1)


def undistort_normalized(pts: jnp.ndarray, coeffs: jnp.ndarray, iters: int = 6) -> jnp.ndarray:
    """Invert plumb-bob distortion by fixed-point iteration (..., 2)."""
    k1, k2, p1, p2, k3 = coeffs[0], coeffs[1], coeffs[2], coeffs[3], coeffs[4]
    xd, yd = pts[..., 0], pts[..., 1]
    x, y = xd, yd
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return jnp.stack([x, y], axis=-1)


def raw_pixels_to_rect(
    xy_raw: jnp.ndarray,
    k_raw: jnp.ndarray,
    dist: jnp.ndarray,
    rect_rot: jnp.ndarray,
    k_rect: jnp.ndarray,
) -> jnp.ndarray:
    """Raw (distorted) pixel coords -> rectified pixel coords (N, 2).

    Args:
        xy_raw: (N, 2) raw pixels.
        k_raw: (4,) raw intrinsics (fx, fy, cx, cy).
        dist: (5,) plumb-bob coefficients.
        rect_rot: (3, 3) rotation old-cam -> rectified-cam.
        k_rect: (3,) rectified intrinsics (f, cx, cy) with fx == fy.
    """
    xn = jnp.stack(
        [(xy_raw[..., 0] - k_raw[2]) / k_raw[0], (xy_raw[..., 1] - k_raw[3]) / k_raw[1]],
        axis=-1,
    )
    xu = undistort_normalized(xn, dist)
    rays = jnp.concatenate([xu, jnp.ones_like(xu[..., :1])], axis=-1)  # (N, 3)
    r = rays @ rect_rot.T
    z = jnp.maximum(r[..., 2], 1e-6)
    return jnp.stack(
        [k_rect[0] * r[..., 0] / z + k_rect[1], k_rect[0] * r[..., 1] / z + k_rect[2]],
        axis=-1,
    )


def raw_pixels_to_normalized(
    xy_raw: jnp.ndarray, k_raw: jnp.ndarray, dist: jnp.ndarray
) -> jnp.ndarray:
    """Raw pixel coords -> undistorted normalized coords in the raw cam frame."""
    xn = jnp.stack(
        [(xy_raw[..., 0] - k_raw[2]) / k_raw[0], (xy_raw[..., 1] - k_raw[3]) / k_raw[1]],
        axis=-1,
    )
    return undistort_normalized(xn, dist)


def cam_points_to_raw_pixels(
    p_cam: jnp.ndarray, k_raw: jnp.ndarray, dist: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Camera-frame 3D points -> distorted raw pixels; also returns z > 0 mask."""
    z = jnp.maximum(p_cam[..., 2], 1e-6)
    xn = jnp.stack([p_cam[..., 0] / z, p_cam[..., 1] / z], axis=-1)
    xd = distort_normalized(xn, dist)
    uv = jnp.stack(
        [k_raw[0] * xd[..., 0] + k_raw[2], k_raw[1] * xd[..., 1] + k_raw[3]], axis=-1
    )
    return uv, p_cam[..., 2] > 1e-3
