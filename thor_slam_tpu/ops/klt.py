"""Pyramidal Lucas-Kanade (KLT) patch tracking — matmul core, one gather.

The temporal-association workhorse of the tracker (the role of cuVSLAM's
patch tracker). Descriptor matching associates globally but is ambiguous in
repetitive scenes; LK refines a *predicted* position to subpixel accuracy by
local photometric alignment and reports a residual that doubles as a
verification score.

Design: per-iteration bilinear gathers are replaced by linear algebra. Per
track and pyramid level we extract one (S x S) window around the initial
estimate, materialize its (2m+2)^2 statically-shifted (P x P) views, and
express bilinear sampling at any fractional offset as ``weights @ views`` —
a batched matvec. Each LK iteration is then pure dense math; only the
one-time window extraction touches a gather.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from thor_slam_tpu.ops.image import extract_patches_rig


class TrackResult(NamedTuple):
    """Result of tracking N points into the current frame.

    Attributes:
        xy: (N, 2) refined positions in the current image.
        residual: (N,) mean absolute photometric error of the final patch.
        valid: (N,) bool — converged, in-bounds, residual below threshold.
    """

    xy: jnp.ndarray
    residual: jnp.ndarray
    valid: jnp.ndarray


def _extract_windows(
    images: jnp.ndarray, cam: jnp.ndarray, centers: jnp.ndarray, wr: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(M, S, S) windows around integer centers from a (C, H, W) stack.

    ``cam`` is the per-window camera index. Returns (windows,
    centers_clipped); the windows are one gather of just the window bytes.
    """
    _, h, w = images.shape
    cx = jnp.clip(centers[:, 0], wr, w - wr - 1)
    cy = jnp.clip(centers[:, 1], wr, h - wr - 1)
    ctr = jnp.stack([cx, cy], axis=-1)
    return extract_patches_rig(images, cam, ctr, 2 * wr + 1), ctr


def _shifted_views(win: jnp.ndarray, radius: int, m: int) -> jnp.ndarray:
    """All integer-shift (P x P) views of (S x S) windows: (N, K*K, P*P).

    View (a, b) is the patch at integer offset (a - m, b - m) from the
    window center, for a, b in [0, 2m+1].

    One im2col op (``conv_general_dilated_patches``) instead of K*K
    explicit slices + concatenate: the unrolled-slice formulation emitted
    K*K = 100 fused slice kernels per LK level, duplicated per pyramid
    level and image, which ballooned the tracker executable and its
    compile time.
    """
    n, s, _ = win.shape
    p = 2 * radius + 1
    k = 2 * m + 2
    # Sliding (p x p) windows of win: (N, p*p, s-p+1, s-p+1), feature dim
    # ordered row-major over the kernel — exactly the flattened patch.
    patches = jax.lax.conv_general_dilated_patches(
        win[:, None, :, :], (p, p), (1, 1), "VALID",
        precision=jax.lax.Precision.HIGHEST,  # exact extraction (no bf16 rounding)
    )
    # The view at shift (a - m, b - m) has top-left (a + 1, b + 1):
    # y0 = (radius + m + 1) + (a - m) - radius = a + 1.
    sl = patches[:, :, 1 : 1 + k, 1 : 1 + k]  # (N, P*P, K, K)
    return sl.reshape(n, p * p, k * k).transpose(0, 2, 1)  # (N, K*K, P*P)


def _interp_weights(d: jnp.ndarray, m: int) -> jnp.ndarray:
    """Bilinear one-hot-lerp weights over the K*K shift grid: (N, K*K).

    d: (N, 2) fractional offsets from the window center, in [-m, m].
    """
    k = 2 * m + 2
    fl = jnp.floor(d)
    fr = d - fl
    base = (fl + m).astype(jnp.int32)  # (N, 2) in [0, 2m]
    j = jnp.arange(k)

    def axis_w(base_a, fr_a):
        return jnp.where(
            j[None, :] == base_a[:, None],
            1.0 - fr_a[:, None],
            jnp.where(j[None, :] == base_a[:, None] + 1, fr_a[:, None], 0.0),
        )

    wx = axis_w(base[:, 0], fr[:, 0])  # (N, K)
    wy = axis_w(base[:, 1], fr[:, 1])
    return (wy[:, :, None] * wx[:, None, :]).reshape(d.shape[0], k * k)


def _sample(views: jnp.ndarray, d: jnp.ndarray, m: int) -> jnp.ndarray:
    """Bilinear patch sample at offsets d via one matvec: (N, P*P)."""
    w2 = _interp_weights(d, m)
    # HIGHEST: reduced-precision matmul operands (bf16, or TF32 on NVIDIA
    # GPUs) quantize image intensities near the 1/255 pixel quantum, and
    # the lost bits surface directly as subpixel tracking noise (bf16
    # operands measured 8x worse trajectory ATE than f32).
    return jnp.einsum(
        "ns,nsp->np", w2, views,
        preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST,
    )


def _lk_level(
    prev: jnp.ndarray,
    cur: jnp.ndarray,
    cam: jnp.ndarray,
    pts_prev: jnp.ndarray,
    pts_cur: jnp.ndarray,
    radius: int,
    iters: int,
    m: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Inverse-compositional LK at one level, flat over all rig tracks.

    ``prev``/``cur`` are (C, h, w) stacks; ``cam`` maps each of the M
    tracks to its camera. Returns (positions, residual).
    """
    wr = radius + m + 1

    c_prev = jnp.round(pts_prev).astype(jnp.int32)
    c_cur = jnp.round(pts_cur).astype(jnp.int32)
    win_p, cp = _extract_windows(prev, cam, c_prev, wr)
    win_c, cc = _extract_windows(cur, cam, c_cur, wr)
    # Force the extracted windows to materialize: without the barrier XLA
    # may fuse the gather (and everything upstream of the track positions)
    # into each of the (2m+2)^2 shifted-view slices, re-executing it ~100x.
    win_p, win_c = jax.lax.optimization_barrier((win_p, win_c))
    # No barrier on the views: views_p has exactly one consumer (the fused
    # template matmul) and views_c two (gradient projection + final
    # residual), so the worst case is re-running the cheap im2col on the
    # small materialized windows — far cheaper than writing + re-reading
    # the (M, K^2, P^2) tensors through HBM. (The barrier above still
    # protects the gather from being re-executed per consumer.)
    views_p = _shifted_views(win_p, radius, m)
    views_c = _shifted_views(win_c, radius, m)
    cp = cp.astype(jnp.float32)
    cc = cc.astype(jnp.float32)

    # Template + gradients at the (sub-pixel) previous position — fixed.
    # All five template samples (t, central differences for gx/gy) ride ONE
    # pass over views_p as a (5, K^2) x (K^2, P^2) matmul per track.
    d_t = jnp.clip(pts_prev - cp, -1.0, 1.0)
    ex = jnp.array([1.0, 0.0])
    ey = jnp.array([0.0, 1.0])
    w5 = jnp.stack(
        [_interp_weights(d_t + o, m) for o in (0.0, ex, -ex, ey, -ey)], axis=1
    )  # (M, 5, K^2)
    tp = jnp.einsum(
        "nks,nsp->nkp", w5, views_p,
        preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST,
    )
    t = tp[:, 0]
    gx = 0.5 * (tp[:, 1] - tp[:, 2])
    gy = 0.5 * (tp[:, 3] - tp[:, 4])

    gxx = jnp.sum(gx * gx, axis=1)
    gxy = jnp.sum(gx * gy, axis=1)
    gyy = jnp.sum(gy * gy, axis=1)
    det = gxx * gyy - gxy * gxy
    inv_ok = det > 1e-8
    det_safe = jnp.where(inv_ok, det, 1.0)

    # The LK update needs only e.gx and e.gy, and sampling is linear:
    #   (w2 @ views_c).gx = w2 @ (views_c @ gx).
    # Projecting views_c onto (gx, gy) ONCE turns every iteration's
    # (M, K^2, P^2) re-read — the tick's dominant HBM traffic — into a
    # (M, K^2) contraction. The full patch is only materialized again for
    # the final residual.
    vproj = jnp.einsum(
        "nsp,nkp->nsk", views_c, jnp.stack([gx, gy], axis=1),
        preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST,
    )  # (M, K^2, 2)
    tgx = jnp.sum(t * gx, axis=1)
    tgy = jnp.sum(t * gy, axis=1)

    def body(_, xy):
        d = jnp.clip(xy - cc, -m * 1.0, m * 1.0)
        w2 = _interp_weights(d, m)
        bx = jnp.sum(w2 * vproj[:, :, 0], axis=1) - tgx
        by = jnp.sum(w2 * vproj[:, :, 1], axis=1) - tgy
        ux = (gyy * bx - gxy * by) / det_safe
        uy = (gxx * by - gxy * bx) / det_safe
        step = jnp.clip(jnp.stack([ux, uy], axis=-1), -radius * 1.0, radius * 1.0)
        xy = xy - step * inv_ok[:, None]
        # Stay inside the window's representable offset range.
        return cc + jnp.clip(xy - cc, -m * 1.0, m * 1.0)

    xy = cc + jnp.clip(pts_cur - cc, -m * 1.0, m * 1.0)
    xy = jax.lax.fori_loop(0, iters, body, xy)
    resid = jnp.mean(jnp.abs(_sample(views_c, jnp.clip(xy - cc, -m * 1.0, m * 1.0), m) - t), axis=1)

    # Window centers get clamped near image borders (common at coarse pyramid
    # levels); a clamped window cannot represent the track — pass the input
    # through unrefined and let finer levels (whose windows fit) handle it.
    clipped = (
        jnp.max(jnp.abs(pts_prev - cp), axis=1) > 1.5
    ) | (jnp.max(jnp.abs(pts_cur - cc), axis=1) > m)
    xy = jnp.where(clipped[:, None], pts_cur, xy)
    resid = jnp.where(clipped, 0.0, resid)
    return xy, resid


@partial(jax.jit, static_argnames=("num_levels", "radius", "iters", "search"))
def track_points_rig(
    prev_pyramid: tuple[jnp.ndarray, ...],
    cur_pyramid: tuple[jnp.ndarray, ...],
    pts_prev: jnp.ndarray,
    pts_init: jnp.ndarray,
    valid: jnp.ndarray,
    num_levels: int = 3,
    radius: int = 4,
    iters: int = 8,
    max_residual: float = 0.08,
    border: int = 4,
    search: int = 4,
) -> TrackResult:
    """Track all rig points from the previous frame into the current one.

    The whole rig is one flat batch of C*N tracks (per-track camera index),
    so the window gather is one operation per level for every camera.

    Args:
        prev_pyramid: Tuple of (C, H/2^l, W/2^l) stacks, level 0 first.
        cur_pyramid: Same structure for the current frame.
        pts_prev: (C, N, 2) template positions in the previous frame.
        pts_init: (C, N, 2) initial guesses in the current frame (e.g. the
            pose-predicted reprojections).
        valid: (C, N) bool input mask.
        num_levels: Pyramid levels to use (static).
        radius: Patch half-size (static).
        iters: LK iterations per level (static).
        max_residual: Mean-absolute-error acceptance gate (intensity units).
        border: Reject tracks closer than this to the image border.
        search: Per-level search half-range m in pixels (static). Total
            capture range ~ search * (2^num_levels - 1) around pts_init.

    Returns:
        A :class:`TrackResult` with (C, N)-shaped fields.
    """
    assert len(prev_pyramid) >= num_levels and len(cur_pyramid) >= num_levels
    c, n = pts_prev.shape[0], pts_prev.shape[1]
    cam = jnp.repeat(jnp.arange(c, dtype=jnp.int32), n)
    pts_prev = pts_prev.reshape(c * n, 2)
    pts_init = pts_init.reshape(c * n, 2)

    scale_top = 2.0 ** (num_levels - 1)
    xy = pts_init / scale_top
    resid = jnp.zeros(c * n)
    for lvl in range(num_levels - 1, -1, -1):
        s = 2.0**lvl
        xy, resid = _lk_level(
            prev_pyramid[lvl], cur_pyramid[lvl], cam, pts_prev / s, xy, radius, iters, search
        )
        if lvl > 0:
            xy = xy * 2.0

    h, w = cur_pyramid[0].shape[1:]
    # The level-0 window must have fit: tracks closer to the border than the
    # window radius were never photometrically verified. (jnp.maximum:
    # ``border`` may arrive as a tracer through the single-camera wrapper.)
    border = jnp.maximum(border, radius + search + 1)
    in_bounds = (
        (xy[:, 0] >= border)
        & (xy[:, 0] < w - border)
        & (xy[:, 1] >= border)
        & (xy[:, 1] < h - border)
    )
    ok = valid.reshape(c * n) & in_bounds & (resid <= max_residual)
    return TrackResult(
        xy=xy.reshape(c, n, 2), residual=resid.reshape(c, n), valid=ok.reshape(c, n)
    )


@partial(jax.jit, static_argnames=("num_levels", "radius", "iters", "search"))
def track_points(
    prev_pyramid: tuple[jnp.ndarray, ...],
    cur_pyramid: tuple[jnp.ndarray, ...],
    pts_prev: jnp.ndarray,
    pts_init: jnp.ndarray,
    valid: jnp.ndarray,
    num_levels: int = 3,
    radius: int = 4,
    iters: int = 8,
    max_residual: float = 0.08,
    border: int = 4,
    search: int = 4,
) -> TrackResult:
    """Single-camera :func:`track_points_rig` (same arguments, (N,)-shaped).

    Args:
        prev_pyramid: Tuple of (H/2^l, W/2^l) images, level 0 first.
        cur_pyramid: Same structure for the current frame.
        pts_prev: (N, 2) template positions in the previous frame.
        pts_init: (N, 2) initial guesses in the current frame.
        valid: (N,) bool input mask.
        num_levels: Pyramid levels to use (static).
        radius: Patch half-size (static).
        iters: LK iterations per level (static).
        max_residual: Mean-absolute-error acceptance gate (intensity units).
        border: Reject tracks closer than this to the image border.
        search: Per-level search half-range m in pixels (static).

    Returns:
        A :class:`TrackResult`.
    """
    out = track_points_rig(
        tuple(lv[None] for lv in prev_pyramid),
        tuple(lv[None] for lv in cur_pyramid),
        pts_prev[None],
        pts_init[None],
        valid[None],
        num_levels=num_levels,
        radius=radius,
        iters=iters,
        max_residual=max_residual,
        border=border,
        search=search,
    )
    return TrackResult(xy=out.xy[0], residual=out.residual[0], valid=out.valid[0])
