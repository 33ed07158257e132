"""Dense stereo depth: census + cost volume + semi-global matching (SGM).

Replaces the OAK camera's on-ASIC StereoDepth block (reference
luxonis.py:513-536: HIGH_DETAIL preset, left-right check, subpixel) — this
is the producer of the RGB-D stream nvblox consumes (reference
run_pipeline.py:166-292).

Design:

* census transform and the XOR-popcount cost volume are dense elementwise
  work;
* path aggregation is the exact recurrence, sequential along each path: on
  a CUDA GPU one Pallas-Triton kernel streams the volume for all paths
  (:mod:`thor_slam_tpu.ops.sgm_triton`); elsewhere it runs as `lax.scan`
  with the whole cross-section (rows x disparities) updated per step;
* left-right consistency reuses the same aggregated volume re-indexed for
  the right view (no second aggregation);
* subpixel refinement is a parabola fit on the aggregated costs.

Everything is fixed-shape; invalid pixels carry disparity 0 and a False
mask bit.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from thor_slam_tpu.ops import sgm_triton
from thor_slam_tpu.ops.match import popcount_u32

# Python scalar, NOT jnp.float32 (see ops/match.py).
_BIG = 1e9


def census_transform(image: jnp.ndarray, window: int = 5) -> jnp.ndarray:
    """Census transform: each pixel -> bitstring of (neighbor < center).

    Args:
        image: (H, W) float32.
        window: Odd window side; window*window - 1 must be <= 32.

    Returns:
        (H, W) uint32 census codes (border uses edge-replicated neighbors).
    """
    r = window // 2
    assert window * window - 1 <= 32, "census window too large for uint32"
    h, w = image.shape
    padded = jnp.pad(image, r, mode="edge")
    code = jnp.zeros((h, w), dtype=jnp.uint32)
    bit = 0
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue
            neighbor = padded[r + dy : r + dy + h, r + dx : r + dx + w]
            code = code | (neighbor < image).astype(jnp.uint32) << jnp.uint32(bit)
            bit += 1
    return code


def census_cost_volume(census_l: jnp.ndarray, census_r: jnp.ndarray, num_disparities: int) -> jnp.ndarray:
    """(D, H, W) float32 Hamming costs; cost[d, y, x] = ham(L[y,x], R[y,x-d]).

    Out-of-frame comparisons (x < d) get the worst-case cost so they never
    win, but remain finite for SGM smoothing.
    """
    h, w = census_l.shape
    costs = []
    max_cost = jnp.float32(32.0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    for d in range(num_disparities):
        shifted = jnp.pad(census_r, ((0, 0), (d, 0)), mode="edge")[:, :w]
        c = popcount_u32(census_l ^ shifted).astype(jnp.float32)
        costs.append(jnp.where(xs >= d, c, max_cost))
    return jnp.stack(costs)


def _scan_path(seq: jnp.ndarray, p1: float, p2: float) -> jnp.ndarray:
    """Exact SGM recurrence along axis 0 of a step-major (S, D, X) volume.

    One `lax.scan` step per pixel along the path, the whole cross-section
    updated per step; output in the volume's dtype (exact for bf16 volumes
    with integral penalties, see :func:`sgm_disparity`).
    """

    def step(prev, c):
        prev_min = jnp.min(prev, axis=0, keepdims=True)
        big = jnp.full_like(prev[:1], _BIG)
        up = jnp.concatenate([prev[1:], big], axis=0)
        down = jnp.concatenate([big, prev[:-1]], axis=0)
        best = jnp.minimum(jnp.minimum(prev, jnp.minimum(up, down) + p1), prev_min + p2)
        l = c.astype(jnp.float32) + (best - prev_min)
        return l, l.astype(seq.dtype)

    # A UNIFORM start makes the first step exact: best - min == 0.
    _, out = jax.lax.scan(step, jnp.zeros(seq.shape[1:], jnp.float32), seq)
    return out


def sgm_aggregate_xla(cost_dhw: jnp.ndarray, p1: float, p2: float, num_paths: int = 4) -> jnp.ndarray:
    """Plain-XLA exact path aggregation: the reference for the GPU kernel
    (:func:`thor_slam_tpu.ops.sgm_triton.sgm_aggregate`) and the path on
    every other platform. Returns the (D, H, W) float32 sum over paths."""

    def pair(seq):  # forward + reverse along axis 0, summed in f32
        fwd = _scan_path(seq, p1, p2).astype(jnp.float32)
        return fwd + _scan_path(seq[::-1], p1, p2)[::-1].astype(jnp.float32)

    agg = pair(cost_dhw.transpose(2, 0, 1)).transpose(1, 2, 0)
    if num_paths >= 4:
        agg = agg + pair(cost_dhw.transpose(1, 0, 2)).transpose(1, 0, 2)
    return agg


def sgm_aggregate(cost_dhw: jnp.ndarray, p1: float, p2: float, num_paths: int = 4) -> jnp.ndarray:
    """Exact SGM path aggregation, chosen by the platform it compiles for:
    the Pallas-Triton streaming kernel on CUDA GPUs, plain XLA elsewhere.
    Both are bit-identical for bf16 volumes with integral penalties."""
    return jax.lax.platform_dependent(
        cost_dhw,
        cuda=partial(sgm_triton.sgm_aggregate, p1=p1, p2=p2, num_paths=num_paths),
        default=partial(sgm_aggregate_xla, p1=p1, p2=p2, num_paths=num_paths),
    )


def winner_lr(agg: jnp.ndarray, num_disparities: int) -> tuple[jnp.ndarray, ...]:
    """Disparity winners + left-right-check data from a (D, H, W) volume.

    Returns (d_best i32, c0, c_minus, c_plus, second, d_r_at i32), all
    (H, W): the winning disparity, the aggregated cost at it and at its
    +/-1 neighbours (clipped into range), the best cost outside +/-1 of the
    winner, and the right view's winning disparity at each left pixel's
    match.
    """
    _, h, w = agg.shape
    d_best = jnp.argmin(agg, axis=0)  # (H, W)
    d_idx = jax.lax.broadcasted_iota(jnp.int32, agg.shape, 0)

    def at_disp(d):
        """agg[d[y, x], y, x], d clipped into range (one gather)."""
        dc = jnp.clip(d, 0, num_disparities - 1)
        return jnp.take_along_axis(agg, dc[None], axis=0)[0]

    c0 = at_disp(d_best)
    cm = at_disp(d_best - 1)
    cp = at_disp(d_best + 1)

    # Uniqueness: best must beat the second-best (outside +/-1) clearly.
    masked = jnp.where(jnp.abs(d_idx - d_best[None]) <= 1, _BIG, agg)
    second = jnp.min(masked, axis=0)

    # Left-right check from the same volume: cost_R[d, y, x] =
    # cost_L[d, y, x + d] (_BIG past the right edge), then the right-view
    # winner read back at each left pixel's match x - d_L (0 left of the
    # image; sgm_disparity's in_range invalidates those pixels anyway).
    x_r = jax.lax.broadcasted_iota(jnp.int32, agg.shape, 2) + d_idx
    agg_r = jnp.where(x_r < w, jnp.take_along_axis(agg, jnp.minimum(x_r, w - 1), axis=2), _BIG)
    d_best_r = jnp.argmin(agg_r, axis=0)  # (H, W) right-image disparities
    x_m = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1) - d_best
    d_r_at = jnp.where(x_m >= 0, jnp.take_along_axis(d_best_r, jnp.maximum(x_m, 0), axis=1), 0)
    return d_best, c0, cm, cp, second, d_r_at


@partial(jax.jit, static_argnames=("num_disparities", "num_paths", "p1", "p2"))
def sgm_disparity(
    left: jnp.ndarray,
    right: jnp.ndarray,
    num_disparities: int = 64,
    p1: float = 6.0,
    p2: float = 96.0,
    num_paths: int = 4,
    lr_threshold: float = 1.25,
    uniqueness: float = 0.95,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Semi-global matching disparity for a rectified pair.

    Args:
        left: (H, W) float32 rectified left image in [0, 1].
        right: (H, W) float32 rectified right image.
        num_disparities: Disparity search range D (static).
        p1: SGM small-change penalty (census-cost units).
        p2: SGM discontinuity penalty.
        num_paths: 2 (horizontal) or 4 (+vertical) aggregation directions.
        lr_threshold: Max |d_L(x) - d_R(x - d_L)| for the consistency check.
        uniqueness: Reject if best cost > uniqueness * second-best.

    Returns:
        (disparity, valid): (H, W) float32 subpixel disparities (0 where
        invalid) and the (H, W) bool validity mask.
    """
    cl = census_transform(left)
    cr = census_transform(right)
    cost = census_cost_volume(cl, cr, num_disparities)  # (D, H, W)

    # Path aggregation runs in bfloat16: census costs are integers <= 24 and
    # the per-path running cost is bounded by max(cost) + p2 (~120), well
    # inside bf16's exact-integer range (256) — so for integral penalties the
    # bf16 scans are EXACT, at half the memory traffic of f32. Only the
    # 4-direction sum can exceed 256, so directions accumulate in f32.
    # Exactness needs integral penalties and the running-cost bound inside
    # 256; otherwise (custom penalties) stay in f32 — p1/p2 are trace-time
    # constants, so this branch costs nothing.
    exact_in_bf16 = p1 == int(p1) and p2 == int(p2) and 24 + p2 < 250
    cost16 = cost.astype(jnp.bfloat16) if exact_in_bf16 else cost

    agg = sgm_aggregate(cost16, p1, p2, num_paths)

    d_best, c0, cm, cp, second, d_r_at = winner_lr(agg, num_disparities)
    h, w = left.shape

    # Subpixel parabola: offset = (cm - cp) / (2*(cm - 2c0 + cp)).
    denom = cm - 2.0 * c0 + cp
    offset = jnp.where(jnp.abs(denom) > 1e-6, 0.5 * (cm - cp) / jnp.maximum(denom, 1e-6), 0.0)
    offset = jnp.clip(offset, -0.5, 0.5)
    disp = d_best.astype(jnp.float32) + jnp.where(
        (d_best > 0) & (d_best < num_disparities - 1), offset, 0.0
    )

    unique_ok = c0 <= uniqueness * second
    lr_ok = jnp.abs(d_best - d_r_at) <= lr_threshold
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    in_range = xs >= d_best  # matched pixel inside the right image
    valid = unique_ok & lr_ok & in_range & (d_best > 0)
    return jnp.where(valid, disp, 0.0), valid


def refine_disparity_photometric(
    left: jnp.ndarray,
    right: jnp.ndarray,
    xy_left: jnp.ndarray,
    disparity: jnp.ndarray,
    valid: jnp.ndarray,
    patch_radius: int = 3,
) -> jnp.ndarray:
    """Subpixel disparity via parabola on patch SAD along the epipolar line.

    For each keypoint, compares the left patch against right patches at
    integer disparities d-1, d, d+1 and fits a parabola — lifting
    feature-match disparities (integer-ish) to ~0.1 px precision.

    Args:
        left: (H, W) rectified left image.
        right: (H, W) rectified right image.
        xy_left: (N, 2) left keypoint positions.
        disparity: (N,) coarse disparities.
        valid: (N,) mask.

    Returns:
        (N,) refined disparities (coarse value kept where refinement is
        ill-conditioned or the slot is invalid).
    """
    from thor_slam_tpu.ops.image import extract_patches

    h, w = left.shape
    r = patch_radius
    x0 = jnp.clip(jnp.round(xy_left[:, 0]).astype(jnp.int32), r + 1, w - r - 2)
    y0 = jnp.clip(jnp.round(xy_left[:, 1]).astype(jnp.int32), r, h - r - 1)
    d0 = jnp.round(disparity).astype(jnp.int32)

    lpatch = extract_patches(left, jnp.stack([x0, y0], -1), 2 * r + 1)

    def sad_at(offset):
        xr = jnp.clip(x0 - d0 + offset, r, w - r - 1)
        rp = extract_patches(right, jnp.stack([xr, y0], -1), 2 * r + 1)
        return jnp.sum(jnp.abs(lpatch - rp), axis=(1, 2))

    s_m = sad_at(-1)  # disparity d0 + 1 (right sample shifted left)
    s_0 = sad_at(0)
    s_p = sad_at(1)  # disparity d0 - 1
    denom = s_m - 2.0 * s_0 + s_p
    # Minimum of the parabola through (d0+1, s_m), (d0, s_0), (d0-1, s_p):
    # offset in +disparity direction = 0.5 * (s_p - s_m) / denom.
    off = jnp.where(jnp.abs(denom) > 1e-9, 0.5 * (s_p - s_m) / jnp.where(jnp.abs(denom) > 1e-9, denom, 1.0), 0.0)
    off = jnp.clip(off, -1.0, 1.0)
    refined = d0.astype(jnp.float32) + off
    ok = valid & (s_0 <= s_m) & (s_0 <= s_p)
    return jnp.where(ok, refined, disparity)


def disparity_to_depth(disparity: jnp.ndarray, valid: jnp.ndarray, fx: float, baseline_m: float) -> jnp.ndarray:
    """Depth map (meters) from disparity; invalid pixels get 0."""
    z = fx * baseline_m / jnp.maximum(disparity, 1e-6)
    return jnp.where(valid, z, 0.0)


def depth_to_millimeters_u16(depth_m: jnp.ndarray) -> jnp.ndarray:
    """Depth (m) -> 16UC1 millimeters, the nvblox feed encoding
    (reference run_pipeline.py:247-252)."""
    return jnp.clip(jnp.round(depth_m * 1000.0), 0.0, 65535.0).astype(jnp.uint16)
