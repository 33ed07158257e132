"""FAST corner detection with a fixed keypoint budget.

Replaces the feature detection inside cuVSLAM (closed CUDA; reference
launch/thor_visual_slam.launch.py:30-64). Design for XLA:

* segment test evaluated densely for the whole image (16 shifted views,
  no gather), which XLA fuses with the NMS into a few memory-bound passes;
* 3x3 non-max suppression via reduce_window;
* **fixed budget**: scores are partitioned into a grid of cells and the
  top-k per cell then global top-N are taken, so the output shapes are
  static and keypoints stay spatially spread (cuVSLAM-style bucketing).

Variable keypoint counts — the classic irregularity of feature pipelines —
never appear: invalid slots are masked, downstream ops stay dense.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

# FAST-16 Bresenham circle, radius 3, clockwise from 12 o'clock: (dy, dx).
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
ARC_LENGTH = 9  # FAST-9: contiguous arc of 9 of 16


class Keypoints(NamedTuple):
    """A fixed-capacity keypoint set; slots beyond the true count are masked.

    Attributes:
        xy: (N, 2) float32 — (x, y) pixel coordinates.
        score: (N,) float32 corner response (0 for invalid slots).
        valid: (N,) bool slot mask.
    """

    xy: jnp.ndarray
    score: jnp.ndarray
    valid: jnp.ndarray

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]


def fast_score_map(image: jnp.ndarray, threshold: float = 0.06) -> jnp.ndarray:
    """Dense FAST-9 corner response for an (H, W) float image in [0, 1].

    Response is the sum of circle-point excesses beyond the threshold
    (bright and dark branches evaluated symmetrically); zero where the
    contiguous-arc test fails.
    """
    h, w = image.shape
    padded = jnp.pad(image, 3, mode="edge")
    # A list of 16 shifted views, never stacked: every output pixel then
    # depends elementwise on 16 reads of the padded image, which XLA fuses
    # into one pass instead of materializing (16, H, W) intermediates.
    diff = [padded[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] - image for dy, dx in CIRCLE_OFFSETS]

    def has_arc(mask: list) -> jnp.ndarray:
        ext = mask + mask[: ARC_LENGTH - 1]  # wraparound
        hit = None
        for start in range(16):
            run = ext[start]
            for j in range(1, ARC_LENGTH):
                run = run & ext[start + j]
            hit = run if hit is None else hit | run
        return hit

    is_corner = has_arc([d > threshold for d in diff]) | has_arc([d < -threshold for d in diff])
    excess_b = sum(jnp.maximum(d - threshold, 0.0) for d in diff)
    excess_d = sum(jnp.maximum(-d - threshold, 0.0) for d in diff)
    score = jnp.maximum(excess_b, excess_d)
    return jnp.where(is_corner, score, 0.0)


def nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """Keep only strict 3x3 local maxima of a dense score map."""
    local_max = jax.lax.reduce_window(
        score, -jnp.inf, jax.lax.max, (3, 3), (1, 1), "SAME"
    )
    return jnp.where(score >= local_max, score, 0.0)


def _mask_border(score: jnp.ndarray, margin: int) -> jnp.ndarray:
    h, w = score.shape
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    inside = (ys >= margin) & (ys < h - margin) & (xs >= margin) & (xs < w - margin)
    return jnp.where(inside, score, 0.0)


def _select_keypoints(
    raw: jnp.ndarray,
    score: jnp.ndarray,
    max_keypoints: int,
    cell_size: int,
    per_cell: int,
    border_margin: int,
) -> Keypoints:
    """Bucketing + top-N + subpixel selection from dense response maps.

    ``raw`` is the pre-NMS response (for the parabola fits), ``score`` the
    NMS'd one.
    """
    h, w = raw.shape
    score = _mask_border(score, border_margin)

    # Pad to cell multiples, carve into cells, take per-cell top-k.
    gh = -(-h // cell_size)
    gw = -(-w // cell_size)
    padded = jnp.full((gh * cell_size, gw * cell_size), 0.0, dtype=score.dtype)
    padded = padded.at[:h, :w].set(score)
    cells = padded.reshape(gh, cell_size, gw, cell_size).transpose(0, 2, 1, 3)
    cells = cells.reshape(gh * gw, cell_size * cell_size)
    # Per-cell top-k as k rounds of (argmax, mask): identical results to
    # lax.top_k (same tie order: first-lowest-index).
    iota = jnp.arange(cells.shape[1], dtype=jnp.int32)[None, :]
    remaining = cells
    scores_rounds, idx_rounds = [], []
    for _ in range(per_cell):
        i = jnp.argmax(remaining, axis=1).astype(jnp.int32)
        scores_rounds.append(jnp.max(remaining, axis=1))
        idx_rounds.append(i)
        remaining = jnp.where(iota == i[:, None], -1.0, remaining)
    cell_scores = jnp.stack(scores_rounds, axis=1)  # (gh*gw, per_cell)
    cell_idx = jnp.stack(idx_rounds, axis=1)

    # Cell-local flat index -> global (y, x).
    cell_ids = jnp.arange(gh * gw, dtype=jnp.int32)[:, None]
    cy = (cell_ids // gw) * cell_size + cell_idx // cell_size
    cx = (cell_ids % gw) * cell_size + cell_idx % cell_size

    flat_scores = cell_scores.reshape(-1)
    flat_y = cy.reshape(-1)
    flat_x = cx.reshape(-1)

    pool = flat_scores.shape[0]
    k = min(max_keypoints, pool)
    top_scores, top_i = jax.lax.top_k(flat_scores, k)
    if k < max_keypoints:  # small images: pad the candidate pool
        pad = max_keypoints - k
        top_scores = jnp.concatenate([top_scores, jnp.zeros(pad, top_scores.dtype)])
        top_i = jnp.concatenate([top_i, jnp.zeros(pad, top_i.dtype)])
    xi = flat_x[top_i]
    yi = flat_y[top_i]

    # Subpixel refinement: 1D parabola fits on the raw (pre-NMS) response.
    raw_flat = raw.reshape(-1)

    def sample(yy, xx):
        yy = jnp.clip(yy, 0, h - 1)
        xx = jnp.clip(xx, 0, w - 1)
        return raw_flat[yy * w + xx]

    s_c = sample(yi, xi)
    s_l = sample(yi, xi - 1)
    s_r = sample(yi, xi + 1)
    s_u = sample(yi - 1, xi)
    s_d = sample(yi + 1, xi)
    denom_x = s_l - 2.0 * s_c + s_r
    denom_y = s_u - 2.0 * s_c + s_d
    dx = jnp.where(jnp.abs(denom_x) > 1e-9, 0.5 * (s_l - s_r) / jnp.where(jnp.abs(denom_x) > 1e-9, denom_x, 1.0), 0.0)
    dy = jnp.where(jnp.abs(denom_y) > 1e-9, 0.5 * (s_u - s_d) / jnp.where(jnp.abs(denom_y) > 1e-9, denom_y, 1.0), 0.0)
    dx = jnp.clip(dx, -0.5, 0.5)
    dy = jnp.clip(dy, -0.5, 0.5)

    xy = jnp.stack([xi.astype(jnp.float32) + dx, yi.astype(jnp.float32) + dy], axis=-1)
    valid = top_scores > 0.0
    return Keypoints(xy=jnp.where(valid[:, None], xy, 0.0), score=jnp.where(valid, top_scores, 0.0), valid=valid)


@partial(jax.jit, static_argnames=("max_keypoints", "cell_size", "per_cell", "border_margin"))
def detect_keypoints(
    image: jnp.ndarray,
    threshold: float = 0.06,
    max_keypoints: int = 512,
    cell_size: int = 32,
    per_cell: int = 8,
    border_margin: int = 20,
) -> Keypoints:
    """FAST-9 detection -> NMS -> grid bucketing -> global top-N.

    Args:
        image: (H, W) float32 in [0, 1].
        threshold: Intensity contrast threshold (in [0,1] units; 0.06 ~ 15/255).
        max_keypoints: Output capacity N (static).
        cell_size: Bucketing cell side in pixels (static).
        per_cell: Keypoints kept per cell before the global cut (static).
        border_margin: Suppress detections within this many pixels of the
            border (descriptor patches must fit).

    Returns:
        A :class:`Keypoints` of capacity ``max_keypoints``.
    """
    raw = fast_score_map(image, threshold)  # kept for subpixel refinement
    score = nms3x3(raw)
    return _select_keypoints(raw, score, max_keypoints, cell_size, per_cell, border_margin)


@partial(
    jax.jit,
    static_argnames=("max_keypoints", "cell_size", "per_cell", "border_margin"),
)
def detect_keypoints_batched(
    images: jnp.ndarray,
    threshold: float = 0.06,
    max_keypoints: int = 512,
    cell_size: int = 32,
    per_cell: int = 8,
    border_margin: int = 20,
) -> Keypoints:
    """:func:`detect_keypoints` over a (C, H, W) camera batch (the
    tracker's hot entry point)."""
    raw = jax.vmap(lambda im: fast_score_map(im, threshold))(images)
    score = jax.vmap(nms3x3)(raw)
    select = lambda r, s: _select_keypoints(
        r, s, max_keypoints, cell_size, per_cell, border_margin
    )
    return jax.vmap(select)(raw, score)
