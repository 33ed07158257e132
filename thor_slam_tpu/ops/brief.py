"""Oriented BRIEF (ORB-style) binary descriptors, batched over keypoints.

Replaces cuVSLAM's feature description (closed CUDA). Design: one gather
extracts a patch per keypoint, then everything — intensity-
centroid orientation, rotated test-pair sampling, bit packing — runs as
dense batched arithmetic over the (N, P, P) patch tensor. Descriptors are
256 bits packed into 8 uint32 words (layout consumed by
:mod:`thor_slam_tpu.ops.match`).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from thor_slam_tpu.ops import image as image_ops

PATCH_RADIUS = 18  # patch half-size; fits rotated +/-13 px test points
PATCH_SIZE = 2 * PATCH_RADIUS + 1
PAIR_RADIUS = 13.0
NUM_BITS = 256
NUM_WORDS = NUM_BITS // 32


def _make_test_pairs(seed: int = 42) -> np.ndarray:
    """Deterministic BRIEF test pattern: (256, 4) = (x1, y1, x2, y2).

    Gaussian-distributed around the patch center (sigma = r/2.5), clipped to
    the pair radius — the classic BRIEF-32 construction.
    """
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, PAIR_RADIUS / 2.5, size=(NUM_BITS, 4))
    return np.clip(pts, -PAIR_RADIUS, PAIR_RADIUS)


TEST_PAIRS = _make_test_pairs()


def _upright_sampling_matrix() -> np.ndarray:
    """Constant (P*P, 2*256) bilinear sampling matrix for the upright pattern.

    For unrotated BRIEF the sample positions are fixed fractional offsets, so
    sampling all 512 test points from a patch is ``patch_flat @ S`` — one
    matmul instead of 512 gathers per keypoint.
    """
    s = np.zeros((PATCH_SIZE * PATCH_SIZE, 2 * NUM_BITS), dtype=np.float32)
    pts = np.concatenate([TEST_PAIRS[:, :2], TEST_PAIRS[:, 2:]], axis=0)  # (512, 2)
    for col, (px, py) in enumerate(pts):
        x = np.clip(px + PATCH_RADIUS, 0, PATCH_SIZE - 1.001)
        y = np.clip(py + PATCH_RADIUS, 0, PATCH_SIZE - 1.001)
        x0, y0 = int(np.floor(x)), int(np.floor(y))
        fx, fy = x - x0, y - y0
        s[y0 * PATCH_SIZE + x0, col] += (1 - fx) * (1 - fy)
        s[y0 * PATCH_SIZE + x0 + 1, col] += fx * (1 - fy)
        s[(y0 + 1) * PATCH_SIZE + x0, col] += (1 - fx) * fy
        s[(y0 + 1) * PATCH_SIZE + x0 + 1, col] += fx * fy
    return s


UPRIGHT_SAMPLING = _upright_sampling_matrix()

# Disk mask + coordinate grids for the intensity-centroid orientation.
_yy, _xx = np.mgrid[-PATCH_RADIUS : PATCH_RADIUS + 1, -PATCH_RADIUS : PATCH_RADIUS + 1]
_DISK = ((_xx**2 + _yy**2) <= PATCH_RADIUS**2).astype(np.float32)
_MOMENT_X = (_xx * _DISK).astype(np.float32)
_MOMENT_Y = (_yy * _DISK).astype(np.float32)


class Descriptors(NamedTuple):
    """Packed binary descriptors for a fixed-capacity keypoint set.

    Attributes:
        bits: (N, 8) uint32 — 256 packed bits per keypoint.
        angle: (N,) float32 orientation (radians).
        valid: (N,) bool (inherited from the keypoints).
    """

    bits: jnp.ndarray
    angle: jnp.ndarray
    valid: jnp.ndarray


def extract_patches(image: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """(N, P, P) patches centered at (rounded) keypoint positions.

    Coordinates are clipped so border keypoints yield in-bounds patches.
    """
    centers = jnp.round(xy).astype(jnp.int32)
    return image_ops.extract_patches(image, centers, PATCH_SIZE)


def patch_orientation(patches: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid angle per patch: atan2(m01, m10) over a disk."""
    m10 = jnp.sum(patches * jnp.asarray(_MOMENT_X), axis=(1, 2))
    m01 = jnp.sum(patches * jnp.asarray(_MOMENT_Y), axis=(1, 2))
    return jnp.arctan2(m01, m10)


def _bilinear_patch_sample(patches: jnp.ndarray, px: jnp.ndarray, py: jnp.ndarray) -> jnp.ndarray:
    """Sample (N, P, P) patches at per-keypoint fractional offsets.

    px, py: (N, K) offsets relative to the patch center.
    Returns (N, K) samples.
    """
    n = patches.shape[0]
    x = jnp.clip(px + PATCH_RADIUS, 0.0, PATCH_SIZE - 1.001)
    y = jnp.clip(py + PATCH_RADIUS, 0.0, PATCH_SIZE - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    flat = patches.reshape(n, -1)

    def take(yy, xx):
        return jnp.take_along_axis(flat, yy * PATCH_SIZE + xx, axis=1)

    v00 = take(y0, x0)
    v01 = take(y0, x0 + 1)
    v10 = take(y0 + 1, x0)
    v11 = take(y0 + 1, x0 + 1)
    return (v00 * (1 - fx) + v01 * fx) * (1 - fy) + (v10 * (1 - fx) + v11 * fx) * fy


def _describe_patches(patches: jnp.ndarray, valid: jnp.ndarray, oriented: bool) -> Descriptors:
    """Descriptor computation from pre-extracted (N, P, P) patches."""
    n = patches.shape[0]

    if oriented:
        angle = patch_orientation(patches)  # (N,)
        ca, sa = jnp.cos(angle), jnp.sin(angle)
        pairs = jnp.asarray(TEST_PAIRS, dtype=jnp.float32)  # (256, 4)
        x1, y1, x2, y2 = pairs[:, 0], pairs[:, 1], pairs[:, 2], pairs[:, 3]

        # Rotate the test pattern by each keypoint's orientation (steering).
        def rot(px, py):
            rx = ca[:, None] * px[None, :] - sa[:, None] * py[None, :]
            ry = sa[:, None] * px[None, :] + ca[:, None] * py[None, :]
            return rx, ry  # (N, 256)

        r1x, r1y = rot(x1, y1)
        r2x, r2y = rot(x2, y2)
        i1 = _bilinear_patch_sample(patches, r1x, r1y)
        i2 = _bilinear_patch_sample(patches, r2x, r2y)
    else:
        # Upright pattern: all 512 sample points via one constant matmul.
        angle = jnp.zeros(n, dtype=jnp.float32)
        samples = jnp.dot(
            patches.reshape(n, -1),
            jnp.asarray(UPRIGHT_SAMPLING),
            preferred_element_type=jnp.float32,
        )  # (N, 512)
        i1, i2 = samples[:, :NUM_BITS], samples[:, NUM_BITS:]
    bits = (i1 < i2).astype(jnp.uint32)  # (N, 256)

    weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, None, :]
    packed = jnp.sum(bits.reshape(-1, NUM_WORDS, 32) * weights, axis=-1, dtype=jnp.uint32)
    return Descriptors(bits=packed, angle=angle, valid=valid)


@partial(jax.jit, static_argnames=("oriented",))
def compute_descriptors(
    image: jnp.ndarray, xy: jnp.ndarray, valid: jnp.ndarray, oriented: bool = True
) -> Descriptors:
    """BRIEF-256 for keypoints ``xy`` on a (pre-smoothed) image.

    Args:
        image: (H, W) float32, ideally Gaussian-smoothed (sigma ~ 2).
        xy: (N, 2) float32 keypoint positions.
        valid: (N,) bool slot mask.
        oriented: Steer the test pattern by the intensity-centroid angle
            (rotation invariance). Upright BRIEF (False) is more precise and
            is the right choice for stereo VO where in-plane rotation between
            association candidates is small.

    Returns:
        :class:`Descriptors` with (N, 8) uint32 packed bits.
    """
    patches = extract_patches(image, xy)  # (N, P, P)
    return _describe_patches(patches, valid, oriented)


@partial(jax.jit, static_argnames=("oriented",))
def compute_descriptors_batched(
    images: jnp.ndarray, xy: jnp.ndarray, valid: jnp.ndarray, oriented: bool = True
) -> Descriptors:
    """:func:`compute_descriptors` over a (C, H, W) camera batch (the
    tracker's hot entry point)."""
    patches = jax.vmap(extract_patches)(images, xy)
    return jax.vmap(lambda p, v: _describe_patches(p, v, oriented))(patches, valid)
