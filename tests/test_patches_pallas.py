"""Patch extraction by XLA gather vs numpy slicing (KLT windows, BRIEF)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from thor_slam_tpu.ops import brief, klt
from thor_slam_tpu.ops.image import extract_patches, extract_patches_rig


def numpy_patches(imgs: np.ndarray, cams: np.ndarray, centers: np.ndarray, size: int) -> np.ndarray:
    """Slice each patch, its center clipped so the patch lies inside."""
    _, h, w = imgs.shape
    r = size // 2
    out = []
    for c, (x, y) in zip(cams, centers):
        x = min(max(x, r), w - r - 1)
        y = min(max(y, r), h - r - 1)
        out.append(imgs[c, y - r : y + r + 1, x - r : x + r + 1])
    return np.stack(out)


class TestPatchGather:
    def test_matches_mxu_reference(self):
        # KLT window geometry (radius 4 + search 4 + 1 -> 19x19), centers
        # on every border so clipping is exercised.
        rng = np.random.default_rng(5)
        c, h, w, n, wr = 2, 48, 96, 12, 9
        imgs = rng.uniform(0, 1, (c, h, w)).astype(np.float32)
        cams = np.repeat(np.arange(c, dtype=np.int32), n)
        centers = rng.integers(0, [w, h], size=(c * n, 2)).astype(np.int32)
        centers[:4] = [[0, 0], [w - 1, h - 1], [3, h - 2], [w - 2, 5]]
        win, ctr = klt._extract_windows(jnp.asarray(imgs), jnp.asarray(cams), jnp.asarray(centers), wr)
        want = numpy_patches(imgs, cams, centers, 2 * wr + 1)
        np.testing.assert_array_equal(np.asarray(win), want)
        np.testing.assert_array_equal(
            np.asarray(ctr), np.clip(centers, wr, [w - wr - 1, h - wr - 1])
        )

    def test_brief_patch_size(self):
        # BRIEF's 37px patches on a 720p-wide image, keypoints mid + border.
        rng = np.random.default_rng(9)
        h, w, s = 64, 1280, brief.PATCH_SIZE
        img = rng.uniform(0, 1, (h, w)).astype(np.float32)
        xs = np.array([18, 30, 640, 1222, 1261, 5, 1275, 700], np.int32)
        ys = np.array([18, 31, 32, 40, 45, 2, 62, 33], np.int32)
        centers = np.stack([xs, ys], -1)
        got = np.asarray(extract_patches(jnp.asarray(img), jnp.asarray(centers), s))
        want = numpy_patches(img[None], np.zeros(len(xs), np.int32), centers, s)
        np.testing.assert_array_equal(got, want)

    def test_supports_gating(self):
        # Patch i comes from camera cams[i] in any order — the rig gather
        # has no camera-major layout requirement.
        rng = np.random.default_rng(3)
        imgs = rng.uniform(0, 1, (3, 40, 72)).astype(np.float32)
        cams = rng.integers(0, 3, 20).astype(np.int32)
        centers = rng.integers(0, [72, 40], size=(20, 2)).astype(np.int32)
        got = extract_patches_rig(jnp.asarray(imgs), jnp.asarray(cams), jnp.asarray(centers), 7)
        np.testing.assert_array_equal(np.asarray(got), numpy_patches(imgs, cams, centers, 7))

    def test_batched_descriptors_match_single(self):
        rng = np.random.default_rng(13)
        imgs = jnp.asarray(rng.uniform(0, 1, (2, 96, 160)).astype(np.float32))
        xy = jnp.asarray(rng.uniform(20, 80, (2, 16, 2)).astype(np.float32))
        valid = jnp.ones((2, 16), bool)
        batched = brief.compute_descriptors_batched(imgs, xy, valid, oriented=False)
        for c in range(2):
            single = brief.compute_descriptors(imgs[c], xy[c], valid[c], oriented=False)
            np.testing.assert_array_equal(np.asarray(batched.bits[c]), np.asarray(single.bits))
