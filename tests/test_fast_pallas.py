"""XLA FAST-9 score + NMS vs a straightforward numpy FAST-9 reference."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from thor_slam_tpu.ops import fast


def numpy_fast9(im: np.ndarray, threshold: float) -> tuple[np.ndarray, np.ndarray]:
    """(raw, nms) maps: per-pixel segment test on the 16-point circle, then
    strict-or-equal 3x3 local maxima (pixels outside the image never win)."""
    h, w = im.shape
    p = np.pad(im, 3, mode="edge")
    diff = np.stack([p[3 + dy : 3 + dy + h, 3 + dx : 3 + dx + w] - im for dy, dx in fast.CIRCLE_OFFSETS])
    raw = np.zeros_like(im)
    for y in range(h):
        for x in range(w):
            d = diff[:, y, x]
            corner = False
            for mask in (d > threshold, d < -threshold):
                ring = np.concatenate([mask, mask[: fast.ARC_LENGTH - 1]])
                corner |= any(ring[s : s + fast.ARC_LENGTH].all() for s in range(16))
            if corner:
                raw[y, x] = max(np.maximum(d - threshold, 0).sum(), np.maximum(-d - threshold, 0).sum())
    q = np.pad(raw, 1, constant_values=-np.inf)
    local_max = np.max([q[dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)], axis=0)
    return raw, np.where(raw >= local_max, raw, 0.0)


def _xla(im: np.ndarray, threshold: float) -> tuple[np.ndarray, np.ndarray]:
    raw = fast.fast_score_map(jnp.asarray(im), threshold)
    return np.asarray(raw), np.asarray(fast.nms3x3(raw))


class TestFastPallasEquivalence:
    @pytest.mark.parametrize("shape", [(2, 24, 40), (1, 32, 56)])
    def test_matches_xla_reference(self, shape):
        rng = np.random.default_rng(7)
        imgs = rng.uniform(0.0, 1.0, size=shape).astype(np.float32)
        for im in imgs:
            raw_x, nms_x = _xla(im, 0.06)
            raw_n, nms_n = numpy_fast9(im, 0.06)
            np.testing.assert_allclose(raw_x, raw_n, atol=1e-5)
            np.testing.assert_array_equal(nms_x > 0, nms_n > 0)

    def test_multi_tile_grid(self):
        # A taller image, so every row band the XLA fusion tiles is covered.
        rng = np.random.default_rng(3)
        im = rng.uniform(0.0, 1.0, size=(96, 40)).astype(np.float32)
        raw_x, nms_x = _xla(im, 0.05)
        raw_n, nms_n = numpy_fast9(im, 0.05)
        np.testing.assert_allclose(raw_x, raw_n, atol=1e-5)
        np.testing.assert_array_equal(nms_x > 0, nms_n > 0)

    def test_real_corner_structure(self):
        # Isolated bright squares: their corners carry long dark arcs (a
        # FAST-9 response), unlike checkerboard X-junctions (two 8-arcs).
        # Both implementations must agree on the NMS'd peak set.
        im = np.zeros((48, 64), np.float32)
        for y in range(8, 40, 16):
            for x in range(8, 56, 16):
                im[y : y + 6, x : x + 6] = 1.0
        _, nms_x = _xla(im, 0.06)
        _, nms_n = numpy_fast9(im, 0.06)
        assert (nms_n > 0).sum() > 0
        np.testing.assert_array_equal(nms_x > 0, nms_n > 0)

    def test_detect_batched_matches_single(self):
        # The batched detector must agree with per-image detect.
        rng = np.random.default_rng(11)
        imgs = jnp.asarray(rng.uniform(0.0, 1.0, size=(2, 96, 128)).astype(np.float32))
        batched = fast.detect_keypoints_batched(imgs, max_keypoints=64, border_margin=8)
        for c in range(2):
            single = fast.detect_keypoints(imgs[c], max_keypoints=64, border_margin=8)
            np.testing.assert_array_equal(np.asarray(batched.valid[c]), np.asarray(single.valid))
            np.testing.assert_allclose(np.asarray(batched.xy[c]), np.asarray(single.xy), atol=1e-6)
