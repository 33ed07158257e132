"""KLT tracking tests: known shifts, synthetic motion, failure gating."""

import jax.numpy as jnp
import numpy as np

from thor_slam_tpu.ops import klt
from thor_slam_tpu.ops.image import build_pyramid
from thor_slam_tpu.ops.fast import detect_keypoints


def textured(h=120, w=160, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (h // 4, w // 4)).astype(np.float32)
    import cv2

    img = cv2.resize(base, (w, h), interpolation=cv2.INTER_LINEAR)
    return img


class TestPureShift:
    def test_integer_shift(self):
        img = textured()
        shift = 3
        cur = np.roll(img, shift, axis=1)
        pyr_p = tuple(build_pyramid(jnp.asarray(img), 3))
        pyr_c = tuple(build_pyramid(jnp.asarray(cur), 3))
        pts = jnp.asarray([[40.0, 40.0], [80.0, 60.0], [120.0, 90.0]])
        res = klt.track_points(pyr_p, pyr_c, pts, pts, jnp.ones(3, bool))
        assert bool(res.valid.all())
        np.testing.assert_allclose(np.asarray(res.xy)[:, 0], np.asarray(pts)[:, 0] + shift, atol=0.25)
        np.testing.assert_allclose(np.asarray(res.xy)[:, 1], np.asarray(pts)[:, 1], atol=0.25)

    def test_subpixel_shift(self):
        import cv2

        img = textured(seed=1)
        m = np.float32([[1, 0, 1.3], [0, 1, -0.7]])
        cur = cv2.warpAffine(img, m, (160, 120))
        pyr_p = tuple(build_pyramid(jnp.asarray(img), 3))
        pyr_c = tuple(build_pyramid(jnp.asarray(cur), 3))
        pts = jnp.asarray([[50.0, 50.0], [100.0, 70.0]])
        res = klt.track_points(pyr_p, pyr_c, pts, pts, jnp.ones(2, bool))
        assert bool(res.valid.all())
        np.testing.assert_allclose(np.asarray(res.xy)[:, 0], [51.3, 101.3], atol=0.2)
        np.testing.assert_allclose(np.asarray(res.xy)[:, 1], [49.3, 69.3], atol=0.2)

    def test_large_shift_with_good_init(self):
        img = textured(seed=2)
        cur = np.roll(img, 17, axis=1)
        pyr_p = tuple(build_pyramid(jnp.asarray(img), 3))
        pyr_c = tuple(build_pyramid(jnp.asarray(cur), 3))
        pts = jnp.asarray([[60.0, 60.0]])
        init = jnp.asarray([[75.0, 60.0]])  # within 2 px of the truth
        res = klt.track_points(pyr_p, pyr_c, pts, init, jnp.ones(1, bool))
        assert bool(res.valid[0])
        np.testing.assert_allclose(float(res.xy[0, 0]), 77.0, atol=0.3)


class TestGating:
    def test_flat_region_rejected_or_zero(self):
        """Tracks in textureless areas must not report wild motion."""
        img = np.full((120, 160), 0.5, np.float32)
        pyr = tuple(build_pyramid(jnp.asarray(img), 3))
        pts = jnp.asarray([[80.0, 60.0]])
        res = klt.track_points(pyr, pyr, pts, pts, jnp.ones(1, bool))
        # Degenerate gradient: position must not move.
        np.testing.assert_allclose(np.asarray(res.xy), np.asarray(pts), atol=1e-3)

    def test_mismatched_content_invalid(self):
        a = textured(seed=3)
        b = textured(seed=4)  # unrelated image
        pyr_a = tuple(build_pyramid(jnp.asarray(a), 3))
        pyr_b = tuple(build_pyramid(jnp.asarray(b), 3))
        pts = jnp.asarray([[60.0, 60.0], [90.0, 50.0], [40.0, 80.0]])
        res = klt.track_points(pyr_a, pyr_b, pts, pts, jnp.ones(3, bool), max_residual=0.05)
        assert np.asarray(res.valid).mean() < 0.5  # mostly rejected

    def test_out_of_bounds_invalid(self):
        img = textured(seed=5)
        pyr = tuple(build_pyramid(jnp.asarray(img), 3))
        pts = jnp.asarray([[2.0, 2.0]])
        init = jnp.asarray([[-10.0, 2.0]])
        res = klt.track_points(pyr, pyr, pts, init, jnp.ones(1, bool))
        # Out-of-frame tracks must be reported invalid.
        assert not bool(res.valid[0])

    def test_input_mask_respected(self):
        img = textured(seed=6)
        pyr = tuple(build_pyramid(jnp.asarray(img), 3))
        pts = jnp.asarray([[60.0, 60.0]])
        res = klt.track_points(pyr, pyr, pts, pts, jnp.zeros(1, bool))
        assert not bool(res.valid[0])


class TestSyntheticMotion:
    def test_tracks_rendered_camera_motion(self):
        from thor_slam_tpu.camera.sources.synthetic import (
            OrbitTrajectory,
            SyntheticCameraSource,
            SyntheticRigSpec,
            SyntheticWorld,
        )

        spec = SyntheticRigSpec(num_sources=1, stereo=False, width=160, height=120, fps=30.0)
        src = SyntheticCameraSource(
            "a", SyntheticWorld(half_extents=(4.0, 4.0, 2.0)), OrbitTrajectory(radius=1.5, angular_rate=0.5),
            np.eye(4), spec,
        )
        i0 = jnp.asarray(src.render_frame(0, 0).astype(np.float32) / 255.0)
        i1 = jnp.asarray(src.render_frame(1, 0).astype(np.float32) / 255.0)
        kps = detect_keypoints(i0, max_keypoints=128, border_margin=12)
        pyr0 = tuple(build_pyramid(i0, 3))
        pyr1 = tuple(build_pyramid(i1, 3))
        res = klt.track_points(pyr0, pyr1, kps.xy, kps.xy, kps.valid)
        ok = np.asarray(res.valid)
        assert ok.sum() >= 0.6 * int(kps.valid.sum())
        motion = np.linalg.norm(np.asarray(res.xy)[ok] - np.asarray(kps.xy)[ok], axis=1)
        assert np.median(motion) < 6.0  # small inter-frame flow
        assert np.median(motion) > 0.05  # but nonzero (camera moved)


class TestRigBatch:
    def test_rig_flat_matches_per_camera(self):
        """track_points_rig(C) must agree with C independent track_points calls.

        The rig entry flattens all cameras into one batch with a per-track
        camera index (one gather per level); per-camera results must not
        bleed across the camera axis.
        """
        import cv2

        prev, cur, pts = [], [], []
        shifts = [(2.0, -1.0), (-1.5, 0.5), (0.7, 2.2)]
        for ci, (dx, dy) in enumerate(shifts):
            img = textured(seed=10 + ci)
            m = np.float32([[1, 0, dx], [0, 1, dy]])
            prev.append(img)
            cur.append(cv2.warpAffine(img, m, (160, 120)))
            pts.append([[40.0 + 5 * ci, 40.0], [100.0, 60.0 + 4 * ci]])

        pyr_p = [tuple(build_pyramid(jnp.asarray(p), 3)) for p in prev]
        pyr_c = [tuple(build_pyramid(jnp.asarray(c), 3)) for c in cur]
        singles = [
            klt.track_points(pyr_p[ci], pyr_c[ci], jnp.asarray(pts[ci]),
                             jnp.asarray(pts[ci]), jnp.ones(2, bool))
            for ci in range(3)
        ]

        stack = lambda ps, lvl: jnp.stack([p[lvl] for p in ps])
        rig = klt.track_points_rig(
            tuple(stack(pyr_p, l) for l in range(3)),
            tuple(stack(pyr_c, l) for l in range(3)),
            jnp.asarray(pts), jnp.asarray(pts), jnp.ones((3, 2), bool),
        )
        for ci, single in enumerate(singles):
            np.testing.assert_allclose(np.asarray(rig.xy[ci]), np.asarray(single.xy), atol=1e-5)
            np.testing.assert_array_equal(np.asarray(rig.valid[ci]), np.asarray(single.valid))
            assert bool(rig.valid[ci].all())
            np.testing.assert_allclose(
                np.asarray(rig.xy[ci]),
                np.asarray(pts[ci]) + np.asarray(shifts[ci]),
                atol=0.25,
            )
