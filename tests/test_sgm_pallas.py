"""SGM path aggregation: the Pallas-Triton kernel (interpret mode) and the
plain-XLA recurrence against the textbook sequential recurrence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from thor_slam_tpu.ops import sgm_triton, stereo


def exact_reference(cost_sdx: np.ndarray, p1: float, p2: float, reverse: bool) -> np.ndarray:
    """The textbook sequential SGM recurrence, step-major (S, D, X)."""
    c = np.asarray(cost_sdx, np.float32)
    if reverse:
        c = c[::-1]
    out = np.empty_like(c)
    big = 1e9
    l = c[0].copy()
    out[0] = l
    for s in range(1, c.shape[0]):
        pm = l.min(axis=0, keepdims=True)
        up = np.concatenate([l[1:], np.full_like(l[:1], big)], 0)
        dn = np.concatenate([np.full_like(l[:1], big), l[:-1]], 0)
        best = np.minimum(np.minimum(l, np.minimum(up, dn) + p1), pm + p2)
        l = c[s] + best - pm
        out[s] = l
    return out[::-1] if reverse else out


def reference_sum(cost_dhw: np.ndarray, p1: float, p2: float, num_paths: int = 4) -> np.ndarray:
    """Sum over paths of the textbook recurrence, back in (D, H, W)."""
    h = cost_dhw.transpose(2, 0, 1)
    agg = (exact_reference(h, p1, p2, False) + exact_reference(h, p1, p2, True)).transpose(1, 2, 0)
    if num_paths >= 4:
        v = cost_dhw.transpose(1, 0, 2)
        agg = agg + (exact_reference(v, p1, p2, False) + exact_reference(v, p1, p2, True)).transpose(1, 0, 2)
    return agg


def _costs(shape, seed):
    return np.random.default_rng(seed).integers(0, 25, shape).astype(np.float32)


def _kernel(cost, p1=6.0, p2=96.0, num_paths=4, dtype=jnp.bfloat16):
    out = sgm_triton.sgm_aggregate(jnp.asarray(cost, dtype), p1, p2, num_paths=num_paths, interpret=True)
    return np.asarray(out)


@pytest.mark.parametrize("reverse", [False, True])
def test_streaming_scan_is_exact(reverse):
    """The plain-XLA recurrence (the CPU path) matches the textbook one."""
    cost = _costs((48, 16, 40), 0)
    seq = jnp.asarray(cost[::-1] if reverse else cost, jnp.bfloat16)
    got = np.asarray(stereo._scan_path(seq, 6.0, 96.0), np.float32)
    np.testing.assert_array_equal(got[::-1] if reverse else got, exact_reference(cost, 6.0, 96.0, reverse))


@pytest.mark.parametrize("num_paths", [2, 4])
def test_kernel_matches_textbook(num_paths):
    cost = _costs((16, 24, 40), 2)
    np.testing.assert_array_equal(_kernel(cost, num_paths=num_paths), reference_sum(cost, 6.0, 96.0, num_paths))


def test_cross_dim_not_lane_multiple():
    # Neither H (cross-section of the horizontal paths) nor W (of the
    # vertical ones) is a multiple of the 32-lane tile: padding must not leak.
    cost = _costs((8, 37, 45), 1)
    np.testing.assert_array_equal(_kernel(cost), reference_sum(cost, 6.0, 96.0))


@pytest.mark.parametrize("num_disparities", [5, 24])
def test_any_disparity_count(num_disparities):
    # D needs no power of two and no multiple of anything (96 at 720p).
    cost = _costs((num_disparities, 20, 33), 5)
    np.testing.assert_array_equal(_kernel(cost), reference_sum(cost, 6.0, 96.0))


def test_4dir_matches_per_direction_sum():
    """Kernel == plain-XLA aggregation, also for f32 volumes and
    non-integral penalties (both run the same float32 operations)."""
    cost = _costs((12, 18, 26), 3) * 0.37
    got = _kernel(cost, 6.5, 80.25, dtype=jnp.float32)
    want = np.asarray(stereo.sgm_aggregate_xla(jnp.asarray(cost), 6.5, 80.25))
    np.testing.assert_array_equal(got, want)


def test_geometry_gate():
    """The kernel is chosen by the platform a computation compiles for: the
    Triton kernel in a CUDA lowering, plain XLA on the CPU — at any shape."""
    cost = jnp.ones((50, 19, 23), jnp.bfloat16)
    traced = jax.jit(lambda c: stereo.sgm_aggregate(c, 6.0, 96.0)).trace(cost)
    cuda = traced.lower(lowering_platforms=("cuda",)).as_text()
    assert "xla.gpu.triton" in cuda and "sgm_aggregate" in cuda
    assert "custom_call" not in traced.lower().as_text()


def test_winner_lr_matches_xla_tail():
    """The gather-based winner/LR tail against a numpy reference."""
    rng = np.random.default_rng(3)
    d, h, w = 16, 32, 64
    a = rng.integers(0, 400, (d, h, w)).astype(np.float32)
    db, c0, cm, cp, sec, dra = (np.asarray(v) for v in stereo.winner_lr(jnp.asarray(a), d))

    ref_db = a.argmin(axis=0)
    idx = np.arange(d)[:, None, None]

    def at(dsel):
        dc = np.clip(dsel, 0, d - 1)
        return np.take_along_axis(a, dc[None], axis=0)[0]

    np.testing.assert_array_equal(db, ref_db)
    np.testing.assert_array_equal(c0, at(ref_db))
    np.testing.assert_array_equal(cm, at(ref_db - 1))
    np.testing.assert_array_equal(cp, at(ref_db + 1))
    masked = np.where(np.abs(idx - ref_db[None]) <= 1, 1e9, a)
    np.testing.assert_array_equal(sec, masked.min(axis=0))

    big = 1e9
    agg_r = np.stack(
        [np.concatenate([a[dd, :, dd:], np.full((h, dd), big, np.float32)], 1) for dd in range(d)]
    )
    ref_dbr = agg_r.argmin(axis=0)
    shifted = np.stack(
        [np.concatenate([np.zeros((h, dd), np.int64), ref_dbr[:, : w - dd]], 1) for dd in range(d)]
    )
    ref_dra = np.take_along_axis(shifted, ref_db[None], axis=0)[0]
    np.testing.assert_array_equal(dra, ref_dra)


def test_sgm_disparity_known_shift():
    """End-to-end sgm_disparity on a synthetic constant-disparity pair."""
    rng = np.random.default_rng(4)
    h, w, shift = 64, 256, 5
    base = rng.uniform(0, 1, (h, w + shift)).astype(np.float32)
    import cv2

    base = cv2.GaussianBlur(base, (5, 5), 1.0)
    # left[x] = base[x]; right[x] = base[x + shift] => left matches right
    # at x - shift, i.e. constant disparity = +shift.
    left = jnp.asarray(base[:, :w])
    right = jnp.asarray(base[:, shift : shift + w])
    disp, valid = stereo.sgm_disparity(left, right, num_disparities=16)
    disp, valid = np.asarray(disp), np.asarray(valid)
    inner = valid[:, 24:]  # left margin can't match
    assert inner.mean() > 0.5
    err = np.abs(disp[:, 24:][inner] - shift)
    assert np.median(err) < 0.5
