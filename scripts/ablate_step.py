"""Ablation timing of track_step: stub stages out, measure the delta.

Usage: python -m scripts.ablate_step [WIDTHxHEIGHT]
Monkeypatches individual stages to no-ops and re-times the full fused step
(fresh jit per variant). The difference full - ablated is that stage's true
in-context cost, including fusion effects that per-stage microbenchmarks
miss. Not part of the test suite.

Methodology matches bench.py's device-tick phase: a palindrome over a
RENDERED moving-scene sequence with threaded state, so every call sees
fresh (state, image) inputs: on featureless random noise the tracker
state saturates to a fixed point and times an unrepresentative regime.
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp


def _palindrome(i: int, n: int) -> int:
    j = i % (2 * n - 2)
    return j if j < n else 2 * n - 2 - j


def time_step(step, state, seq, reps=30):
    n = seq.shape[0]
    for i in range(4):
        state, out = step(state, seq[_palindrome(i, n)])
    jax.device_get(out.world_t_body)
    t0 = time.perf_counter()
    for i in range(4, 4 + reps):
        state, out = step(state, seq[_palindrome(i, n)])
    jax.device_get(out.world_t_body)
    return (time.perf_counter() - t0) / reps * 1000.0


def main():
    res = sys.argv[1] if len(sys.argv) > 1 else "640x400"
    w, h = (int(v) for v in res.split("x"))

    from thor_slam_tpu.engine import pnp, tracker as trk
    from thor_slam_tpu.ops import brief, fast, klt, match
    from thor_slam_tpu.ops import stereo as stereo_ops
    from thor_slam_tpu.utils.flagship import flagship_rig, render_sequence

    params, setup, _, sources, _, _ = flagship_rig(
        num_cams=4, width=w, height=h, max_keypoints=512
    )
    seq = render_sequence(sources, 12, xp=jnp)  # (T, C, 2, H, W)
    seq = jax.block_until_ready(seq.astype(jnp.float32))

    def run(label):
        step = trk.make_track_step(params, setup)
        ms = time_step(step, trk.init_state(params), seq)
        print(f"{label:32s} {ms:8.2f} ms", flush=True)
        return ms

    base = run("FULL")

    # --- ablate KLT ---
    orig_klt = klt.track_points_rig
    def fake_klt(prev_pyr, cur_pyr, pts_prev, pts_init, valid, **kw):
        return klt.TrackResult(
            xy=pts_init, residual=jnp.zeros(pts_prev.shape[:2]), valid=valid
        )
    klt.track_points_rig = fake_klt
    run("no KLT")
    klt.track_points_rig = orig_klt

    # --- ablate RANSAC PnP ---
    orig_pnp = pnp.ransac_pnp
    def fake_pnp(key, pts, obs, valid, rot, tr, init, **kw):
        return pnp.PnPResult(
            body_t_world=init, inliers=valid, num_inliers=jnp.sum(valid),
            rms_error=jnp.asarray(0.0), covariance=jnp.eye(6),
        )
    pnp.ransac_pnp = fake_pnp
    run("no RANSAC PnP")
    pnp.ransac_pnp = orig_pnp

    # --- ablate disparity refine ---
    orig_ref = stereo_ops.refine_disparity_photometric
    stereo_ops.refine_disparity_photometric = lambda l, r, xy, d, v, **kw: d
    run("no disparity refine")
    stereo_ops.refine_disparity_photometric = orig_ref

    # --- ablate detection (fixed grid keypoints) ---
    orig_detect = fast.detect_keypoints_batched
    def fake_detect(ims, threshold=0.0, max_keypoints=512, **kw):
        c, h, w = ims.shape
        n = max_keypoints
        xs = (jnp.arange(n) * 37 % (w - 60) + 30).astype(jnp.float32)
        ys = (jnp.arange(n) * 23 % (h - 60) + 30).astype(jnp.float32)
        xy = jnp.broadcast_to(jnp.stack([xs, ys], -1), (c, n, 2))
        return fast.Keypoints(
            xy=xy, score=jnp.ones((c, n)), valid=jnp.ones((c, n), bool)
        )
    fast.detect_keypoints_batched = fake_detect
    run("no FAST detect")
    fast.detect_keypoints_batched = orig_detect

    # --- ablate descriptors+matching ---
    orig_match = match.match_descriptors
    def fake_match(da, va, db, vb, **kw):
        n = da.shape[0]
        return match.Matches(idx=jnp.arange(n, dtype=jnp.int32), distance=jnp.zeros(n), valid=va & vb)
    match.match_descriptors = fake_match
    run("no matching")
    match.match_descriptors = orig_match

    orig_desc = brief.compute_descriptors
    def fake_desc(im, xy, valid, oriented=True):
        n = xy.shape[0]
        return brief.Descriptors(bits=jnp.zeros((n, 8), jnp.uint32), angle=jnp.zeros(n), valid=valid)
    brief.compute_descriptors = fake_desc
    run("no BRIEF")
    brief.compute_descriptors = orig_desc


if __name__ == "__main__":
    main()
