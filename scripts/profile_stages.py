"""Stage-by-stage device timing of the tracker pipeline.

Usage: python -m scripts.profile_stages [WIDTHxHEIGHT] [num_cams]
           [--e2e] [--default] [--cadence-ms N]
Times each stage jitted in isolation (10 reps after warm-up) to locate
bottlenecks. With ``--e2e``, additionally attributes the END-TO-END
``process_frames`` tick to named host-side stages (stage / upload /
dispatch+compute / fetch / host state machine) — the breakdown that
explains any gap between bench.py's ``e2e_fps`` and its measured
transfer bound. ``--default`` runs the e2e attribution with the
SHIPPED-config engine (BA + IMU + loop closure, deep-pipelined) and
reports the per-tick fetch wait at max rate vs at a frame cadence
(``--cadence-ms``, default the reference's 30 fps): at max rate the
uploads can saturate the host–device link and the tiny output fetches
stall behind them; at the deployed camera cadence the dispatch-time d2h
copies land in the inter-frame gaps. Not part of the test suite.
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def bench_fn(name, fn, *args, reps=10):
    fn_j = jax.jit(fn)
    out = fn_j(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn_j(*args)
    jax.block_until_ready(out)
    ms = (time.perf_counter() - t0) / reps * 1000.0
    print(f"{name:28s} {ms:8.2f} ms", flush=True)
    return ms


def main():
    pos = [a for a in sys.argv[1:] if not a.startswith("--")]
    res = pos[0] if pos else "640x400"
    w, h = (int(v) for v in res.split("x"))
    c = int(pos[1]) if len(pos) > 1 else 4
    n = 512

    from thor_slam_tpu.engine import tracker as trk
    from thor_slam_tpu.ops import brief, calib, fast, klt, match
    from thor_slam_tpu.ops import stereo as stereo_ops
    from thor_slam_tpu.ops.image import downsample2, gaussian_blur
    from thor_slam_tpu.utils.flagship import flagship_rig

    params, setup, *_ = flagship_rig(num_cams=c, width=w, height=h, max_keypoints=n)
    setup = trk.CameraSetup(*(jnp.asarray(v) for v in setup))

    rng = np.random.default_rng(0)
    images = jnp.asarray(rng.uniform(0, 1, (c, 2, h, w)).astype(np.float32))
    img1 = images[:, 0]
    print(f"profile {c} cams @ {w}x{h}, N={n}  device={jax.devices()[0]}", flush=True)

    total = 0.0
    total += bench_fn(
        "gaussian blur (2C)",
        lambda a: (jax.vmap(lambda x: gaussian_blur(x, 2.0, radius=4))(a),
                   jax.vmap(lambda x: gaussian_blur(x, 2.0, radius=4))(a)),
        img1,
    )
    total += bench_fn(
        "FAST detect (2C)",
        lambda a: (
            jax.vmap(lambda x: fast.detect_keypoints(x, max_keypoints=n))(a),
            jax.vmap(lambda x: fast.detect_keypoints(x, max_keypoints=n))(a),
        ),
        img1,
    )
    kp = jax.vmap(lambda x: fast.detect_keypoints(x, max_keypoints=n))(img1)
    total += bench_fn(
        "BRIEF describe (2C)",
        lambda a, xy, v: (
            jax.vmap(lambda i, x, m: brief.compute_descriptors(i, x, m, oriented=False))(a, xy, v),
            jax.vmap(lambda i, x, m: brief.compute_descriptors(i, x, m, oriented=False))(a, xy, v),
        ),
        img1, kp.xy, kp.valid,
    )
    desc = jax.vmap(lambda i, x, m: brief.compute_descriptors(i, x, m, oriented=False))(
        img1, kp.xy, kp.valid
    )
    total += bench_fn(
        "coord rectify (2C)",
        lambda xy: (
            jax.vmap(calib.raw_pixels_to_rect)(xy, setup.k_left, setup.dist_left, setup.rect_left, setup.k_rect),
            jax.vmap(calib.raw_pixels_to_rect)(xy, setup.k_right, setup.dist_right, setup.rect_right, setup.k_rect),
        ),
        kp.xy,
    )
    total += bench_fn(
        "match (stereo, gated)",
        lambda d, v: jax.vmap(
            lambda da, va, db, vb: match.match_descriptors(da, va, db, vb)
        )(d, v, d, v),
        desc.bits, desc.valid,
    )
    total += bench_fn(
        "disparity refine",
        lambda l, r, xy: jax.vmap(stereo_ops.refine_disparity_photometric)(
            l, r, xy, jnp.ones((c, n)) * 5.0, jnp.ones((c, n), bool)
        ),
        img1, img1, kp.xy,
    )
    pyr1 = jax.vmap(downsample2)(img1)
    pyr2 = jax.vmap(downsample2)(pyr1)
    total += bench_fn(
        "KLT track (rig-flat DMA)",
        lambda p0, p1, p2, pts: klt.track_points_rig(
            (p0, p1, p2), (p0, p1, p2), pts, pts, jnp.ones((c, n), bool)
        ),
        img1, pyr1, pyr2, kp.xy,
    )
    from thor_slam_tpu.engine import pnp

    pts3 = jnp.asarray(rng.uniform(-3, 3, (c * n, 3)).astype(np.float32))
    obs = jnp.asarray(rng.uniform(-0.4, 0.4, (c * n, 2)).astype(np.float32))
    rot = jnp.tile(jnp.eye(3)[None], (c * n, 1, 1))
    tr = jnp.zeros((c * n, 3))
    total += bench_fn(
        "RANSAC PnP (24 hyp)",
        lambda a, b: pnp.ransac_pnp(
            jax.random.PRNGKey(0), a, b, jnp.ones(c * n, bool), rot, tr, jnp.eye(4)
        ),
        pts3, obs,
    )
    print(f"{'SUM of stages':28s} {total:8.2f} ms", flush=True)

    step = trk.make_track_step(params, setup)
    state = trk.init_state(params)
    state, out = step(state, images)
    jax.block_until_ready(out.world_t_body)
    t0 = time.perf_counter()
    reps = 10
    for _ in range(reps):
        state, out = step(state, images)
    jax.block_until_ready(out.world_t_body)
    ms = (time.perf_counter() - t0) / reps * 1000.0
    print(f"{'FULL track_step':28s} {ms:8.2f} ms  ({1000.0 / ms:.1f} fps)", flush=True)

    if "--e2e" in sys.argv:
        profile_e2e(w, h, c)
    if "--default" in sys.argv:
        cadence_ms = 33.3
        for a in sys.argv[1:]:
            if a.startswith("--cadence-ms="):
                cadence_ms = float(a.split("=", 1)[1])
        profile_default(w, h, c, cadence_ms)


def profile_e2e(w: int, h: int, c: int, ticks: int = 30) -> None:
    """Attribute one end-to-end process_frames tick to host-side stages.

    Each stage is force-synced (block_until_ready), so the SUM exceeds the
    pipelined production tick — the point is attribution, not throughput:
    which named stage eats the gap between e2e_fps and the link bound.
    """
    from thor_slam_tpu.camera.types import CameraFrame, FrameSet, SynchronizedFrameSet
    from thor_slam_tpu.engine import tracker as trk
    from thor_slam_tpu.engine.tpu_engine import TpuSlamEngine
    from thor_slam_tpu.slam.interface import SlamConfig
    from thor_slam_tpu.utils.flagship import flagship_rig, render_sequence

    _, _, calibration, sources, _, _ = flagship_rig(num_cams=c, width=w, height=h, max_keypoints=256)
    seq = np.clip(np.asarray(render_sequence(sources, 6)) * 255.0, 0, 255).astype(np.uint8)
    names = list(calibration.source_names)

    def make_sync(i):
        ts = i / 30.0
        j = i % (2 * len(seq) - 2)
        j = j if j < len(seq) else 2 * len(seq) - 2 - j
        fsets = {
            name: FrameSet(
                timestamp=ts,
                frames=[CameraFrame(seq[j, ci, k], ts, i, f"{name}_{k}") for k in range(2)],
                source_name=name,
            )
            for ci, name in enumerate(names)
        }
        return SynchronizedFrameSet(timestamp=ts, frame_sets=fsets, max_time_delta=0.0)

    engine = TpuSlamEngine(params=dict(max_keypoints=256), use_imu=False, enable_ba=False)
    engine.initialize(calibration, SlamConfig(num_cameras=2 * c, enable_loop_closure=False))
    for i in range(3):  # warm
        engine.process_frames(make_sync(i))

    agg = {k: 0.0 for k in ("stage", "upload", "dispatch+compute", "fetch", "host-state")}
    for i in range(3, 3 + ticks):
        sync = make_sync(i)
        t0 = time.perf_counter()
        flat = engine._stage_list(sync)
        t1 = time.perf_counter()
        images = engine._assemble(jax.device_put(flat))
        jax.block_until_ready(images)
        t2 = time.perf_counter()
        pending = engine._dispatch_tick(images, sync)
        jax.block_until_ready(pending["packed"])
        t3 = time.perf_counter()
        vals = jax.device_get(pending["packed"])
        t4 = time.perf_counter()
        engine._finalize_values(pending, vals)
        t5 = time.perf_counter()
        for k, d in zip(agg, (t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)):
            agg[k] += d
    print(f"\ne2e attribution ({c} cams @ {w}x{h}, {ticks} force-synced ticks):", flush=True)
    total = sum(agg.values())
    for k, v in agg.items():
        ms = v / ticks * 1000.0
        print(f"  {k:20s} {ms:8.2f} ms  ({100.0 * v / total:4.1f}%)", flush=True)
    print(f"  {'TOTAL':20s} {total / ticks * 1000.0:8.2f} ms  ({ticks / total:.1f} fps force-synced)", flush=True)
    engine.shutdown()


def profile_default(w: int, h: int, c: int, cadence_ms: float, ticks: int = 40) -> None:
    """Attribute the DEFAULT-featured pipelined tick; max rate vs cadence.

    The shipped configuration (BA + IMU + loop closure, pipeline depth 6)
    driven two ways: back-to-back (bench.py's regime — the per-tick image
    uploads can saturate the host–device link, so output fetches queue
    behind them) and at a fixed frame cadence (the deployed regime — the
    reference rig delivers 30 fps, reference config/slam_config.yaml, and
    the dispatch-time d2h copies land in the inter-frame gaps).
    """
    from thor_slam_tpu.camera.types import CameraFrame, FrameSet, SynchronizedFrameSet
    from thor_slam_tpu.engine.tpu_engine import TpuSlamEngine
    from thor_slam_tpu.slam.interface import SlamConfig
    from thor_slam_tpu.utils.flagship import flagship_rig, render_sequence

    _, _, calibration, sources, _, _ = flagship_rig(num_cams=c, width=w, height=h, max_keypoints=256)
    seq = np.clip(np.asarray(render_sequence(sources, 8)) * 255.0, 0, 255).astype(np.uint8)
    names = list(calibration.source_names)

    def make_sync(i):
        ts = i / 30.0
        j = i % (2 * len(seq) - 2)
        j = j if j < len(seq) else 2 * len(seq) - 2 - j
        fsets = {
            name: FrameSet(
                timestamp=ts,
                frames=[CameraFrame(seq[j, ci, k], ts, i, f"{name}_{k}") for k in range(2)],
                source_name=name,
            )
            for ci, name in enumerate(names)
        }
        n = 13
        t_imu = ts - 1 / 30.0 + np.arange(1, n + 1) * (1 / 30.0 / n)
        sd = {
            "accelerometer": np.tile([0.0, 0.0, 9.81], (n, 1)),
            "gyroscope": np.tile([0.0, 0.4, 0.0], (n, 1)),
            "timestamps": t_imu,
        }
        return SynchronizedFrameSet(
            timestamp=ts, frame_sets=fsets, max_time_delta=0.0,
            sensor_data=sd, sensor_timestamp=ts,
        )

    engine = TpuSlamEngine(params=dict(max_keypoints=256), pipelined=True, pipeline_depth=6)
    engine.initialize(calibration, SlamConfig(num_cameras=2 * c, enable_loop_closure=True))
    for i in range(8):
        engine.process_frames(make_sync(i))
    engine.flush()

    fetch_t: list[float] = []
    orig = engine._fetch_records

    def timed(records):
        t0 = time.perf_counter()
        orig(records)
        fetch_t.append(time.perf_counter() - t0)

    engine._fetch_records = timed

    base = 8
    print(f"\ndefault-featured e2e ({c} cams @ {w}x{h}, BA+IMU+loop, depth 6):", flush=True)
    for label, sleep_s in (("max rate", 0.0), (f"{cadence_ms:.0f} ms cadence", cadence_ms / 1e3)):
        fetch_t.clear()
        slept = 0.0
        processed = 0
        t0 = time.perf_counter()
        if not sleep_s:
            for i in range(base, base + ticks):
                engine.process_frames(make_sync(i))
                processed += 1
        else:
            # Real rig semantics: frames become available on the camera
            # clock (t0 + k*cadence) and the sync loop always consumes
            # the NEWEST one — a consumer that lags DROPS the missed
            # frames (reference rig.get_synchronized_frames returns the
            # latest match). Without drops the loop degenerates into the
            # max-rate regime the moment one tick exceeds the period.
            next_k = 0
            while next_k < ticks:
                now = time.perf_counter()
                newest = int((now - t0) / sleep_s)
                if newest < next_k:
                    d = t0 + next_k * sleep_s - now
                    time.sleep(d)
                    slept += d
                    newest = next_k
                k = min(newest, ticks - 1)
                engine.process_frames(make_sync(base + k))
                processed += 1
                next_k = k + 1
        engine.flush()
        wall = time.perf_counter() - t0
        busy = wall - slept
        avg_fetch = sum(fetch_t) / max(1, len(fetch_t)) * 1000.0
        print(
            f"  {label:16s} {processed / wall:6.1f} fps delivered"
            f" ({processed}/{ticks} frames) | engine"
            f" {busy / max(1, processed) * 1000.0:6.1f} ms/tick"
            f" | fetch wait {avg_fetch:6.1f} ms over {len(fetch_t)} events",
            flush=True,
        )
        base += ticks
    engine.shutdown()


if __name__ == "__main__":
    main()
