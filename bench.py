"""Headline benchmark: tracked FPS of the 4x stereo rig on one GPU.

Run on the machine with the card: ``python bench.py``. It fails when JAX
finds no GPU, runs everything in this one process (one process per card),
and prints exactly one JSON line; a phase that raises makes the exit code
non-zero. ``vs_baseline`` is measured FPS / 60 (BASELINE.json).

Structure: the device-only phases run FIRST and every phase writes its
numbers into the result dict the moment it finishes. A wall-clock budget
(``BENCH_BUDGET_S``, default 1260 s) skips remaining phases when exceeded,
and SIGTERM/SIGALRM print the JSON with whatever completed (nulls
elsewhere).

Numbers measured and reported in that line:

* ``value`` (the headline) — device-rate tracked FPS at 4x1280x720: the
  fused VO step scanned on device (``lax.scan``, one dispatch for the
  whole sequence, images pre-staged): the device's tracking throughput,
  free of per-dispatch overhead.
* ``device_tick_fps`` — the same step dispatched per tick from the host
  (one jit call per frame).
* ``tsdf_scan_ms_per_frame`` — TSDF integration with N frames fused into
  ONE dispatch (``make_scan_integrator``). Compare against
  ``tsdf_integrate_640x400_ms`` (per-dispatch streaming): the gap is the
  per-dispatch overhead, not integration cost.
* ``e2e_fps`` — online end-to-end FPS through
  ``TpuSlamEngine.process_frames`` fed host-resident uint8 frames at
  4x1280x720 (staging, pipelined upload, step, pose readback) in the
  VO-streaming configuration — what the reference's loop FPS measures
  (reference run_slam.py:324-328).
* ``e2e_default_fps`` — the same loop with the DEFAULT-featured engine:
  BA + IMU fusion + loop closure on, pipelined (the shipped
  config/slam_config.yaml backend section). This is the number a robot
  actually gets.
* ``e2e_640x400_*`` — the reference's deployed resolution
  (reference config/slam_config.yaml), including the 30 fps camera-clock
  cadence row (``_bench_e2e_cadence``) — the single most
  product-representative row in this file.
* ``transfer_bound_*`` — measured host->device link ceilings from probes
  interleaved with the phases; each e2e number is paired with the bound
  measured adjacent to it. Max-drive rows run with
  ``adaptive_half_res=False`` (they measure capacity at a PINNED quality
  level); every row also reports its actual per-tick payload mix
  (``engine.upload_stats``) so its bound is computed from the bytes that
  actually shipped.
"""

from __future__ import annotations

import json
import os
import signal
import sys
import time
import traceback


class BenchInterrupted(Exception):
    """Raised by the SIGTERM/SIGALRM handlers to unwind the current phase."""


def _palindrome(i: int, n: int) -> int:
    """Cycle 0..n-1..0 so a looped sequence never teleports.

    A plain ``i % n`` wrap jumps the camera back ~n frames of motion in one
    tick — tracking (correctly) drops and spends ~5 ticks re-bootstrapping,
    so the benchmark would time a lost/restart regime instead of steady
    tracking. The palindrome reverses direction smoothly instead.
    """
    j = i % (2 * n - 2)
    return j if j < n else 2 * n - 2 - j


def _h2d_probe(num_cams, width, height, reps=5):
    """Sustained host->device MB/s for one tick's image payload, NOW.

    Run between phases, so each e2e figure is read against a bound
    measured adjacent to it.
    """
    import jax
    import numpy as np

    tick_mb = num_cams * 2 * height * width / 1e6
    blob = np.random.randint(0, 255, (num_cams, 2, height, width), np.uint8)
    jax.block_until_ready(jax.device_put(blob))  # warm path
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(jax.device_put(blob))
    mbps = reps * tick_mb / (time.perf_counter() - t0)
    return mbps, mbps / tick_mb  # (MB/s, bound FPS for this tick size)


def _bench_device_scan(params, setup, sources, frames, seq_len):
    """Device-rate tracked FPS: `frames` ticks per ONE dispatch via lax.scan.

    The per-dispatch loop (``_bench_device_tick``) pays the host->device
    dispatch overhead per tick. Scanning the step on device amortizes one
    dispatch across the whole sequence, so this number is the device's
    tracking throughput.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from thor_slam_tpu.engine import tracker as trk
    from thor_slam_tpu.utils.flagship import render_sequence

    seq = render_sequence(sources, seq_len, xp=jnp)
    seq = jax.block_until_ready(seq.astype(jnp.float32))
    idx = jnp.asarray([_palindrome(i, seq_len) for i in range(frames)], jnp.int32)

    @jax.jit
    def run(state, seq, idx):
        def body(st, i):
            st, out = trk.track_step(params, setup, st, seq[i])
            return st, (out.world_t_body, out.num_inliers)
        return jax.lax.scan(body, state, idx)

    def fresh_state():
        return trk.init_state(params, world_t_body0=jnp.asarray(np.eye(4, dtype=np.float32)))

    _, (poses, _) = run(fresh_state(), seq, idx)
    jax.device_get(poses)
    best = 0.0
    inl = 0
    for _trial in range(3):
        state = fresh_state()
        t0 = time.perf_counter()
        _, (poses, inliers) = run(state, seq, idx)
        vals = jax.device_get((poses[-1], inliers[-1]))
        best = max(best, frames / (time.perf_counter() - t0))
        inl = int(vals[1])
    return best, inl


def _bench_device_tick(params, setup, sources, warmup, frames, seq_len):
    """Jitted-step FPS with images already on device (compute ceiling)."""
    import jax
    import jax.numpy as jnp

    from thor_slam_tpu.engine import tracker as trk
    from thor_slam_tpu.utils.flagship import render_sequence

    # donate + pack: no per-tick state alloc churn, and syncing on the
    # packed vector avoids materializing the full output tuple on host.
    step = trk.make_track_step(params, setup, donate=True, pack=True)
    state = trk.init_state(params)

    seq = render_sequence(sources, seq_len, xp=jnp)  # (T, C, 2, H, W)
    seq = jax.block_until_ready(seq.astype(jnp.float32))

    for i in range(warmup):
        state, _out, packed = step(state, seq[_palindrome(i, seq_len)])
    jax.block_until_ready(packed)

    best = 0.0
    vals = None
    base = warmup
    for _trial in range(3):
        t0 = time.perf_counter()
        for i in range(base, base + frames):
            state, _out, packed = step(state, seq[_palindrome(i, seq_len)])
        vals = trk.unpack_output(jax.device_get(packed))
        best = max(best, frames / (time.perf_counter() - t0))
        base += frames
    return best, vals["num_inliers"]


def _make_sync_factory(calibration, host_seq, seq_len, fps_nominal, with_imu):
    """Build the per-tick SynchronizedFrameSet factory over host frames."""
    import numpy as np

    from thor_slam_tpu.camera.types import CameraFrame, FrameSet, SynchronizedFrameSet

    names = list(calibration.source_names)
    dt = 1.0 / fps_nominal
    imu_rate = 400.0  # reference's configured IMU rate

    def make_sync(i: int) -> "SynchronizedFrameSet":
        ts = i * dt
        fsets = {}
        for c, name in enumerate(names):
            frames_ = [
                CameraFrame(
                    image=host_seq[_palindrome(i, seq_len), c, k],
                    timestamp=ts,
                    sequence_num=i,
                    camera_name=f"{name}_cam{k}",
                )
                for k in range(2)
            ]
            fsets[name] = FrameSet(timestamp=ts, frames=frames_, source_name=name)
        sensor_data = None
        if with_imu:
            # A realistic per-tick IMU batch (DepthAI-style batching): the
            # cost under measurement is ingestion + host preintegration +
            # the pose-predicted jit variant, not the values.
            n = int(imu_rate / fps_nominal)
            t_imu = ts - dt + np.arange(1, n + 1) * (dt / n)
            sensor_data = {
                "accelerometer": np.tile([0.0, 0.0, 9.81], (n, 1)),
                "gyroscope": np.tile([0.0, 0.4, 0.0], (n, 1)),
                "timestamps": t_imu,
            }
        return SynchronizedFrameSet(
            timestamp=ts, frame_sets=fsets, max_time_delta=0.0,
            sensor_data=sensor_data, sensor_timestamp=ts if with_imu else None,
        )

    return make_sync


def _payload_stats(stats_after: dict, stats_before: dict) -> dict:
    """Per-tick payload mix of a timed window (diff of engine.upload_stats)."""
    d = {k: stats_after[k] - stats_before[k] for k in stats_after}
    ticks = d["full"] + d["light"] + d["light_half"]
    d["ticks"] = ticks
    d["mean_bytes_per_tick"] = d["bytes"] / ticks if ticks else 0.0
    return d


def _bench_e2e(calibration, host_seq, seq_len, warmup, frames, mode):
    """End-to-end FPS through TpuSlamEngine.process_frames.

    mode="stream": pipelined depth-N pure-VO streaming (throughput
    configuration). mode="default": the shipped engine —
    BA + IMU + loop closure on.

    Both are MAX-DRIVE capacity rows, so the adaptive degrade-to-keep-up
    controller is pinned OFF (``adaptive_half_res=False``): a capacity
    measurement at a silently varying quality level is uninterpretable
    (round 4's stream/default rows measured a mid-run full/half mix).
    The deployed controller is measured by ``_bench_e2e_cadence`` instead.

    Returns (best_fps, diagnostics, mid_bound, payload) where ``payload``
    is the timed window's actual per-tick byte mix (engine.upload_stats
    diff) — the row's bound should be computed from these bytes.
    """
    from thor_slam_tpu.engine.tpu_engine import TpuSlamEngine
    from thor_slam_tpu.slam.interface import SlamConfig

    n_src = len(calibration.source_names)
    depth = int(os.environ.get("BENCH_PIPELINE_DEPTH", "6"))
    if mode == "stream":
        engine = TpuSlamEngine(
            params=dict(max_keypoints=256), use_imu=False, enable_ba=False,
            pipelined=True, pipeline_depth=depth, adaptive_half_res=False,
        )
        config = SlamConfig(num_cameras=2 * n_src, enable_loop_closure=False)
        with_imu = False
    else:
        # The SHIPPED configuration (config/slam_config.yaml backend):
        # BA + IMU + loop closure on, deep-pipelined. Every host backend
        # consumes finalized-tick data and corrections land as async
        # device deltas, so the FULL feature set streams at depth > 1 —
        # per-tick host syncs are batched across the pipeline instead.
        engine = TpuSlamEngine(
            params=dict(max_keypoints=256), pipelined=True,
            pipeline_depth=depth, adaptive_half_res=False,
        )
        config = SlamConfig(num_cameras=2 * n_src, enable_loop_closure=True)
        with_imu = True

    make_sync = _make_sync_factory(calibration, host_seq, seq_len, 30.0, with_imu)
    engine.initialize(calibration, config)
    for i in range(warmup):
        engine.process_frames(make_sync(i))
    engine.flush()
    base = warmup
    best = 0.0
    mid_bound = None
    s0 = dict(engine.upload_stats)
    h, w = host_seq.shape[-2:]
    for trial in range(2):
        t0 = time.perf_counter()
        for i in range(base, base + frames):
            engine.process_frames(make_sync(i))
        engine.flush()
        best = max(best, frames / (time.perf_counter() - t0))
        base += frames
        if trial == 0:
            # Probe BETWEEN the trials: the link state the phase itself
            # ran against, not the pre/post neighborhood.
            mid_bound = _h2d_probe(n_src, w, h)
    payload = _payload_stats(engine.upload_stats, s0)
    diag = dict(engine.last_diagnostics)
    engine.shutdown()
    return best, diag, mid_bound, payload


def _bench_e2e_cadence(calibration, host_seq, seq_len, ticks, cadence_s=1.0 / 30.0):
    """Default engine driven at the DEPLOYED camera cadence (30 fps).

    Frames become available on the real rig's clock (t0 + k*cadence,
    reference config/slam_config.yaml fps: 30) with REAL RIG SEMANTICS:
    the sync loop always consumes the NEWEST available frame set
    (reference rig.get_synchronized_frames returns the latest match),
    so a consumer that lags a deadline DROPS the missed frames instead
    of processing a backlog. That matters twice over: it is what a robot
    actually does, and without it the loop degenerates into the max-rate
    regime the moment one tick exceeds the period.

    This row keeps the adaptive controller ARMED — it measures the
    deployed configuration, controller included — and latches the actual
    payload mix (full/light/half tick counts + bytes) over the timed
    window, so the reported bound reflects what really shipped.

    Returns (delivered_fps, busy_ms_per_processed_tick, bound_fps,
    payload). ``delivered_fps`` counts processed frames over the wall
    time — 30 means every camera frame was tracked, lower means drops.
    ``busy_ms`` is the steady per-tick time inside process_frames (the
    first 2 processed ticks after the warm-up idle gap are excluded).
    ``bound_fps`` is the adjacent link probe divided by the window's
    MEASURED mean bytes/tick (not a nominal 2x/8x guess).
    """
    import numpy as np

    from thor_slam_tpu.engine.tpu_engine import TpuSlamEngine
    from thor_slam_tpu.slam.interface import SlamConfig

    n_src = len(calibration.source_names)
    engine = TpuSlamEngine(
        params=dict(max_keypoints=256), pipelined=True,
        pipeline_depth=int(os.environ.get("BENCH_PIPELINE_DEPTH", "6")),
    )
    make_sync = _make_sync_factory(calibration, host_seq, seq_len, 30.0, True)
    engine.initialize(calibration, SlamConfig(num_cameras=2 * n_src, enable_loop_closure=True))
    for i in range(8):
        engine.process_frames(make_sync(i))
    engine.flush()
    slept = 0.0
    processed = 0
    next_k = 0
    busy = []  # per-processed-tick wall time inside process_frames
    s0 = dict(engine.upload_stats)
    t0 = time.perf_counter()
    while next_k < ticks:
        now = time.perf_counter()
        newest = int((now - t0) / cadence_s)  # newest frame the rig has
        if newest < next_k:
            d = t0 + next_k * cadence_s - now
            time.sleep(d)
            slept += d
            newest = next_k
        k = min(newest, ticks - 1)
        tb = time.perf_counter()
        engine.process_frames(make_sync(8 + k))
        busy.append(time.perf_counter() - tb)
        processed += 1
        next_k = k + 1
    engine.flush()
    wall = time.perf_counter() - t0
    payload = _payload_stats(engine.upload_stats, s0)
    engine.shutdown()
    # Report the STEADY busy (drop the first 2 processed ticks after the
    # idle warm-up gap) alongside the wall-truth delivered rate.
    steady = busy[2:] if len(busy) > 4 else busy
    # Adjacent link bound from the MEASURED payload: probe the full-tick
    # rate now, scale by full-tick bytes over the window's actual mean
    # bytes/tick. Latched over the whole row (a degrade on the last few
    # ticks no longer mislabels the row — ADVICE r4).
    h, w = host_seq.shape[-2:]
    mbps, _full_bound = _h2d_probe(host_seq.shape[1], w, h)
    if payload["mean_bytes_per_tick"] > 0:
        bound = mbps * 1e6 / payload["mean_bytes_per_tick"]
    else:
        bound = float("nan")
    busy_ms = float(np.mean(steady)) * 1000.0 if steady else 0.0
    return processed / wall, busy_ms, bound, payload


def _bench_e2e_deferred(calibration, host_seq, seq_len, warmup, frames):
    """Offline/dataset-replay e2e FPS (defer_sync: one readback at flush).

    Compare against its own adjacent bound.
    """
    from thor_slam_tpu.engine.tpu_engine import TpuSlamEngine
    from thor_slam_tpu.slam.interface import SlamConfig

    n_src = len(calibration.source_names)
    engine = TpuSlamEngine(
        params=dict(max_keypoints=256), use_imu=False, enable_ba=False,
        pipelined=True, defer_sync=True,
    )
    make_sync = _make_sync_factory(calibration, host_seq, seq_len, 30.0, False)
    engine.initialize(calibration, SlamConfig(num_cameras=2 * n_src, enable_loop_closure=False))
    for i in range(warmup):
        engine.process_frames(make_sync(i))
    engine.flush()
    base = warmup
    best = 0.0
    for _trial in range(2):
        t0 = time.perf_counter()
        for i in range(base, base + frames):
            engine.process_frames(make_sync(i))
        engine.flush()
        best = max(best, frames / (time.perf_counter() - t0))
        base += frames
    diag = dict(engine.last_diagnostics)
    engine.shutdown()
    return best, diag


def _render_host_frames(num_cams, width, height, seq_len) -> "np.ndarray":
    """Render the uint8 host frame sequence on the device; one fetch."""
    import jax.numpy as jnp
    import numpy as np

    from thor_slam_tpu.utils.flagship import flagship_rig, render_sequence

    _, _, _, sources, _, _ = flagship_rig(
        num_cams=num_cams, width=width, height=height, max_keypoints=256
    )
    seq = render_sequence(sources, seq_len, xp=jnp)
    return np.clip(np.asarray(seq) * 255.0, 0, 255).astype(np.uint8)


def _bench_sgm(width=640, height=400, num_disparities=64, reps=40):
    """Dense SGM depth rate at the reference's deployed RGB-D geometry.

    The RGB-D product path's hot op (the OAK StereoDepth ASIC's role,
    reference luxonis.py:513-536). One trailing fetch closes the timing
    (the device stream is ordered).
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from thor_slam_tpu.ops import stereo as stereo_ops

    rng = np.random.default_rng(0)
    lefts = jnp.asarray(rng.uniform(0, 1, (4, height, width)).astype(np.float32))
    rights = jnp.roll(lefts, -7, axis=2)
    f = jax.jit(lambda l, r: stereo_ops.sgm_disparity(l, r, num_disparities=num_disparities)[0])
    jax.device_get(jnp.ravel(f(lefts[0], rights[0]))[:2])
    t0 = time.perf_counter()
    for i in range(reps):
        out = f(lefts[i % 4], rights[i % 4])
    jax.device_get(jnp.ravel(out)[:2])
    return (time.perf_counter() - t0) / reps * 1000.0


def _bench_mapping(width=640, height=400, reps=10, stream_frames=30, scan_frames=16):
    """Dense-mapping rates at the deployed nvblox geometry.

    The nvblox-node role (reference launch/thor_nvblox.launch.py:62-91):
    TSDF integration of 640x400 depth+color frames into the default
    256x256x128 grid at 5 cm, plus the export ops (Surface-Nets mesh,
    exact 2D ESDF costmap slice).

    Two TSDF figures:

    * ``integrate_ms`` — per-dispatch streaming (the DenseMapper path:
      donated grids, device-resident depth/color, pre-staged poses).
    * ``scan_ms`` — ``scan_frames`` integrations fused into ONE dispatch
      (``make_scan_integrator``), free of per-dispatch overhead; the
      integrate_ms/scan_ms ratio measures that overhead.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from thor_slam_tpu.mapping import (
        GridSpec, extract_mesh, make_grid, make_integrator, make_scan_integrator,
    )
    from thor_slam_tpu.mapping.esdf import esdf_slice_2d

    spec = GridSpec()  # the deployed parameters
    integ_stream = make_integrator(spec, donate=True)
    integ_keep = make_integrator(spec)  # ESDF phase keeps distinct grids
    integ_scan = make_scan_integrator(spec, donate=True)
    rng = np.random.default_rng(0)
    n_distinct = 8  # distinct device-resident frames, cycled
    depths = [
        jnp.asarray((rng.uniform(0.5, 8.0, (height, width)) * 1000).astype(np.uint16))
        for _ in range(n_distinct)
    ]
    colors = [
        jnp.asarray(rng.integers(0, 255, (height, width, 3), dtype=np.uint8))
        for _ in range(n_distinct)
    ]
    intr4 = np.asarray([420.0, 420.0, width / 2, height / 2], np.float32)

    def pose_host(i):
        a = 0.05 * i
        m = np.eye(4, dtype=np.float32)
        m[0, 0] = m[2, 2] = np.cos(a)
        m[0, 2], m[2, 0] = np.sin(a), -np.sin(a)
        return m

    # Pre-stage poses + intrinsics ON DEVICE: this phase claims the
    # device streaming rate (depth/color already device-resident — the
    # fetch=False product contract).
    n_poses = max(stream_frames + reps + 2, scan_frames + 1)
    poses_dev = jnp.asarray(np.stack([pose_host(i) for i in range(n_poses)]))
    intr_dev = jnp.asarray(intr4)

    def pose(i):
        return poses_dev[i]

    # ---- Scanned integration first (one dispatch).
    depths_stack = jnp.stack([depths[i % n_distinct] for i in range(scan_frames)])
    colors_stack = jnp.stack([colors[i % n_distinct] for i in range(scan_frames)])
    poses_stack = poses_dev[:scan_frames]
    g = integ_scan(
        make_grid(spec, origin_m=(-6.4, -6.4, -3.2)),
        depths_stack, colors_stack, poses_stack, intr_dev,
    )
    jax.block_until_ready(g.weight)  # compile + warm
    t0 = time.perf_counter()
    g = integ_scan(g, depths_stack, colors_stack, poses_stack, intr_dev)
    jax.block_until_ready(g.weight)
    scan_ms = (time.perf_counter() - t0) / scan_frames * 1000.0

    # Warm both per-frame compilations on a throwaway grid.
    grid_warm = integ_keep(
        make_grid(spec, origin_m=(-6.4, -6.4, -3.2)),
        depths[0], colors[0], pose(0), intr_dev,
    )
    jax.block_until_ready(grid_warm.weight)
    g = integ_stream(
        make_grid(spec, origin_m=(-6.4, -6.4, -3.2)),
        depths[0], colors[0], pose(0), intr_dev,
    )
    jax.block_until_ready(g.weight)

    # Streaming phase: the per-dispatch sensor-rate number.
    grid = make_grid(spec, origin_m=(-6.4, -6.4, -3.2))
    grid = integ_stream(grid, depths[0], colors[0], pose(0), intr_dev)
    jax.block_until_ready(grid.weight)
    t0 = time.perf_counter()
    for i in range(1, stream_frames + 1):
        grid = integ_stream(
            grid, depths[i % n_distinct], colors[i % n_distinct], pose(i), intr_dev
        )
    jax.block_until_ready(grid.weight)
    integrate_ms = (time.perf_counter() - t0) / stream_frames * 1000.0

    # Distinct grids for the ESDF phase (non-donated: all stay alive).
    grids = []
    for i in range(1, reps + 1):
        grid = integ_keep(grid, depths[i % n_distinct], colors[i % n_distinct], pose(i), intr_dev)
        grids.append(grid)
    jax.block_until_ready(grid.weight)

    extract_mesh(grid, spec, max_vertices=16384, max_quads=16384)  # compile
    t0 = time.perf_counter()
    mesh = extract_mesh(grid, spec, max_vertices=16384, max_quads=16384)
    mesh_ms = (time.perf_counter() - t0) * 1000.0

    # ESDF slice rate, amortized over DISTINCT integrated grids so a
    # single dispatch's overhead doesn't masquerade as kernel cost.
    args = dict(voxel_size_m=spec.voxel_size_m, z_lo_vox=60, z_hi_vox=80, max_distance_m=2.0)
    jax.block_until_ready(esdf_slice_2d(grid_warm.tsdf, grid_warm.weight, **args)[0])
    t0 = time.perf_counter()
    outs = [esdf_slice_2d(g.tsdf, g.weight, **args)[0] for g in grids]
    jax.block_until_ready(outs)
    esdf_ms = (time.perf_counter() - t0) / len(grids) * 1000.0
    return integrate_ms, scan_ms, mesh_ms, esdf_ms, len(mesh.vertices)


def main() -> int:
    width = int(os.environ.get("BENCH_WIDTH", "1280"))
    height = int(os.environ.get("BENCH_HEIGHT", "720"))
    num_cams = int(os.environ.get("BENCH_CAMS", "4"))
    warmup = int(os.environ.get("BENCH_WARMUP", "5"))
    frames = int(os.environ.get("BENCH_FRAMES", "60"))
    seq_len = int(os.environ.get("BENCH_SEQ", "12"))
    budget_s = float(os.environ.get("BENCH_BUDGET_S", "1260"))
    skip_lowres = os.environ.get("BENCH_SKIP_640", "") == "1"
    skip_default = os.environ.get("BENCH_SKIP_DEFAULT", "") == "1"

    def log(msg):
        print(f"bench: {msg}", file=sys.stderr, flush=True)

    # The result dict is COMPLETE from the start (every key present,
    # values null) and printed no matter what finishes — a number of
    # record must survive a failed phase, a budget overrun, or a SIGTERM.
    result = {
        "metric": (
            f"{num_cams}x{width}x{height}-stereo tracked FPS/GPU "
            f"(lax.scan, {frames} ticks/dispatch)"
        ),
        "value": None,
        "unit": "fps",
        "vs_baseline": None,
        "device_tick_fps": None,
        "num_inliers_scan_last": None,
        "num_inliers_last": None,
        "e2e_fps": None,
        "e2e_vs_baseline": None,
        "e2e_deferred_fps": None,
        "e2e_default_fps": None,
        "e2e_640x400_fps": None,
        "e2e_640x400_default_fps": None,
        "e2e_640x400_default_30fps_cadence_fps": None,
        "e2e_640x400_default_cadence_engine_ms": None,
        "transfer_bound_640x400_cadence_fps": None,
        "cadence_payload": None,
        "transfer_bound_fps": None,
        "transfer_bound_640x400_fps": None,
        "transfer_bound_640x400_default_fps": None,
        "payload_per_row": {},
        "h2d_MBps": {},
        "sgm_640x400_64_ms": None,
        "tsdf_integrate_640x400_ms": None,
        "tsdf_scan_ms_per_frame": None,
        "mesh_extract_ms": None,
        "esdf_slice_ms": None,
        "phase_s": {},
        "phases_skipped": [],
        "budget_s": budget_s,
        "device": None,
    }
    printed = {"done": False}

    def emit():
        if not printed["done"]:
            printed["done"] = True
            print(json.dumps(result), flush=True)

    def _on_signal(signum, frame):
        raise BenchInterrupted(signum)

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGALRM, _on_signal)
    # In-process backstop slightly inside the external budget: unwind the
    # current phase and print whatever exists. (If a phase is stuck inside
    # a non-returning C call the handler can't preempt it — the budget
    # checks between phases are the primary protection.)
    signal.alarm(max(30, int(budget_s)))
    t_start = time.monotonic()
    deadline = t_start + budget_s

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"no GPU found (JAX sees {dev.platform}); failing")
        return 2
    import subprocess

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    result["device"] = {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices()), "nvidia_smi": card,
    }
    log(f"device {result['device']}")

    from thor_slam_tpu.utils.platform import enable_compilation_cache

    enable_compilation_cache()

    from thor_slam_tpu.utils.flagship import flagship_rig

    params, setup, calibration, sources, _, _ = flagship_rig(
        num_cams=num_cams, width=width, height=height, max_keypoints=256
    )

    # Shared mutable context the phases thread through.
    ctx: dict = {"host_seq": None, "calib4": None, "host4": None}
    bounds: dict = {}

    # ---------------- phase bodies (each writes results immediately) ----

    def ph_device_scan():
        scan_fps, scan_inliers = _bench_device_scan(params, setup, sources, frames, seq_len)
        result["value"] = round(scan_fps, 2)
        result["vs_baseline"] = round(scan_fps / 60.0, 3)
        result["num_inliers_scan_last"] = scan_inliers
        log(f"device scan {scan_fps:.1f} fps (device rate, {frames} ticks/dispatch)")

    def ph_device_tick():
        tick_fps, tick_inliers = _bench_device_tick(params, setup, sources, warmup, frames, seq_len)
        result["device_tick_fps"] = round(tick_fps, 2)
        if result["num_inliers_last"] is None:
            result["num_inliers_last"] = tick_inliers
        log(f"device tick (per-dispatch) {tick_fps:.1f} fps")

    def ph_sgm():
        sgm_ms = _bench_sgm()
        result["sgm_640x400_64_ms"] = round(sgm_ms, 2)
        log(f"sgm 640x400/64 {sgm_ms:.1f} ms")

    def ph_mapping():
        tsdf_ms, scan_ms, mesh_ms, esdf_ms, _ = _bench_mapping()
        result["tsdf_integrate_640x400_ms"] = round(tsdf_ms, 3)
        result["tsdf_scan_ms_per_frame"] = round(scan_ms, 3)
        result["mesh_extract_ms"] = round(mesh_ms, 2)
        result["esdf_slice_ms"] = round(esdf_ms, 2)
        log(
            f"tsdf integrate {tsdf_ms:.2f} ms/frame per-dispatch, "
            f"{scan_ms:.3f} ms/frame scanned, mesh {mesh_ms:.1f} ms, "
            f"esdf slice {esdf_ms:.1f} ms"
        )

    def ph_render_720():
        log("rendering host frames...")
        ctx["host_seq"] = _render_host_frames(num_cams, width, height, seq_len)

    def ph_e2e_deferred():
        bounds["pre"] = _h2d_probe(num_cams, width, height)
        log(f"h2d pre: {bounds['pre'][0]:.1f} MB/s; deferred e2e phase...")
        e2e_deferred, _diag = _bench_e2e_deferred(
            calibration, ctx["host_seq"], seq_len, warmup, frames
        )
        result["e2e_deferred_fps"] = round(e2e_deferred, 2)
        bounds["post_deferred"] = _h2d_probe(num_cams, width, height)
        log(
            f"deferred {e2e_deferred:.1f} fps "
            f"(bound {bounds['post_deferred'][1]:.1f})"
        )

    def ph_e2e_stream():
        e2e_stream, diag_s, mid_stream, payload = _bench_e2e(
            calibration, ctx["host_seq"], seq_len, warmup, frames, "stream"
        )
        bounds["mid_stream"] = mid_stream
        bounds["post_stream"] = _h2d_probe(num_cams, width, height)
        bound_720 = max(mid_stream, bounds["post_stream"], key=lambda b: b[0])
        result["e2e_fps"] = round(e2e_stream, 2)
        result["e2e_vs_baseline"] = round(e2e_stream / 60.0, 3)
        result["transfer_bound_fps"] = round(bound_720[1], 1)
        result["num_inliers_last"] = diag_s.get(
            "num_inliers", result["num_inliers_last"]
        )
        result["payload_per_row"]["stream_720"] = payload
        log(f"stream {e2e_stream:.1f} fps (bound {bound_720[1]:.1f})")

    def ph_e2e_default():
        e2e_default, _d, mid_default, payload = _bench_e2e(
            calibration, ctx["host_seq"], seq_len, warmup, frames, "default"
        )
        bounds["mid_default"] = mid_default
        bounds["post_default"] = _h2d_probe(num_cams, width, height)
        result["e2e_default_fps"] = round(e2e_default, 2)
        result["payload_per_row"]["default_720"] = payload
        log(f"default {e2e_default:.1f} fps (bound {bounds['post_default'][1]:.1f})")

    def ph_render_640():
        _p4, _s4, calib4, _src4, _, _ = flagship_rig(
            num_cams=num_cams, width=640, height=400, max_keypoints=256
        )
        ctx["calib4"] = calib4
        ctx["host4"] = _render_host_frames(num_cams, 640, 400, seq_len)

    def ph_e2e_640_stream():
        low_bound = _h2d_probe(num_cams, 640, 400)
        e2e_lowres, _, mid_low, payload = _bench_e2e(
            ctx["calib4"], ctx["host4"], seq_len, warmup, frames, "stream"
        )
        low_bound = max(low_bound, mid_low, _h2d_probe(num_cams, 640, 400), key=lambda b: b[0])
        result["e2e_640x400_fps"] = round(e2e_lowres, 2)
        result["transfer_bound_640x400_fps"] = round(low_bound[1], 1)
        result["payload_per_row"]["stream_640"] = payload
        log(f"640x400 stream {e2e_lowres:.1f} fps (bound {low_bound[1]:.1f})")

    def ph_e2e_640_default():
        # The SHIPPED config at the reference's DEPLOYED resolution.
        e2e_lowres_default, _, mid_low_d, payload = _bench_e2e(
            ctx["calib4"], ctx["host4"], seq_len, warmup, frames, "default"
        )
        low_bound_d = max(mid_low_d, _h2d_probe(num_cams, 640, 400), key=lambda b: b[0])
        result["e2e_640x400_default_fps"] = round(e2e_lowres_default, 2)
        result["transfer_bound_640x400_default_fps"] = round(low_bound_d[1], 1)
        result["payload_per_row"]["default_640"] = payload
        log(
            f"640x400 default {e2e_lowres_default:.1f} fps "
            f"(bound {low_bound_d[1]:.1f})"
        )

    def ph_cadence():
        # The deployed regime: frames on the 30 fps camera clock,
        # adaptive controller armed (the product configuration).
        cadence_fps, cadence_busy_ms, cadence_bound, payload = _bench_e2e_cadence(
            ctx["calib4"], ctx["host4"], seq_len, ticks=240
        )
        result["e2e_640x400_default_30fps_cadence_fps"] = round(cadence_fps, 2)
        result["e2e_640x400_default_cadence_engine_ms"] = round(cadence_busy_ms, 2)
        result["transfer_bound_640x400_cadence_fps"] = round(cadence_bound, 1)
        result["cadence_payload"] = payload
        log(
            f"640x400 default @30fps cadence: {cadence_fps:.1f} fps wall, "
            f"engine {cadence_busy_ms:.1f} ms/tick (payload-weighted link "
            f"bound {cadence_bound:.1f} fps; "
            f"{payload['light_half']}/{payload['ticks']} half-res ticks)"
        )

    # (name, conservative wall estimate s, enabled, body). Ordered so the
    # cheap device-only numbers land first; an estimate only gates entry
    # (a phase that would blow the remaining budget is skipped, not run).
    # Among the e2e phases the DEPLOYED-RESOLUTION rows run first —
    # above all the 30 fps cadence row, the single most product-
    # representative number in this file — so a tight budget starves the
    # max-drive 720p rows, not the product row.
    phases = [
        ("device_scan", 60, True, ph_device_scan),
        ("device_tick", 45, True, ph_device_tick),
        ("sgm", 30, True, ph_sgm),
        ("mapping", 75, True, ph_mapping),
        ("render_640", 45, not skip_lowres, ph_render_640),
        ("e2e_640_stream", 90, not skip_lowres, ph_e2e_640_stream),
        ("e2e_640_default", 120, not skip_lowres and not skip_default, ph_e2e_640_default),
        # Cadence after the max-drive 640 rows, so it is not the
        # process's first e2e phase.
        ("cadence", 60, not skip_lowres and not skip_default, ph_cadence),
        ("render_720", 60, True, ph_render_720),
        ("e2e_deferred", 90, True, ph_e2e_deferred),
        ("e2e_stream", 90, True, ph_e2e_stream),
        ("e2e_default", 120, not skip_default, ph_e2e_default),
    ]

    #: Phases whose bodies need an earlier phase's context.
    requires = {
        "e2e_deferred": ("host_seq",),
        "e2e_stream": ("host_seq",),
        "e2e_default": ("host_seq",),
        "e2e_640_stream": ("calib4", "host4"),
        "e2e_640_default": ("calib4", "host4"),
        "cadence": ("calib4", "host4"),
    }

    failed: list[str] = []
    try:
        for name, est, enabled, body in phases:
            if not enabled:
                continue
            if any(ctx.get(k) is None for k in requires.get(name, ())):
                result["phases_skipped"].append(name + " (missing prereq)")
                continue
            remaining = deadline - time.monotonic()
            if remaining < est:
                result["phases_skipped"].append(name)
                log(f"skipping {name}: {remaining:.0f}s left < {est}s estimate")
                continue
            t0 = time.monotonic()
            try:
                body()
            except BenchInterrupted:
                result["phases_skipped"].append(name + " (interrupted)")
                log(f"phase {name} interrupted (signal/budget); emitting partial JSON")
                break
            except Exception:
                result["phases_skipped"].append(name + " (error)")
                failed.append(name)
                log(f"phase {name} FAILED:\n{traceback.format_exc()}")
            finally:
                result["phase_s"][name] = round(time.monotonic() - t0, 1)
    except BenchInterrupted:
        log("interrupted between phases; emitting partial JSON")
    finally:
        signal.alarm(0)
        result["h2d_MBps"] = {k: round(v[0], 1) for k, v in bounds.items()}
        emit()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
