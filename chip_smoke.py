"""Smoke test of the main path on one NVIDIA GPU.

Usage (from the repository root, on the machine with the card):

    python chip_smoke.py

Phases, each of which fails the run:

a. Device: JAX must see a GPU; prints the card's name and power limit.
b. Tracking + dense mapping through ``scripts.run_pipeline.run`` on the
   deployed rig (4 stereo cameras at 640x400, 30 fps, 400 Hz IMU; BA + IMU +
   loop closure, pipelined; RGB-D on one camera every 5 ticks into the
   256x256x128 TSDF at 5 cm): ends TRACKING with enough inliers, ATE inside
   its bound, TSDF frames integrated, an ESDF slice and a mesh produced.
c. GPU against CPU in this one process: the first 30 ticks of that sequence,
   and the 380-frame synthetic EuRoC-layout revisit sequence through
   ``scripts.run_euroc``.
d. The 4x1280x720 tracker step (256 keypoints per camera) for a few ticks.
e. Each hand-written kernel against its plain reference at the engine's
   shapes, with the kernel's time beside the time of the XLA version.

Every time printed carries the card line. Exits non-zero, without the
result line, when no GPU is present or any phase fails; otherwise the last
line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".chip_smoke")  # listed in .gitignore

# Bounds, each with its reason.
MIN_INLIERS = 40  # the keyframe_min_inliers tests/test_engine_e2e.py tracks with
ATE_BOUND_M = 0.05  # tests/test_engine_e2e.py's VO bound, over a longer path here
# f32 on two backends: reductions run in another order, so a RANSAC inlier
# near its threshold can flip and move a pose by a fraction of a mm per tick.
POSE_TOL_M = 0.005
POSE_TOL_DEG = 0.05
# Over 380 ticks those sub-mm differences accumulate along the orbit.
FLAGSHIP_ATE_TOL_M = 0.01
FRAMES_B = 120
TICKS_C = 30
TICKS_D = 8
SGM_SHAPES = ((400, 640, 64), (720, 1280, 96))  # (H, W, D) of the RGB-D products
TRACKER_SHAPES = ((400, 640, 512), (720, 1280, 256))  # (H, W, keypoints per camera)

CARD = ""
T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def log_time(what: str, ms: float, extra: str = "") -> None:
    log(f"{what}: {ms:.4f} ms{extra} | card: {CARD}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def timed(f, *args, reps: int = 20, rounds: int = 5) -> float:
    """Median over rounds of the mean per-call ms of ``reps`` queued calls."""
    import jax

    jax.block_until_ready(f(*args))
    per_call = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = f(*args)
        jax.block_until_ready(out)
        per_call.append((time.perf_counter() - t0) / reps * 1e3)
    return float(np.median(per_call))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)
    log(f"ok: {msg}")


# ---------------------------------------------------------------- phases


def phase_b() -> dict:
    from scripts.run_pipeline import run
    from thor_slam_tpu.camera.sources.synthetic import OrbitTrajectory
    from thor_slam_tpu.utils.config import RunConfig
    from thor_slam_tpu.utils.evaluation import ate_rmse

    cfg = RunConfig()
    cfg.synthetic.enabled = True
    cfg.mapping.enabled = True
    s = run(cfg, max_frames=FRAMES_B, rgbd_every=5)
    check(s.exit_code == 0, "run_pipeline.run returned 0")
    check(s.tracking_state == "TRACKING", f"engine ends {s.tracking_state}")
    check(s.num_inliers >= MIN_INLIERS, f"final inliers {s.num_inliers} >= {MIN_INLIERS}")
    traj = OrbitTrajectory(radius=cfg.synthetic.trajectory_radius)
    gt0 = np.linalg.inv(traj.pose(s.poses[0][0]))
    est = np.asarray([p[:3, 3] for _, p in s.poses])
    gt = np.asarray([(gt0 @ traj.pose(t))[:3, 3] for t, _ in s.poses])
    ate = ate_rmse(est, gt)
    path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    check(ate < ATE_BOUND_M, f"ATE {ate * 100:.3f} cm < {ATE_BOUND_M * 100:.0f} cm over {path:.2f} m, {len(est)} poses")
    check(s.integrated_frames > 0, f"{s.integrated_frames} TSDF frames integrated from {s.rgbd_frames} RGB-D frames")
    check(s.esdf_observed_cells > 0, f"ESDF slice observes {s.esdf_observed_cells} cells")
    check(s.mesh_vertices > 0 and s.mesh_triangles > 0, f"mesh {s.mesh_vertices}v/{s.mesh_triangles}t")
    steady = np.asarray(s.tick_ms[10:])
    rgbd = steady[4::5]  # ticks 15, 20, ... carry SGM + TSDF (frame_count % 5 == 0)
    for name, v in (("all ticks", steady), ("RGB-D + mapping ticks", rgbd)):
        log_time(f"b: run_pipeline tick, {name}, median (n={len(v)})", float(np.median(v)))
        log_time(f"b: run_pipeline tick, {name}, p90 (n={len(v)})", float(np.percentile(v, 90)))
    return dict(ate_cm=ate * 100, path_m=path, inliers=s.num_inliers, integrated=s.integrated_frames,
                tick_ms_median=float(np.median(steady)), tick_ms_p90=float(np.percentile(steady, 90)),
                ticks=len(steady))


def _pose_diffs(a: list, b: list) -> tuple[float, float, int]:
    """Max translation (m) and rotation (deg) gap over poses with equal stamps."""
    bm = {round(t, 9): p for t, p in b}
    dt, dr, n = 0.0, 0.0, 0
    for t, pa in a:
        pb = bm.get(round(t, 9))
        if pb is None:
            continue
        n += 1
        dt = max(dt, float(np.linalg.norm(pa[:3, 3] - pb[:3, 3])))
        c = (np.trace(pa[:3, :3].T @ pb[:3, :3]) - 1.0) / 2.0
        dr = max(dr, float(np.degrees(np.arccos(np.clip(c, -1.0, 1.0)))))
    return dt, dr, n


def phase_c() -> dict:
    import jax

    from scripts import make_euroc_synthetic, run_euroc
    from scripts.run_pipeline import run
    from thor_slam_tpu.utils.config import RunConfig

    cpu = jax.devices("cpu")[0]
    # The degrade-to-keep-up controller reads the wall clock, so a slower
    # device takes its other path by design: pin it off on both sides.
    cfg = RunConfig()
    cfg.synthetic.enabled = True
    cfg.backend.adaptive_half_res = False
    never = 10**9  # no RGB-D ticks: this phase compares tracking
    g = run(cfg, max_frames=TICKS_C, rgbd_every=never)
    with jax.default_device(cpu):
        c = run(cfg, max_frames=TICKS_C, rgbd_every=never)
    dt, dr, n = _pose_diffs(g.poses, c.poses)
    check(n >= TICKS_C - 2, f"{n} GPU/CPU poses with matching stamps")
    check(dt <= POSE_TOL_M and dr <= POSE_TOL_DEG,
          f"GPU vs CPU poses: max |dt| {dt * 1000:.4f} mm <= {POSE_TOL_M * 1000:.0f} mm, "
          f"max |dR| {dr:.5f} deg <= {POSE_TOL_DEG} deg")

    seq = os.path.join(WORK, "flagship_seq")
    make_euroc_synthetic.main(["--out", seq, "--frames", "380", "--width", "320", "--height", "200",
                               "--trajectory-rate", "0.35"])
    kw = dict(adaptive_half_res=False)
    t0 = time.perf_counter()
    ag = run_euroc.evaluate(Path(seq), **kw)
    tg = time.perf_counter() - t0
    with jax.default_device(cpu):
        t0 = time.perf_counter()
        ac = run_euroc.evaluate(Path(seq), **kw)
        tc = time.perf_counter() - t0
    log_time("c: flagship sequence wall, GPU", tg * 1000, f" (CPU {tc * 1000:.1f} ms)")
    check(abs(ag["ate"] - ac["ate"]) <= FLAGSHIP_ATE_TOL_M,
          f"flagship odometry ATE GPU {ag['ate'] * 100:.3f} cm vs CPU {ac['ate'] * 100:.3f} cm "
          f"(|d| <= {FLAGSHIP_ATE_TOL_M * 100:.0f} cm); map ATE GPU "
          f"{(ag['map_ate'] or 0) * 100:.3f} / CPU {(ac['map_ate'] or 0) * 100:.3f} cm; "
          f"loops GPU {ag['loops']} / CPU {ac['loops']}")
    return dict(pose_dt_mm=dt * 1000, pose_dr_deg=dr, flagship_ate_gpu_cm=ag["ate"] * 100,
                flagship_ate_cpu_cm=ac["ate"] * 100)


def phase_d() -> dict:
    import jax
    import jax.numpy as jnp

    from thor_slam_tpu.engine import tracker as trk
    from thor_slam_tpu.utils.flagship import flagship_rig, render_sequence

    params, setup, _, sources, _, _ = flagship_rig(num_cams=4, width=1280, height=720, max_keypoints=256)
    seq = jax.block_until_ready(render_sequence(sources, TICKS_D, xp=jnp).astype(jnp.float32))
    check(seq.shape == (TICKS_D, params.num_cams, 2, params.height, params.width), f"rendered {seq.shape} on the card")
    step = trk.make_track_step(params, setup, donate=True, pack=True)
    state = trk.init_state(params)
    ms, vals = [], None
    for i in range(TICKS_D):
        t0 = time.perf_counter()
        state, _out, packed = step(state, seq[i])
        vals = trk.unpack_output(jax.device_get(packed))
        ms.append((time.perf_counter() - t0) * 1000)
        log(f"d: tick {i}: inliers {vals['num_inliers']}, landmarks {vals['num_landmarks']}")
    check(vals["num_inliers"] >= MIN_INLIERS, f"720p final inliers {vals['num_inliers']} >= {MIN_INLIERS}")
    check(bool(np.isfinite(vals["world_t_body"]).all()), "720p pose finite")
    steady = ms[2:]
    log_time(f"d: 4x1280x720 tracker step incl. fetch, median (n={len(steady)})", float(np.median(steady)))
    return dict(inliers=vals["num_inliers"], step_ms_median=float(np.median(steady)))


def phase_e() -> dict:
    import jax
    import jax.numpy as jnp

    from thor_slam_tpu.ops import fast, sgm_triton, stereo
    from thor_slam_tpu.ops.image import extract_patches_rig

    cpu = jax.devices("cpu")[0]
    res = {}
    rng = np.random.default_rng(0)

    # SGM aggregation: kernel vs the plain XLA recurrence, bit for bit.
    for h, w, d in SGM_SHAPES:
        base = rng.uniform(0, 1, (h, w + 8)).astype(np.float32)
        left, right = jnp.asarray(base[:, :w]), jnp.asarray(base[:, 5 : 5 + w])
        cost = stereo.census_cost_volume(stereo.census_transform(left), stereo.census_transform(right), d)
        cost = jax.block_until_ready(cost.astype(jnp.bfloat16))
        kern = jax.jit(lambda c: sgm_triton.sgm_aggregate(c, 6.0, 96.0))
        ref = jax.jit(lambda c: stereo.sgm_aggregate_xla(c, 6.0, 96.0))
        a = np.asarray(kern(cost))
        b = np.asarray(ref(cost))
        with jax.default_device(cpu):
            b_cpu = np.asarray(ref(jax.device_put(np.asarray(cost), cpu)))
        check(np.array_equal(a, b) and np.array_equal(a, b_cpu),
              f"SGM kernel == XLA recurrence (GPU and CPU) bit for bit at {w}x{h}/{d} "
              f"(differing: {int((a != b).sum())} vs GPU, {int((a != b_cpu).sum())} vs CPU)")
        tk, tx = timed(kern, cost), timed(ref, cost, reps=2, rounds=3)
        log_time(f"e: SGM aggregation {w}x{h}/{d}, Pallas-Triton kernel", tk, f" vs XLA lax.scan {tx:.4f} ms")
        full = jax.jit(lambda l, r: stereo.sgm_disparity(l, r, num_disparities=d))
        tf = timed(full, left, right, reps=5, rounds=3)
        log_time(f"e: sgm_disparity {w}x{h}/{d} end to end", tf)
        res[f"sgm_{w}x{h}_{d}"] = dict(kernel_ms=tk, xla_ms=tx, sgm_disparity_ms=tf)

    # Patch extraction (KLT 19x19, BRIEF 37x37) vs numpy slicing.
    for h, w, n in TRACKER_SHAPES:
        imgs = rng.uniform(0, 1, (4, h, w)).astype(np.float32)
        ctr = rng.integers(0, [w, h], size=(4 * n, 2)).astype(np.int32)
        cams = np.repeat(np.arange(4, dtype=np.int32), n)
        for size in (19, 37):
            r = size // 2
            f = jax.jit(lambda im, c, x: extract_patches_rig(im, c, x, size))
            got = np.asarray(f(jnp.asarray(imgs), jnp.asarray(cams), jnp.asarray(ctr)))
            cx = np.clip(ctr[:, 0], r, w - r - 1)
            cy = np.clip(ctr[:, 1], r, h - r - 1)
            want = np.stack([imgs[k, y - r : y + r + 1, x - r : x + r + 1] for k, x, y in zip(cams, cx, cy)])
            check(np.array_equal(got, want), f"patch gather == numpy slicing, 4x{w}x{h}, {n} kp, {size}x{size}")
            t = timed(f, jnp.asarray(imgs), jnp.asarray(cams), jnp.asarray(ctr))
            log_time(f"e: patch gather 4x{w}x{h}, {n} kp/cam, {size}x{size}", t)
            res[f"patches_{w}x{h}_{size}"] = t

    # FAST-9 scores + NMS: GPU maps identical to the CPU's.
    for h, w, _ in TRACKER_SHAPES:
        imgs = rng.uniform(0, 1, (8, h, w)).astype(np.float32)

        def scores(im):
            raw = jax.vmap(lambda x: fast.fast_score_map(x, 0.06))(im)
            return raw, jax.vmap(fast.nms3x3)(raw)

        f = jax.jit(scores)
        g = [np.asarray(v) for v in f(jnp.asarray(imgs))]
        with jax.default_device(cpu):
            c = [np.asarray(v) for v in f(jax.device_put(imgs, cpu))]
        check(all(np.array_equal(x, y) for x, y in zip(g, c)), f"FAST scores + NMS, 4x2x{w}x{h}: GPU == CPU")
        t = timed(f, jnp.asarray(imgs))
        mb = 3 * imgs.size * 4 / 1e6  # read the frames, write raw + NMS maps
        log_time(f"e: FAST score + NMS (XLA), 4x2x{w}x{h}", t,
                 f" ({mb:.1f} MB moved; {mb / 3.35e3:.4f} ms at 3.35 TB/s)")
        res[f"fast_{w}x{h}"] = t
    return res


def main() -> int:
    global CARD
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX sees {devices[0].platform}); failing", file=sys.stderr)
        return 2
    CARD = card_line()
    log(f"a: {len(devices)} x {devices[0].device_kind} ({devices[0].platform}); card: {CARD}")

    from thor_slam_tpu.utils.platform import enable_compilation_cache

    enable_compilation_cache()
    os.makedirs(WORK, exist_ok=True)
    failed, results = [], {}
    for name, fn in (("b", phase_b), ("c", phase_c), ("d", phase_d), ("e", phase_e)):
        t0 = time.perf_counter()
        try:
            results[name] = fn()
        except Exception:
            failed.append(name)
            log(f"PHASE {name} FAILED\n{traceback.format_exc()}")
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"results": results, "failed": failed}, default=float), flush=True)
    if failed:
        print(f"chip_smoke: phases failed: {failed}", file=sys.stderr)
        return 1
    print(CARD, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": devices[0].platform,
                                             "kind": devices[0].device_kind, "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
