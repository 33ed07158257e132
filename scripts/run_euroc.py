"""EuRoC sequence evaluation: replay -> track -> ATE against ground truth.

The accuracy-benchmark path (BASELINE.md: EuRoC ATE-RMSE target). Expects
the standard ASL layout; if ``mav0/state_groundtruth_estimate0/data.csv``
exists, reports ATE-RMSE/RPE against it.

Usage: python -m scripts.run_euroc --sequence /data/euroc/MH_01_easy \
           [--frames 500] [--out traj.csv]
"""

from __future__ import annotations

import argparse
import csv
import sys
import time
from pathlib import Path

import numpy as np


def load_groundtruth(seq_root: Path):
    gt_csv = seq_root / "mav0" / "state_groundtruth_estimate0" / "data.csv"
    if not gt_csv.exists():
        return None
    ts, pos = [], []
    with open(gt_csv) as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            vals = [float(v) for v in row]
            ts.append(vals[0] * 1e-9)
            pos.append(vals[1:4])
    return np.asarray(ts), np.asarray(pos)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--sequence", required=True)
    parser.add_argument("--frames", type=int, default=None)
    parser.add_argument("--out", default=None, help="Write trajectory CSV")
    parser.add_argument("--no-imu", action="store_true")
    parser.add_argument(
        "--no-accel", action="store_true",
        help="Gyro-only IMU prediction (constant-velocity translation)",
    )
    parser.add_argument("--no-ba", action="store_true", help="Disable window bundle adjustment")
    parser.add_argument("--no-loop", action="store_true", help="Disable loop closure")
    parser.add_argument(
        "--no-light", action="store_true",
        help="Disable light (left-only) tick scheduling (ablation)",
    )
    parser.add_argument(
        "--light-half-res", action="store_true",
        help="Ship light ticks 2x-downsampled (1/8 of a full tick's upload "
        "bytes; some inter-keyframe subpixel precision cost — measure here)",
    )
    parser.add_argument(
        "--median-filter", action="store_true",
        help="3x3 median prefilter on input images (salt-and-pepper / "
        "dead-pixel robustness; see BASELINE.md nuisance ablations)",
    )
    parser.add_argument(
        "--devices", type=int, default=None,
        help="Track SPMD over an N-device mesh (landmark-slot sharding for "
        "this single-camera sequence; combine with --cpu for a hardware-"
        "free virtual mesh)",
    )
    parser.add_argument(
        "--cpu", action="store_true",
        help="Pin the CPU backend before backend init (with --devices N: an "
        "N-device virtual mesh).",
    )
    args = parser.parse_args(argv)

    if args.cpu:
        import os

        if args.devices and args.devices > 1:
            flags = os.environ.get("XLA_FLAGS", "")
            if "host_platform_device_count" not in flags:
                os.environ["XLA_FLAGS"] = (
                    flags + f" --xla_force_host_platform_device_count={args.devices}"
                ).strip()
        from thor_slam_tpu.utils.platform import force_cpu

        force_cpu()

    from thor_slam_tpu.utils.platform import enable_compilation_cache

    enable_compilation_cache()
    try:
        evaluate(
            Path(args.sequence), args.frames, out=args.out, loop=not args.no_loop,
            use_imu=not args.no_imu, use_accel=not args.no_accel,
            enable_ba=not args.no_ba, devices=args.devices,
            light_ticks=False if args.no_light else None,
            light_half_res=args.light_half_res,
            params=dict(median_prefilter=True) if args.median_filter else None,
        )
    except FileNotFoundError as e:
        print(f"run_euroc: {e}", file=sys.stderr)
        return 2
    return 0


def evaluate(
    seq: Path, frames: int | None = None, out: str | None = None, loop: bool = True, **engine_kwargs
) -> dict:
    """Replay an ASL sequence through the engine and print its ATE.

    ``engine_kwargs`` go to :class:`TpuSlamEngine`. Returns the printed
    figures (meters): ``ate`` (odometry stream; None without ground
    truth), ``world_ate`` (with loop corrections; None if no loop closed),
    ``map_ate`` (keyframe trajectory; None under 3 keyframes), plus
    ``poses`` and ``loops``.

    Raises:
        FileNotFoundError: ``seq`` is not an ASL sequence.
    """
    from thor_slam_tpu.camera.rig import CameraRig
    from thor_slam_tpu.camera.sources.dataset import EurocCameraSource
    from thor_slam_tpu.engine.tpu_engine import TpuSlamEngine
    from thor_slam_tpu.slam.interface import SlamConfig
    from thor_slam_tpu.utils.evaluation import ate_rmse

    use_imu = engine_kwargs.get("use_imu", True)
    src = EurocCameraSource(seq, read_imu=use_imu, max_frames=frames)
    engine = TpuSlamEngine(**engine_kwargs)

    est_ts, est_pos, world_pos = [], [], []
    t0 = time.monotonic()
    with CameraRig([src], imu_source=src.name if src.has_sensor_data else None) as rig:
        engine.initialize(
            rig.calibration,
            SlamConfig(num_cameras=2, enable_loop_closure=loop),
        )
        n = 0
        while not src.exhausted:
            sync = rig.get_synchronized_frames()
            if sync is None:
                break
            pose = engine.process_frames(sync)
            n += 1
            if pose is not None:
                est_ts.append(sync.timestamp)
                # Smooth odometry stream (the reference's odometry topic)...
                est_pos.append(pose.position.copy())
                # ...and the loop-corrected world estimate (odometry lifted
                # through map<-odom, the reference's map->odom TF).
                world_pos.append(engine.get_world_pose(pose).position)
            if n % 100 == 0:
                print(f"{n} frames, {n / (time.monotonic() - t0):.1f} fps, "
                      f"state={engine.get_tracking_state().name}", flush=True)
    elapsed = time.monotonic() - t0
    est_ts = np.asarray(est_ts)
    est_pos = np.asarray(est_pos)
    print(f"Tracked {len(est_pos)} frames in {elapsed:.1f}s ({len(est_pos) / elapsed:.1f} fps)")
    loops = getattr(engine, "_loops_closed", 0)
    result = dict(ate=None, world_ate=None, map_ate=None, poses=len(est_pos), loops=loops)

    if out:
        with open(out, "w") as f:
            w = csv.writer(f)
            w.writerow(["#timestamp_s", "x", "y", "z"])
            for t, p in zip(est_ts, est_pos):
                w.writerow([f"{t:.9f}", *[f"{v:.6f}" for v in p]])
        print(f"Trajectory written to {out}")

    gt = load_groundtruth(seq)
    if gt is None:
        print("No ground truth in sequence; ATE not computed.")
        return result
    gt_ts, gt_pos = gt
    # Associate by TRUE nearest timestamp: searchsorted alone returns the
    # first GT entry at-or-after each estimate, pairing every pose with GT
    # up to one sample late (~5 ms at 200 Hz) and biasing ATE with velocity.
    hi = np.clip(np.searchsorted(gt_ts, est_ts), 0, len(gt_ts) - 1)
    lo = np.clip(hi - 1, 0, len(gt_ts) - 1)
    idx = np.where(np.abs(gt_ts[lo] - est_ts) <= np.abs(gt_ts[hi] - est_ts), lo, hi)
    matched_gt = gt_pos[idx]
    ate = ate_rmse(est_pos, matched_gt)
    result["ate"] = ate
    path_len = float(np.linalg.norm(np.diff(matched_gt, axis=0), axis=1).sum())
    flag = lambda on: "on" if on else "off"
    print(
        f"ATE-RMSE: {ate * 100:.2f} cm over {len(est_pos)} poses "
        f"({path_len:.1f} m path, {loops} loop closures, "
        f"ba={flag(engine_kwargs.get('enable_ba', True))} "
        f"loop={flag(loop)} imu={flag(use_imu)})"
    )
    if loops:
        # The live world estimate (odometry lifted through map<-odom): the
        # number a consumer of the full TF tree experiences. Odometry ATE
        # above stays loop-independent by design (smooth stream).
        result["world_ate"] = ate_rmse(np.asarray(world_pos), matched_gt)
        print(
            f"world-frame live ATE-RMSE: {result['world_ate'] * 100:.2f} cm "
            f"(odometry composed with map->odom)"
        )

    # The MAP trajectory: keyframe poses retro-corrected by loop-closure
    # pose-graph optimization and window BA. The live odometry stream
    # (above) necessarily contains the pre-correction drift plus the snap
    # at each closure — the map trajectory is where loop closure's benefit
    # is measurable (the reference likewise separates /tracking/odometry
    # from the optimized map, reference launch/thor_visual_slam.launch.py).
    kf = engine.get_map().keyframe_poses
    if len(kf) >= 3:
        kf_ts = np.asarray([p.timestamp for p in kf])
        kf_pos = np.asarray([p.position for p in kf])
        hi = np.clip(np.searchsorted(gt_ts, kf_ts), 0, len(gt_ts) - 1)
        lo = np.clip(hi - 1, 0, len(gt_ts) - 1)
        kidx = np.where(np.abs(gt_ts[lo] - kf_ts) <= np.abs(gt_ts[hi] - kf_ts), lo, hi)
        result["map_ate"] = ate_rmse(kf_pos, gt_pos[kidx])
        print(f"map-trajectory ATE-RMSE: {result['map_ate'] * 100:.2f} cm over {len(kf)} keyframes")
    return result


if __name__ == "__main__":
    sys.exit(main())
