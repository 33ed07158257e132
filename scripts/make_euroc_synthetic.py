"""Generate a synthetic stereo+IMU sequence in the EuRoC ASL layout.

Validates the full accuracy-benchmark path (scripts/run_euroc.py) without
the real dataset (this environment has no network): the synthetic renderer
writes `mav0/cam{0,1}/data/*.npy` + `data.csv`, `imu0/data.csv`,
`state_groundtruth_estimate0/data.csv` (analytic trajectory), and a
`calibration.npz` that EurocCameraSource picks up in place of the standard
VI-sensor calibration (real ASL sequences don't carry the file and keep
the standard values).

Usage:
    python -m scripts.make_euroc_synthetic --out /tmp/seq [--frames 60]
    python -m scripts.run_euroc --sequence /tmp/seq --frames 60
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--out", required=True, help="Sequence root to create")
    parser.add_argument("--frames", type=int, default=60)
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--height", type=int, default=400)
    parser.add_argument("--fps", type=float, default=20.0)
    parser.add_argument(
        "--trajectory-rate", type=float, default=0.25,
        help="Orbit angular rate (rad/s). A full revisit takes 2*pi/rate "
             "seconds — e.g. rate 0.35 at 20 fps revisits the start near "
             "frame 359, exercising loop closure in the ATE number.",
    )
    parser.add_argument("--radius", type=float, default=1.8)
    # Robustness nuisances (accuracy ablations — BASELINE.md table).
    parser.add_argument("--exposure-drift", type=float, default=0.0,
                        help="Sinusoidal gain amplitude (e.g. 0.3)")
    parser.add_argument("--noise-std", type=float, default=0.0,
                        help="Gaussian intensity noise std (0-255 scale)")
    parser.add_argument("--salt-prob", type=float, default=0.0,
                        help="Per-pixel salt&pepper probability")
    parser.add_argument("--motion-blur", type=float, default=0.0,
                        help="Horizontal blur px per rad/s of yaw rate")
    parser.add_argument("--gyro-bias", type=float, default=0.0,
                        help="Injected constant gyro bias (rad/s, z axis)")
    args = parser.parse_args(argv)

    from thor_slam_tpu import geometry
    from thor_slam_tpu.camera.sources.synthetic import (
        OrbitTrajectory,
        SyntheticCameraSource,
        SyntheticRigSpec,
        SyntheticWorld,
    )

    spec = SyntheticRigSpec(
        num_sources=1, stereo=True, width=args.width, height=args.height,
        baseline_m=0.11, fps=args.fps, imu_rate_hz=200.0,
        exposure_drift=args.exposure_drift,
        noise_std=args.noise_std,
        salt_prob=args.salt_prob,
        motion_blur_px_per_rad_s=args.motion_blur,
        imu_gyro_bias=(0.0, 0.0, args.gyro_bias),
    )
    world = SyntheticWorld(half_extents=(5.0, 5.0, 2.5))
    traj = OrbitTrajectory(radius=args.radius, angular_rate=args.trajectory_rate)
    src = SyntheticCameraSource(
        "cam0", world, traj, np.eye(4), spec, emit_imu=True, render=True
    )

    root = Path(args.out)
    mav = root / "mav0"
    for cam in ("cam0", "cam1"):
        data_dir = mav / cam / "data"
        if data_dir.exists():  # regenerating: drop frames from a prior run
            for stale in data_dir.glob("*.npy"):
                stale.unlink()
        data_dir.mkdir(parents=True, exist_ok=True)
    (mav / "imu0").mkdir(exist_ok=True)
    (mav / "state_groundtruth_estimate0").mkdir(exist_ok=True)

    cam_rows: dict[str, list[str]] = {"cam0": [], "cam1": []}
    gt_rows: list[str] = []
    imu_rows: list[str] = []
    src.start()
    for i in range(args.frames):
        frames = src.get_latest_frames()
        data, _ts = src.get_timestamped_sensor_data()
        ts_ns = int(round(frames[0].timestamp * 1e9))
        for cam, frame in zip(("cam0", "cam1"), frames):
            img = frame.image
            if img.dtype != np.uint8:
                img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
            np.save(mav / cam / "data" / f"{ts_ns}.npy", img)
            cam_rows[cam].append(f"{ts_ns},{ts_ns}.npy")

        pose = traj.pose(src.frame_time(i))  # world_T_body
        q = geometry.matrix_to_quat(pose[:3, :3])  # xyzw
        p = pose[:3, 3]
        gt_rows.append(
            f"{ts_ns},{p[0]:.9f},{p[1]:.9f},{p[2]:.9f},"
            f"{q[3]:.9f},{q[0]:.9f},{q[1]:.9f},{q[2]:.9f},"
            + ",".join(["0.0"] * 9)
        )
        if data is not None:
            for t_s, gyro, accel in zip(
                data["timestamps"], data["gyroscope"], data["accelerometer"]
            ):
                imu_rows.append(
                    f"{int(round(t_s * 1e9))},"
                    f"{gyro[0]:.9f},{gyro[1]:.9f},{gyro[2]:.9f},"
                    f"{accel[0]:.9f},{accel[1]:.9f},{accel[2]:.9f}"
                )
    src.stop()

    header = "#timestamp [ns],filename"
    for cam in ("cam0", "cam1"):
        (mav / cam / "data.csv").write_text(header + "\n" + "\n".join(cam_rows[cam]) + "\n")
    (mav / "imu0" / "data.csv").write_text(
        "#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n" + "\n".join(imu_rows) + "\n"
    )
    (mav / "state_groundtruth_estimate0" / "data.csv").write_text(
        "#timestamp [ns],px,py,pz,qw,qx,qy,qz,vx,vy,vz,bwx,bwy,bwz,bax,bay,baz\n"
        + "\n".join(gt_rows) + "\n"
    )

    intr = src.get_intrinsics()
    ext = src.get_extrinsics()
    c0_t_c1 = np.linalg.inv(ext[0].to_4x4_matrix()) @ ext[1].to_4x4_matrix()
    np.savez(
        mav / "calibration.npz",
        width=np.int64(args.width), height=np.int64(args.height),
        k0=np.asarray(intr[0].matrix), d0=np.asarray(intr[0].coeffs),
        k1=np.asarray(intr[1].matrix), d1=np.asarray(intr[1].coeffs),
        c0_t_c1=c0_t_c1,
    )
    print(
        f"Wrote {args.frames} stereo frames + {len(imu_rows)} IMU samples "
        f"+ ground truth to {root}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
