"""Full pipeline runner: SLAM tracking + per-camera RGB-D product streams.

The counterpart of the reference's scripts/run_pipeline.py: everything
run_slam does, plus dense SGM depth for the cameras listed in
``nvblox_cameras`` (or flagged ``enable_rgbd``), published as aligned
(rgb, 16UC1-millimeter depth) pairs on bus topics
``/camera_{i}/rgb|depth`` — the nvblox feed contract (reference
run_pipeline.py:166-292). The RGB-D path is rate-independent from the SLAM
path (here: every ``--rgbd-every`` ticks).

Usage:
    python -m scripts.run_pipeline --config config/slam_config.yaml
    python -m scripts.run_pipeline --synthetic --frames 60 --rgbd-every 5
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys
import time
from dataclasses import dataclass, field

from scripts.run_slam import _handle_signal, build_hardware_sources, build_synthetic_sources

logger = logging.getLogger("run_pipeline")


@dataclass
class RunSummary:
    """What a :func:`run` did: exit code, per-tick record and map products."""

    exit_code: int = 0
    #: (timestamp, 4x4 world_t_body) of every pose the engine returned.
    poses: list = field(default_factory=list)
    #: Wall time of each loop iteration (sync, track, RGB-D, mapping), ms.
    tick_ms: list = field(default_factory=list)
    tracking_state: str = ""
    num_inliers: int = 0
    rgbd_frames: int = 0
    integrated_frames: int = 0
    mesh_vertices: int = 0
    mesh_triangles: int = 0
    esdf_observed_cells: int = 0


def run(
    cfg,
    max_frames: int | None = None,
    rgbd_every: int = 5,
    use_ros: bool = False,
    save_dense_map: str | None = None,
    save_ply: str | None = None,
) -> RunSummary:
    import numpy as np

    import scripts.run_slam as rs
    from thor_slam_tpu.camera.rig import CameraRig
    from thor_slam_tpu.engine.tpu_engine import TpuSlamEngine
    from thor_slam_tpu.pipeline.bus import MessageBus
    from thor_slam_tpu.pipeline.rgbd import RGBDProcessor
    from thor_slam_tpu.slam.interface import SlamConfig
    from thor_slam_tpu.utils.profiling import PipelineStats, RateCounter

    imu_ext = None
    if cfg.synthetic.enabled or not cfg.cameras:
        sources, rig_ext = build_synthetic_sources(cfg)
    else:
        try:
            sources, rig_ext, imu_ext = build_hardware_sources(cfg)
        except ImportError as e:  # depthai absent: say so, don't traceback
            logger.error("%s", e)
            return RunSummary(exit_code=2)

    bus = MessageBus()
    pose_topic = bus.topic("/slam/pose", queue_size=30)
    stats = PipelineStats()

    ros_bridge = None
    if use_ros:
        from thor_slam_tpu.slam.adapters.ros_bridge import HAVE_ROS, RosBridge

        if not HAVE_ROS:
            logger.error("--ros requested but rclpy is not installed")
            return RunSummary(exit_code=2)
        ros_bridge = RosBridge()

    engine = TpuSlamEngine(
        params=dict(max_keypoints=cfg.backend.max_keypoints, **cfg.backend.tracker),
        enable_ba=cfg.backend.enable_ba,
        use_imu=cfg.backend.use_imu,
        use_accel=cfg.backend.use_accel,
        prewarm_degraded=cfg.watchdog_timeout_s is not None,
        pipelined=cfg.backend.pipelined,
        pipeline_depth=cfg.backend.pipeline_depth,
        devices=cfg.backend.devices,
        light_ticks=cfg.backend.light_ticks,
        light_half_res=cfg.backend.light_half_res,
        adaptive_half_res=cfg.backend.adaptive_half_res,
        imu_noise=cfg.backend.imu_noise,
    )
    rig = CameraRig(
        sources,
        queue_size=cfg.rig_queue_size,
        rig_extrinsics=rig_ext,
        imu_extrinsics=imu_ext,
        imu_source=sources[0].name if sources[0].has_sensor_data else None,
        watchdog_timeout_s=cfg.watchdog_timeout_s,
    )

    # RGB-D processors: explicit nvblox list, else enable_rgbd flags, else
    # (synthetic mode) the first camera.
    rgbd_ips = cfg.rgbd_camera_ips()
    if not rgbd_ips and (cfg.synthetic.enabled or not cfg.cameras):
        rgbd_ips = [sources[0].name]
    processors: list[RGBDProcessor] = []
    rgbd_topics = {}
    rgbd_fps: dict[str, RateCounter] = {}

    # In-process dense mapper: the nvblox-node role, on the tracker's
    # device (the reference needs an external CUDA process for this —
    # reference launch/thor_nvblox.launch.py:62-91).
    mapper = None
    pose_hist: list = []  # (timestamp, world_t_body) ring for TF-style lookup
    if cfg.mapping.enabled:
        from thor_slam_tpu.pipeline.mapper import DenseMapper, MapperConfig

        m = cfg.mapping
        mapper = DenseMapper(
            MapperConfig(
                voxel_size_m=m.voxel_size_m,
                dims=m.dims,
                truncation_vox=m.truncation_vox,
                max_integration_distance_m=m.max_integration_distance_m,
                integrate_color=m.integrate_color,
                recenter_margin_m=m.recenter_margin_m,
                slice_axis=m.slice_axis,
                slice_band_m=m.slice_band_m,
                esdf_max_distance_m=m.esdf_max_distance_m,
            )
        )
        logger.info(
            "Dense mapper: %s voxels at %.0f mm (%.1fx%.1fx%.1f m)",
            "x".join(map(str, m.dims)), m.voxel_size_m * 1000, *mapper.spec.extent_m,
        )
    surface_topic = bus.topic("/mapper/surface", queue_size=2, keep_latest_only=True)

    frame_count = 0
    summary = RunSummary()
    try:
        rig.start()
        logger.info("Initializing engine (jit warm-up)...")
        engine.initialize(rig.calibration, SlamConfig(num_cameras=cfg.num_cameras, expected_fps=cfg.fps))

        cam_cfg_by_ip = {c.ip: c for c in cfg.cameras}
        product_ext: dict[str, object] = {}
        for i, ip in enumerate(rgbd_ips):
            src = rig.get_source(ip)
            if src is None:
                logger.warning("RGB-D camera %s not in the rig; skipping", ip)
                continue
            # Color leg + independent output resolution (the reference's
            # resolution-independence contract, ref run_pipeline.py:138-148):
            # any source exposing the color surface (hardware driver or the
            # synthetic rig) feeds the color-aligned product.
            entry = cam_cfg_by_ip.get(ip)
            out_res = entry.rgb_output_resolution if entry is not None else None
            color_intr = getattr(src, "get_rgb_intrinsics", lambda: None)()
            color_ext = getattr(src, "get_rgb_extrinsics", lambda: None)()
            proc = RGBDProcessor(
                ip,
                src.get_intrinsics(),
                src.get_extrinsics(),
                output_resolution=out_res,
                color_intrinsics=color_intr,
                left_t_color=(
                    color_ext.to_4x4_matrix() if color_ext is not None else None
                ),
            )
            if proc.color_mode:
                logger.info("RGB-D %s: color-aligned at %dx%d", ip, proc.output_intrinsics.width, proc.output_intrinsics.height)
            # Pose of the RGB-D product frame in the body: body_T_left
            # composed with the product's frame (rectified-left or color).
            body_cams = rig.calibration.get_world_extrinsics(ip)
            if body_cams:
                product_ext[ip] = body_cams[0].to_4x4_matrix() @ proc.product_t_in_left
            processors.append(proc)
            rgbd_topics[ip] = (
                bus.topic(f"/camera_{i}/rgb", queue_size=5),
                bus.topic(f"/camera_{i}/depth", queue_size=5),
            )
            rgbd_fps[ip] = RateCounter()
            logger.info("RGB-D stream for %s -> /camera_%d/{rgb,depth}", ip, i)

        last_status = time.monotonic()
        while not rs._shutdown and (max_frames is None or frame_count < max_frames):
            t_tick = time.perf_counter()
            with stats.stage("sync").time():
                sync = rig.get_synchronized_frames()
            if sync is None:
                time.sleep(0.001)
                continue
            with stats.stage("track").time():
                pose = engine.process_frames(sync)
            frame_count += 1
            stats.fps.tick()
            stats.max_time_delta_ms = sync.max_time_delta * 1000.0
            stats.tracking_state = engine.get_tracking_state().name
            stats.num_inliers = engine.last_diagnostics.get("num_inliers", 0)
            if pose is not None:
                pose_topic.publish(pose)
                pose_hist.append((pose.timestamp, pose.to_4x4_matrix()))
                summary.poses.append(pose_hist[-1])
                if len(pose_hist) > 60:
                    del pose_hist[:-60]
                if ros_bridge is not None:
                    ros_bridge.publish_pose(pose)
                    ros_bridge.publish_map_tf(engine.map_t_odom, pose.timestamp)

            if frame_count % rgbd_every == 0:
                with stats.stage("rgbd").time():
                    for idx, proc in enumerate(processors):
                        color = None
                        if proc.color_mode:
                            src = rig.get_source(proc.camera_name)
                            color = getattr(src, "try_get_latest_rgb_frame", lambda: None)()
                        # Device-resident product: the mapper consumes it
                        # where the depth pipeline produced it (zero host
                        # round trips). Host bytes are fetched only at the
                        # ROS edge — in-process bus subscribers call
                        # frame.fetched() themselves when they need them.
                        frame = proc.process(sync, color_frame=color, fetch=False)
                        if frame is not None:
                            rgb_t, depth_t = rgbd_topics[proc.camera_name]
                            rgb_t.publish(frame)
                            depth_t.publish(frame)
                            rgbd_fps[proc.camera_name].tick()
                            summary.rgbd_frames += 1
                            if ros_bridge is not None:
                                ros_bridge.publish_rgbd(idx, frame.fetched())
                            if (
                                mapper is not None
                                and pose_hist
                                and proc.camera_name in product_ext
                                and (frame_count // rgbd_every)
                                % cfg.mapping.integrate_every == 0
                            ):
                                # TF-style lookup: nearest pose by stamp
                                # (the pipelined engine's pose lags the
                                # frame, like the reference's async
                                # odometry — reference isaac_ros.py:308).
                                ts, world_t_body = min(
                                    pose_hist, key=lambda p: abs(p[0] - frame.timestamp)
                                )
                                with stats.stage("map").time():
                                    mapper.integrate(
                                        frame,
                                        np.asarray(world_t_body)
                                        @ product_ext[proc.camera_name],
                                    )

            summary.tick_ms.append((time.perf_counter() - t_tick) * 1000.0)
            now = time.monotonic()
            if now - last_status >= 2.0:
                rates = " ".join(
                    f"rgbd[{ip[-2:]}]={r.rate_hz:.1f}Hz" for ip, r in rgbd_fps.items()
                )
                map_stat = ""
                if mapper is not None and mapper.stats.integrated_frames:
                    pts, cols = mapper.surface_cloud(max_points=65536)
                    surface_topic.publish((pts, cols))
                    if ros_bridge is not None:
                        ros_bridge.publish_surface_cloud(pts, cols, sync.timestamp)
                    map_stat = (
                        f" | map: {mapper.stats.integrated_frames}f"
                        f" {len(pts)}pts r{mapper.stats.recenters}"
                    )
                print(stats.status_line(frame_count) + " | " + rates + map_stat, flush=True)
                last_status = now
    finally:
        rig.stop()
        engine.flush()  # finalize the in-flight pipelined tick
        summary.tracking_state = engine.get_tracking_state().name
        summary.num_inliers = int(engine.last_diagnostics.get("num_inliers", 0))
        m = engine.get_map()
        print(
            f"Done: {frame_count} frames | map: {len(m.points)} points, "
            f"{len(m.keyframe_poses)} keyframes",
            flush=True,
        )
        if mapper is not None and mapper.stats.integrated_frames:
            mesh = mapper.mesh()
            dist, occ, obs, _ = mapper.esdf_slice()
            summary.integrated_frames = mapper.stats.integrated_frames
            summary.mesh_vertices = len(mesh.vertices)
            summary.mesh_triangles = len(mesh.triangles)
            summary.esdf_observed_cells = int(obs.sum())
            print(
                f"Dense map: {mapper.stats.integrated_frames} frames integrated | "
                f"mesh {len(mesh.vertices)}v/{len(mesh.triangles)}t | "
                f"costmap {int(occ.sum())} occupied / {int(obs.sum())} observed cells",
                flush=True,
            )
            if save_dense_map:
                mapper.save(save_dense_map)
                print(f"Dense map saved to {save_dense_map}", flush=True)
            if save_ply:
                mesh.save_ply(save_ply)
                print(f"Mesh PLY saved to {save_ply}", flush=True)
            if ros_bridge is not None:
                ros_bridge.publish_mesh_marker(mesh, time.time())
        engine.shutdown()
        if ros_bridge is not None:
            ros_bridge.shutdown()
    return summary


def main() -> int:
    from thor_slam_tpu.utils.config import RunConfig, load_config
    from thor_slam_tpu.utils.platform import enable_compilation_cache

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", default=None, help="YAML config path")
    parser.add_argument("--synthetic", action="store_true", help="Force the synthetic rig")
    parser.add_argument("--frames", type=int, default=None, help="Stop after N frames")
    parser.add_argument("--rgbd-every", type=int, default=5, help="RGB-D cadence (ticks)")
    parser.add_argument(
        "--map", action="store_true",
        help="Enable the in-process dense mapper (TSDF/mesh/costmap — "
        "the nvblox-node role; also via config mapping.enabled)",
    )
    parser.add_argument(
        "--save-dense-map", default=None, metavar="PATH",
        help="On exit, save the TSDF grid (.npz; reload with DenseMapper.load)",
    )
    parser.add_argument(
        "--save-ply", default=None, metavar="PATH",
        help="On exit, export the Surface-Nets mesh as binary PLY",
    )
    parser.add_argument(
        "--ros", action="store_true",
        help="Publish odometry/TF + nvblox RGB-D topics to ROS 2 (requires rclpy)",
    )
    args = parser.parse_args()

    logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")

    # Fail fast on operator mistakes before the (slow) JAX bring-up.
    if args.ros:
        from thor_slam_tpu.slam.adapters.ros_bridge import HAVE_ROS

        if not HAVE_ROS:
            logger.error("--ros requested but rclpy is not installed")
            return 2
    from thor_slam_tpu.utils.config import ConfigError

    try:
        cfg = load_config(args.config) if args.config else RunConfig()
    except (ConfigError, FileNotFoundError) as e:
        logger.error("%s", e)
        return 2
    if args.synthetic:
        cfg.synthetic.enabled = True
    if args.map:
        cfg.mapping.enabled = True
    enable_compilation_cache()

    signal.signal(signal.SIGINT, _handle_signal)
    signal.signal(signal.SIGTERM, _handle_signal)
    if (args.save_dense_map or args.save_ply) and not cfg.mapping.enabled:
        logger.error("--save-dense-map/--save-ply require --map (or mapping.enabled)")
        return 2
    return run(
        cfg,
        max_frames=args.frames,
        rgbd_every=args.rgbd_every,
        use_ros=args.ros,
        save_dense_map=args.save_dense_map,
        save_ply=args.save_ply,
    ).exit_code


if __name__ == "__main__":
    sys.exit(main())
