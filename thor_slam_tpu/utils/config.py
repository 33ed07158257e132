"""Runtime configuration: the YAML schema the reference's operators use.

Field-compatible with the reference's config/slam_config.yaml (per-camera
ip/stereo/resolution/sensor_type/enable_rgbd/rgb resolutions; global fps/
display/urdf_path/imu_report_rate/queue sizes; nvblox_cameras list —
reference scripts/run_slam.py:53-114 and scripts/run_pipeline.py:85-159),
plus a ``backend`` section for engine options and a ``synthetic``
section so every app runs hardware-free.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


class ConfigError(ValueError):
    """A config file is malformed; the message says which field and why."""


@dataclass
class CameraEntry:
    """One camera source in the rig."""

    ip: str
    stereo: bool = True
    resolution: tuple[int, int] = (640, 400)
    sensor_type: str = "MONO"
    output_resolution: tuple[int, int] | None = None
    enable_rgbd: bool = False
    rgb_sensor_resolution: tuple[int, int] | None = None
    rgb_output_resolution: tuple[int, int] | None = None

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "CameraEntry":
        def tup(key):
            v = d.get(key)
            return tuple(v) if v is not None else None

        if "ip" not in d:
            raise ConfigError(f"camera entry missing required key 'ip': {d!r}")
        ip = str(d["ip"])
        from thor_slam_tpu.camera.types import IPv4

        try:
            IPv4(ip)
        except ValueError as e:
            raise ConfigError(f"camera entry has invalid ip {ip!r}: {e}") from e
        return cls(
            ip=ip,
            stereo=bool(d.get("stereo", True)),
            resolution=tuple(d.get("resolution", (640, 400))),
            sensor_type=str(d.get("sensor_type", "MONO")),
            output_resolution=tup("output_resolution"),
            enable_rgbd=bool(d.get("enable_rgbd", False)),
            rgb_sensor_resolution=tup("rgb_sensor_resolution"),
            rgb_output_resolution=tup("rgb_output_resolution"),
        )


@dataclass
class BackendConfig:
    """Engine options (our extension; absent keys keep defaults)."""

    max_keypoints: int = 512
    enable_ba: bool = True
    enable_loop_closure: bool = True
    use_imu: bool = True
    #: Full-IMU translation prediction with online gravity estimation
    #: (accel preintegration engages once the odom-frame gravity EMA
    #: converges; constant-velocity fallback until then).
    use_accel: bool = True
    #: Overlap host staging/upload with device compute (one-tick pose
    #: latency). This is the reference's own semantics — its adapter
    #: returns a cached pose set asynchronously by the odometry callback
    #: (reference isaac_ros.py:308-325) — and what a robot should ship.
    pipelined: bool = True
    #: In-flight ticks when pipelined (pose latency = depth ticks). The
    #: full feature set (BA + IMU + loop closure) runs at any depth —
    #: deeper pipelines amortize host<->device round trips, the throughput
    #: lever on a high-latency host–device link.
    pipeline_depth: int = 1
    #: SPMD: track over an N-device jax mesh (1 = single chip).
    devices: int = 1
    #: Left-only uploads on ticks the host predicts won't keyframe (half
    #: the steady-state upload bytes; see TpuSlamEngine.light_ticks).
    #: None = engine auto (on for single-chip non-defer engines).
    light_ticks: bool | None = None
    #: Ship light ticks 2x-downsampled (1/4 of a light tick's bytes; the
    #: device upsamples). Costs some inter-keyframe subpixel precision —
    #: for upload-bound links; see TpuSlamEngine.light_half_res.
    light_half_res: bool = False
    #: Degrade-to-keep-up: when the engine's busy time per tick exceeds
    #: the camera period (global fps), switch light ticks to half-res
    #: staging instead of dropping frames; restore with hysteresis. See
    #: TpuSlamEngine.adaptive_half_res.
    adaptive_half_res: bool = True
    #: IMU noise-model overrides (gyro_noise_density, gyro_random_walk,
    #: accel_noise_density, accel_random_walk, vis_rot_sigma,
    #: vis_pos_sigma, estimate_gyro_bias). Defaults are the reference's
    #: measured OAK-D Pro densities (engine/imu.py; reference
    #: launch/thor_visual_slam.launch.py:82-104) — they set the gyro-bias
    #: and gravity Kalman gains and the held-pose covariance growth.
    imu_noise: dict[str, Any] = field(default_factory=dict)
    tracker: dict[str, Any] = field(default_factory=dict)


@dataclass
class MappingConfig:
    """In-process dense mapping (the nvblox-node role, our extension).

    Field defaults mirror the reference's nvblox launch parameters
    (reference launch/thor_nvblox.launch.py: voxel_size 0.05, truncation
    4 vox, max integration distance 10 m). Disabled by default — when
    off, run_pipeline only PUBLISHES the RGB-D feed, exactly like the
    reference (which needs an external CUDA nvblox process to consume
    it); when on, the in-process mapper consumes it on the same device.
    """

    enabled: bool = False
    voxel_size_m: float = 0.05
    dims: tuple[int, int, int] = (256, 256, 128)
    truncation_vox: float = 4.0
    max_integration_distance_m: float = 10.0
    integrate_color: bool = True
    recenter_margin_m: float = 2.0
    slice_axis: int = 2
    slice_band_m: tuple[float, float] = (0.0, 1.0)
    esdf_max_distance_m: float = 2.0
    #: Integrate every Nth produced RGB-D frame (1 = all).
    integrate_every: int = 1


@dataclass
class SyntheticConfig:
    """Hardware-free operation (our extension)."""

    enabled: bool = False
    num_cameras: int = 4
    resolution: tuple[int, int] = (640, 400)
    baseline_m: float = 0.075
    trajectory_radius: float = 1.8
    room_half_extents: tuple[float, float, float] = (5.0, 5.0, 2.5)
    color_camera: bool = False
    color_resolution: tuple[int, int] | None = None


@dataclass
class RunConfig:
    """Everything an app needs to bring the system up."""

    cameras: list[CameraEntry] = field(default_factory=list)
    fps: float = 30.0
    display: bool = False
    urdf_path: str = ""
    imu_report_rate: int = 400
    queue_size: int = 8
    rig_queue_size: int = 10
    watchdog_timeout_s: float | None = None
    nvblox_cameras: list[str] = field(default_factory=list)
    backend: BackendConfig = field(default_factory=BackendConfig)
    synthetic: SyntheticConfig = field(default_factory=SyntheticConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)

    @property
    def num_cameras(self) -> int:
        """Total imagers: 2 per stereo source, 1 per mono (reference
        run_slam.py:112-114)."""
        return sum(2 if c.stereo else 1 for c in self.cameras)

    def rgbd_camera_ips(self) -> list[str]:
        """Cameras feeding the RGB-D product: the explicit nvblox list, else
        every camera flagged enable_rgbd (reference run_pipeline.py:99-159)."""
        if self.nvblox_cameras:
            return list(self.nvblox_cameras)
        return [c.ip for c in self.cameras if c.enable_rgbd]

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "RunConfig":
        cams = [CameraEntry.from_dict(c) for c in d.get("cameras", [])]
        backend_d = d.get("backend", {}) or {}
        backend = BackendConfig(
            max_keypoints=int(backend_d.get("max_keypoints", 512)),
            enable_ba=bool(backend_d.get("enable_ba", True)),
            enable_loop_closure=bool(backend_d.get("enable_loop_closure", True)),
            use_imu=bool(backend_d.get("use_imu", True)),
            use_accel=bool(backend_d.get("use_accel", True)),
            pipelined=bool(backend_d.get("pipelined", True)),
            pipeline_depth=int(backend_d.get("pipeline_depth", 1)),
            devices=int(backend_d.get("devices", 1)),
            light_ticks=(
                None
                if backend_d.get("light_ticks") is None
                else bool(backend_d["light_ticks"])
            ),
            light_half_res=bool(backend_d.get("light_half_res", False)),
            adaptive_half_res=bool(backend_d.get("adaptive_half_res", True)),
            imu_noise=dict(backend_d.get("imu_noise", {})),
            tracker=dict(backend_d.get("tracker", {})),
        )
        syn_d = d.get("synthetic", {}) or {}
        synthetic = SyntheticConfig(
            enabled=bool(syn_d.get("enabled", False)),
            num_cameras=int(syn_d.get("num_cameras", 4)),
            resolution=tuple(syn_d.get("resolution", (640, 400))),
            baseline_m=float(syn_d.get("baseline_m", 0.075)),
            trajectory_radius=float(syn_d.get("trajectory_radius", 1.8)),
            room_half_extents=tuple(syn_d.get("room_half_extents", (5.0, 5.0, 2.5))),
            color_camera=bool(syn_d.get("color_camera", False)),
            color_resolution=(
                tuple(syn_d["color_resolution"]) if syn_d.get("color_resolution") else None
            ),
        )
        map_d = d.get("mapping", {}) or {}
        dims = tuple(int(x) for x in map_d.get("dims", (256, 256, 128)))
        if len(dims) != 3 or any(n < 8 for n in dims):
            raise ConfigError(f"mapping.dims must be three voxel counts >= 8, got {dims}")
        slice_band = tuple(float(x) for x in map_d.get("slice_band_m", (0.0, 1.0)))
        if len(slice_band) != 2 or slice_band[0] >= slice_band[1]:
            raise ConfigError(
                f"mapping.slice_band_m must be (lo, hi) with lo < hi, got {slice_band}"
            )
        slice_axis = int(map_d.get("slice_axis", 2))
        if slice_axis not in (0, 1, 2):
            raise ConfigError(f"mapping.slice_axis must be 0, 1 or 2, got {slice_axis}")
        mapping = MappingConfig(
            enabled=bool(map_d.get("enabled", False)),
            voxel_size_m=float(map_d.get("voxel_size_m", 0.05)),
            dims=dims,
            truncation_vox=float(map_d.get("truncation_vox", 4.0)),
            max_integration_distance_m=float(map_d.get("max_integration_distance_m", 10.0)),
            integrate_color=bool(map_d.get("integrate_color", True)),
            recenter_margin_m=float(map_d.get("recenter_margin_m", 2.0)),
            slice_axis=slice_axis,
            slice_band_m=slice_band,
            esdf_max_distance_m=float(map_d.get("esdf_max_distance_m", 2.0)),
            integrate_every=int(map_d.get("integrate_every", 1)),
        )
        return cls(
            cameras=cams,
            fps=float(d.get("fps", 30.0)),
            display=bool(d.get("display", False)),
            urdf_path=str(d.get("urdf_path", "") or ""),
            imu_report_rate=int(d.get("imu_report_rate", 400)),
            queue_size=int(d.get("queue_size", 8)),
            rig_queue_size=int(d.get("rig_queue_size", 10)),
            watchdog_timeout_s=(
                float(d["watchdog_timeout_s"])
                if d.get("watchdog_timeout_s") is not None
                else None
            ),
            nvblox_cameras=[str(x) for x in d.get("nvblox_cameras", []) or []],
            backend=backend,
            synthetic=synthetic,
            mapping=mapping,
        )


def load_config(path: str | Path) -> RunConfig:
    """Load a RunConfig from a YAML file.

    Raises:
        ConfigError: On malformed YAML or invalid field values, with the
            offending file and field in the message (no raw tracebacks for
            operator typos), or when PyYAML is not installed.
    """
    try:
        import yaml
    except ImportError as e:
        raise ConfigError(f"{path}: reading a YAML config needs PyYAML (pip install pyyaml)") from e
    try:
        with open(path) as f:
            data = yaml.safe_load(f) or {}
    except yaml.YAMLError as e:
        raise ConfigError(f"{path}: not valid YAML: {e}") from e
    if not isinstance(data, dict):
        raise ConfigError(f"{path}: top level must be a mapping, got {type(data).__name__}")
    try:
        return RunConfig.from_dict(data)
    except ConfigError as e:
        raise ConfigError(f"{path}: {e}") from e
    except (KeyError, ValueError, TypeError) as e:
        raise ConfigError(f"{path}: invalid config value: {e}") from e
