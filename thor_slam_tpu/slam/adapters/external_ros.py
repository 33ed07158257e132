"""Input-side ROS 2 adapter: feed ANY external SLAM solver over DDS.

The reference's only concrete engine republishes synchronized frames +
calibration + IMU as ROS topics for NVIDIA's closed-source cuVSLAM and
reads the pose back (reference thor_slam/slam/adapters/isaac_ros.py:
59-458). This adapter reproduces that INPUT-side bridge so a robot
operator can A/B the in-process engine against cuVSLAM (or any DDS
solver) on identical synchronized frames — the only way the ATE-parity
north star gets a real-world number.

Topic contract (identical to the reference):
* publishes ``/visual_slam/image_{i}`` + ``/visual_slam/camera_info_{i}``
  per flattened camera, ``/visual_slam/imu`` (sensor QoS), static TF
  ``base_link -> camera_i -> camera_i_optical_frame`` (+ ``imu_link``);
* subscribes ``/visual_slam/tracking/odometry`` and caches the pose that
  :meth:`ExternalRosEngine.process_frames` returns (async, like the
  reference — reference isaac_ros.py:308-325).

All message-construction logic is in pure module functions (no rclpy /
cv_bridge / scipy / cv2 imports) so the wire format is unit-testable
with ROS absent; the class is a thin rclpy shell around them. Reference
quirks fixed rather than reproduced: images are packed without cv_bridge,
``shutdown`` destroys only this node (the reference's global
``rclpy.shutdown()`` kills every other node in the process, reference
isaac_ros.py:448-449), the timestamp split avoids the ``int(ts / 1)``
no-op (reference isaac_ros.py:348-349), and an IMU-only frame set cannot
hit an unbound ``stamp`` (reference isaac_ros.py:346-426).
"""

from __future__ import annotations

import logging
import threading

import numpy as np

from thor_slam_tpu import geometry
from thor_slam_tpu.camera.rig import RigCalibration
from thor_slam_tpu.camera.types import Extrinsics, SynchronizedFrameSet
from thor_slam_tpu.slam.interface import (
    CameraConfig,
    SlamConfig,
    SlamEngine,
    SlamMap,
    SlamPose,
    TrackingState,
)

logger = logging.getLogger(__name__)

try:  # pragma: no cover - ROS stack
    import rclpy
    from builtin_interfaces.msg import Time as RosTime
    from geometry_msgs.msg import TransformStamped
    from nav_msgs.msg import Odometry
    from rclpy.qos import qos_profile_sensor_data
    from sensor_msgs.msg import CameraInfo, Image, Imu
    from tf2_ros import StaticTransformBroadcaster

    HAVE_ROS = True
except ImportError:
    HAVE_ROS = False


# ---------------------------------------------------------------- pure logic


def extract_cameras(cal: RigCalibration, num_cameras: int) -> list[CameraConfig]:
    """Flatten calibration into per-imager configs, the reference way:
    sources sorted by name, world (rig-composed) extrinsics preferred,
    truncated at ``num_cameras`` (reference isaac_ros.py:138-157)."""
    cameras: list[CameraConfig] = []
    for source_name in sorted(cal.intrinsics.keys()):
        intrs = cal.intrinsics[source_name]
        exts = cal.get_world_extrinsics(source_name) or cal.extrinsics.get(source_name, [])
        for cam_idx, intr in enumerate(intrs):
            if len(cameras) >= num_cameras:
                return cameras
            ext = exts[cam_idx] if cam_idx < len(exts) else Extrinsics.identity()
            cameras.append(CameraConfig(intr, ext, source_name, cam_idx))
    return cameras


def split_stamp(ts: float) -> tuple[int, int]:
    """Float seconds -> (sec, nanosec), nanosec clamped into [0, 1e9)."""
    sec = int(ts)
    nsec = int(round((ts - sec) * 1e9))
    if nsec >= 1_000_000_000:
        sec, nsec = sec + 1, nsec - 1_000_000_000
    return sec, max(0, nsec)


def image_wire(img: np.ndarray) -> tuple[str, int, int, int, bytes]:
    """Pack an image for a sensor_msgs/Image without cv_bridge.

    Returns (encoding, height, width, step, data). 2-D uint8 -> mono8;
    3-channel uint8 -> rgb8 with the BGR -> RGB channel swap the
    reference applies (DepthAI ISP color is BGR; cuVSLAM expects rgb8,
    reference isaac_ros.py:355-358).
    """
    a = np.ascontiguousarray(img)
    if a.dtype != np.uint8:
        # Float frames are [0, 1] everywhere in this package (the
        # engine's own convention); integer non-uint8 frames are
        # already on the 0-255 scale.
        if np.issubdtype(a.dtype, np.floating):
            a = a * 255.0
        a = np.clip(a, 0, 255).astype(np.uint8)
    if a.ndim == 2:
        return "mono8", a.shape[0], a.shape[1], a.shape[1], a.tobytes()
    if a.ndim == 3 and a.shape[2] == 3:
        rgb = np.ascontiguousarray(a[..., ::-1])
        return "rgb8", a.shape[0], a.shape[1], a.shape[1] * 3, rgb.tobytes()
    raise ValueError(f"unsupported image shape {a.shape}")


def distortion_wire(coeffs: np.ndarray) -> tuple[str, list[float]]:
    """CameraInfo distortion model selected by coefficient count — the
    reference's dispatch (reference isaac_ros.py:372-383)."""
    d = [float(v) for v in np.asarray(coeffs).flatten()]
    if len(d) >= 8:
        return "rational_polynomial", d[:8]  # k1 k2 p1 p2 k3 k4 k5 k6
    if len(d) == 5:
        return "plumb_bob", d
    if len(d) == 4:
        return "equidistant", d
    return "plumb_bob", (d + [0.0] * 5)[:5]


def projection_matrix(cameras: list[CameraConfig], i: int) -> np.ndarray:
    """3x4 P for camera ``i``; right imagers of a stereo pair get
    ``P[0, 3] = -fx * baseline`` with the baseline measured in the LEFT
    camera's frame (ROS stereo convention; reference isaac_ros.py:389-410).
    """
    cam = cameras[i]
    p = np.zeros((3, 4))
    p[:3, :3] = cam.intrinsics.matrix
    if cam.cam_idx == 1 and i > 0 and cameras[i - 1].source_name == cam.source_name:
        left = cameras[i - 1]
        t_lr = left.extrinsics.rotation.T @ (
            cam.extrinsics.translation - left.extrinsics.translation
        )
        p[0, 3] = -float(cam.intrinsics.matrix[0, 0]) * float(t_lr[0])
    return p


#: camera_i (FLU) -> camera_i_optical_frame (RDF) rotation, as the
#: xyzw quaternion the reference broadcasts (reference isaac_ros.py:200-216).
OPTICAL_FROM_CAMERA_QUAT = geometry.matrix_to_quat(geometry.RDF_FROM_FLU[:3, :3])


def camera_tf_list(cameras: list[CameraConfig]) -> list[dict]:
    """Static-TF payload: per camera, base_link -> camera_i (the world
    extrinsic) and camera_i -> optical frame (FLU -> RDF). Pure dicts so
    the math is testable without tf2."""
    out = []
    for i, cam in enumerate(cameras):
        out.append(
            {
                "parent": "base_link",
                "child": f"camera_{i}",
                "translation": np.asarray(cam.extrinsics.translation, np.float64),
                "quat_xyzw": geometry.matrix_to_quat(cam.extrinsics.rotation),
            }
        )
        out.append(
            {
                "parent": f"camera_{i}",
                "child": f"camera_{i}_optical_frame",
                "translation": np.zeros(3),
                "quat_xyzw": OPTICAL_FROM_CAMERA_QUAT.copy(),
            }
        )
    return out


def latest_imu_sample(sensor_data: dict) -> tuple[np.ndarray, np.ndarray] | None:
    """(accel, gyro) of the NEWEST sample; accepts the driver's batched
    arrays or a single-sample dict."""
    acc = sensor_data.get("accelerometer")
    gyr = sensor_data.get("gyroscope")
    if acc is None or gyr is None:
        return None
    acc = np.asarray(acc, np.float64)
    gyr = np.asarray(gyr, np.float64)
    if acc.ndim == 2:
        if acc.shape[0] == 0:
            return None
        acc, gyr = acc[-1], gyr[-1]
    if acc.shape[-1] < 3 or gyr.shape[-1] < 3:
        return None
    return acc[:3], gyr[:3]


# ------------------------------------------------------------------ adapter


class ExternalRosEngine(SlamEngine):  # pragma: no cover - ROS shell; logic above
    """SlamEngine that delegates to an external DDS solver (cuVSLAM-shaped).

    Args:
        num_cameras: Flattened imager count to publish (the reference's
            num_cameras = 2 per stereo + 1 per mono source).
        queue_size: Publisher queue depth (reference IsaacRosConfig).
        namespace: Topic namespace (default the reference's /visual_slam).
    """

    def __init__(
        self,
        num_cameras: int = 2,
        queue_size: int = 10,
        namespace: str = "/visual_slam",
    ) -> None:
        if not HAVE_ROS:
            raise ImportError("rclpy is not installed; ExternalRosEngine is unavailable")
        self._num_cameras = num_cameras
        self._ns = namespace.rstrip("/")
        self._queue_size = queue_size
        self._cameras: list[CameraConfig] = []
        self._calibration: RigCalibration | None = None
        self._node = None
        self._spin_thread: threading.Thread | None = None
        self._spin_stop = threading.Event()
        self._image_pubs: list = []
        self._info_pubs: list = []
        self._imu_pub = None
        self._latest_pose: SlamPose | None = None
        self._pose_lock = threading.Lock()
        self._state = TrackingState.NOT_INITIALIZED

    # ------------------------------------------------------------- lifecycle

    def initialize(self, calibration: RigCalibration, config: SlamConfig | None = None) -> None:
        self._calibration = calibration
        if config is not None:
            self._num_cameras = config.num_cameras
        self._cameras = extract_cameras(calibration, self._num_cameras)
        if len(self._cameras) < self._num_cameras:
            logger.warning(
                "calibration provides %d imagers, expected %d",
                len(self._cameras), self._num_cameras,
            )
        if not rclpy.ok():
            rclpy.init()
        # Re-initialization after shutdown(): the old node's publisher
        # handles are dead — start from empty lists.
        self._image_pubs = []
        self._info_pubs = []
        self._node = rclpy.create_node("thor_slam_tpu_external_bridge")
        for i in range(len(self._cameras)):
            self._image_pubs.append(
                self._node.create_publisher(Image, f"{self._ns}/image_{i}", self._queue_size)
            )
            self._info_pubs.append(
                self._node.create_publisher(
                    CameraInfo, f"{self._ns}/camera_info_{i}", self._queue_size
                )
            )
        self._imu_pub = self._node.create_publisher(
            Imu, f"{self._ns}/imu", qos_profile_sensor_data
        )
        self._node.create_subscription(
            Odometry, f"{self._ns}/tracking/odometry", self._odom_cb, 10
        )
        self._broadcast_static_tf()
        node = self._node
        self._spin_stop.clear()
        stop = self._spin_stop

        def _spin() -> None:
            # spin_once under a stop flag (not rclpy.spin): shutdown()
            # destroys the node, and spinning a destroyed node raises in
            # this daemon thread.
            while not stop.is_set() and rclpy.ok():
                rclpy.spin_once(node, timeout_sec=0.1)

        self._spin_thread = threading.Thread(target=_spin, daemon=True)
        self._spin_thread.start()
        self._state = TrackingState.INITIALIZING

    def _broadcast_static_tf(self) -> None:
        tf = StaticTransformBroadcaster(self._node)
        stamp = self._node.get_clock().now().to_msg()
        entries = camera_tf_list(self._cameras)
        imu_ext = self._calibration.imu_extrinsics
        if imu_ext is not None:
            e = imu_ext.extrinsics
            entries.append(
                {
                    "parent": "base_link",
                    "child": "imu_link",
                    "translation": np.asarray(e.translation, np.float64),
                    "quat_xyzw": geometry.matrix_to_quat(e.rotation),
                }
            )
        msgs = []
        for e in entries:
            t = TransformStamped()
            t.header.stamp = stamp
            t.header.frame_id = e["parent"]
            t.child_frame_id = e["child"]
            tr, q = e["translation"], e["quat_xyzw"]
            t.transform.translation.x = float(tr[0])
            t.transform.translation.y = float(tr[1])
            t.transform.translation.z = float(tr[2])
            t.transform.rotation.x = float(q[0])
            t.transform.rotation.y = float(q[1])
            t.transform.rotation.z = float(q[2])
            t.transform.rotation.w = float(q[3])
            msgs.append(t)
        tf.sendTransform(msgs)
        self._static_tf = tf  # keep alive (latched topic)

    # ---------------------------------------------------------------- frames

    def process_frames(self, frame_set: SynchronizedFrameSet) -> SlamPose | None:
        if self._node is None:
            raise RuntimeError("Not initialized")
        for i, cam in enumerate(self._cameras):
            fs = frame_set.frame_sets.get(cam.source_name)
            if fs is None or cam.cam_idx >= len(fs.frames):
                continue
            frame = fs.frames[cam.cam_idx]
            sec, nsec = split_stamp(frame.timestamp)
            stamp = RosTime(sec=sec, nanosec=nsec)
            frame_id = f"camera_{i}"

            enc, h, w, step, data = image_wire(frame.image)
            msg = Image()
            msg.header.stamp = stamp
            msg.header.frame_id = frame_id
            msg.height, msg.width = h, w
            msg.encoding = enc
            msg.is_bigendian = 0
            msg.step = step
            msg.data = data
            self._image_pubs[i].publish(msg)

            info = CameraInfo()
            info.header.stamp = stamp
            info.header.frame_id = frame_id
            info.width = cam.intrinsics.width
            info.height = cam.intrinsics.height
            model, d = distortion_wire(cam.intrinsics.coeffs)
            info.distortion_model = model
            info.d = d
            info.k = cam.intrinsics.matrix.flatten().tolist()
            info.r = np.eye(3).flatten().tolist()
            info.p = projection_matrix(self._cameras, i).flatten().tolist()
            self._info_pubs[i].publish(info)

        if frame_set.sensor_data is not None and self._imu_pub is not None:
            sample = latest_imu_sample(frame_set.sensor_data)
            if sample is not None:
                acc, gyr = sample
                ts = frame_set.sensor_timestamp
                sec, nsec = split_stamp(ts if ts is not None else frame_set.timestamp)
                imu = Imu()
                imu.header.stamp = RosTime(sec=sec, nanosec=nsec)
                imu.header.frame_id = "imu_link"
                imu.linear_acceleration.x = float(acc[0])
                imu.linear_acceleration.y = float(acc[1])
                imu.linear_acceleration.z = float(acc[2])
                imu.angular_velocity.x = float(gyr[0])
                imu.angular_velocity.y = float(gyr[1])
                imu.angular_velocity.z = float(gyr[2])
                imu.linear_acceleration_covariance[0] = -1.0  # unknown
                imu.angular_velocity_covariance[0] = -1.0
                self._imu_pub.publish(imu)

        with self._pose_lock:
            return self._latest_pose

    def _odom_cb(self, msg) -> None:
        p = msg.pose.pose
        cov = np.array(msg.pose.covariance).reshape(6, 6)
        conf = max(0.0, min(1.0, 1.0 / (1.0 + float(np.trace(cov[:3, :3])))))
        with self._pose_lock:
            self._latest_pose = SlamPose(
                position=np.array([p.position.x, p.position.y, p.position.z]),
                rotation=np.array(
                    [p.orientation.x, p.orientation.y, p.orientation.z, p.orientation.w]
                ),
                timestamp=msg.header.stamp.sec + msg.header.stamp.nanosec * 1e-9,
                tracking_state=TrackingState.TRACKING,
                confidence=conf,
                covariance=cov,
            )
            if self._state == TrackingState.INITIALIZING:
                self._state = TrackingState.TRACKING

    # ------------------------------------------------------------- contract

    def get_tracking_state(self) -> TrackingState:
        return self._state

    def get_map(self) -> SlamMap:
        return SlamMap()  # the external solver owns the map (as the reference)

    def reset(self) -> None:
        with self._pose_lock:
            self._latest_pose = None
        self._state = TrackingState.INITIALIZING if self._node else TrackingState.NOT_INITIALIZED

    def shutdown(self) -> None:
        # Destroy ONLY this node: the reference's global rclpy.shutdown()
        # here kills every other node in the process (ref isaac_ros.py:448).
        self._spin_stop.set()
        if self._spin_thread is not None:
            self._spin_thread.join(timeout=2.0)
            self._spin_thread = None
        if self._node is not None:
            self._node.destroy_node()
            self._node = None
        self._state = TrackingState.NOT_INITIALIZED
