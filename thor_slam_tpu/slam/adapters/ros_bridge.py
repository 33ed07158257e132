"""Optional ROS 2 edge: export SLAM results to the ROS ecosystem.

The reference's adapter republishes *inputs* to an external CUDA solver
(reference isaac_ros.py). With SLAM computed in-process on the accelerator, the ROS
edge inverts: it publishes our *outputs* — odometry on
``/visual_slam/tracking/odometry`` (the reference's topic, so downstream
consumers like nvblox/RViz/publish_odom_tf work unchanged), TF, and the
RGB-D product streams in the nvblox format (rgb + 16UC1 depth +
CameraInfo, reference run_pipeline.py:193-256).

Poses are converted RDF-world -> FLU base_link with the same basis change
the reference applies (reference isaac_ros.py:42-49). Everything is gated
on rclpy; the core stack has no ROS dependency.
"""

from __future__ import annotations

import logging

import numpy as np

from thor_slam_tpu import geometry
from thor_slam_tpu.pipeline.rgbd import RGBDFrame
from thor_slam_tpu.slam.interface import SlamPose

logger = logging.getLogger(__name__)

try:  # pragma: no cover - ROS stack
    import rclpy
    from builtin_interfaces.msg import Time as RosTime
    from geometry_msgs.msg import TransformStamped
    from nav_msgs.msg import Odometry
    from rclpy.node import Node
    from sensor_msgs.msg import CameraInfo, Image, PointCloud2, PointField
    from tf2_ros import TransformBroadcaster

    HAVE_ROS = True
except ImportError:
    HAVE_ROS = False


def _ros_time(ts: float):  # pragma: no cover - ROS stack
    t = RosTime()
    t.sec = int(ts)
    t.nanosec = int((ts - int(ts)) * 1e9)
    return t


def pack_xyz_cloud(points: np.ndarray) -> tuple[bytes, int, int]:
    """Pack an (N, 3) array into PointCloud2 wire format.

    RDF-world points are converted to the FLU world the ROS side uses
    (same basis change as poses). Returns ``(data, point_step, count)``
    for an unordered float32 xyz cloud — the layout cuVSLAM publishes on
    its vis topics. Pure function (no ROS imports) so the packing is
    unit-testable without rclpy.
    """
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    pts = pts @ geometry.FLU_FROM_RDF[:3, :3].T
    return pts.astype(np.float32).tobytes(), 12, pts.shape[0]


def pack_xyzrgb_cloud(points: np.ndarray, colors: np.ndarray) -> tuple[bytes, int, int]:
    """Pack (N, 3) points + (N, 3) uint8 colors into PointCloud2 format.

    Same RDF->FLU basis change as :func:`pack_xyz_cloud`, plus the
    PCL-style packed-float rgb field (r<<16|g<<8|b bit-cast to f32).
    Pure function (no ROS imports) so the packing is unit-testable.
    """
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    pts = (pts @ geometry.FLU_FROM_RDF[:3, :3].T).astype(np.float32)
    c = np.asarray(colors, np.uint32).reshape(-1, 3)
    rgb_u32 = (c[:, 0] << 16) | (c[:, 1] << 8) | c[:, 2]
    rgb_f32 = rgb_u32.astype(np.uint32).view(np.float32)
    rec = np.empty((pts.shape[0], 4), np.float32)
    rec[:, :3] = pts
    rec[:, 3] = rgb_f32
    return rec.tobytes(), 16, pts.shape[0]


class RosBridge:  # pragma: no cover - ROS stack
    """Publishes SlamPose / RGBDFrame objects as ROS 2 messages."""

    def __init__(self, node_name: str = "thor_slam_tpu_bridge", odom_frame: str = "odom") -> None:
        """``odom_frame`` is the frame of the SMOOTH odometry stream; loop
        corrections arrive as the separate map->odom transform
        (:meth:`publish_map_tf`), completing map -> odom -> base_link."""
        if not HAVE_ROS:
            raise ImportError("rclpy is not installed; the ROS edge is unavailable")
        if not rclpy.ok():
            rclpy.init()
        self._node: Node = rclpy.create_node(node_name)
        self._odom_frame = odom_frame
        self._odom_pub = self._node.create_publisher(
            Odometry, "/visual_slam/tracking/odometry", 10
        )
        self._tf = TransformBroadcaster(self._node)
        self._rgbd_pubs: dict[str, tuple] = {}
        # The reference's RViz layout displays cuVSLAM's landmark /
        # observation clouds (reference config/thor_visual_slam.rviz:78,
        # 110); ours come from the in-process engine instead.
        self._landmarks_pub = self._node.create_publisher(
            PointCloud2, "/visual_slam/vis/landmarks_cloud", 2
        )
        self._observations_pub = self._node.create_publisher(
            PointCloud2, "/visual_slam/vis/observations_cloud", 2
        )

    def publish_pose(self, pose: SlamPose) -> None:
        """Odometry + TF in FLU (converted from our RDF-consistent world)."""
        m = pose.to_4x4_matrix()
        m_flu = geometry.FLU_FROM_RDF @ m @ geometry.RDF_FROM_FLU
        pos = m_flu[:3, 3]
        quat = geometry.matrix_to_quat(m_flu[:3, :3])

        msg = Odometry()
        msg.header.stamp = _ros_time(pose.timestamp)
        msg.header.frame_id = self._odom_frame
        msg.child_frame_id = "base_link"
        msg.pose.pose.position.x, msg.pose.pose.position.y, msg.pose.pose.position.z = pos
        (msg.pose.pose.orientation.x, msg.pose.pose.orientation.y,
         msg.pose.pose.orientation.z, msg.pose.pose.orientation.w) = quat
        if pose.covariance is not None:
            # The covariance rides the same world-frame change of basis as
            # the pose (block-diagonal rotation of the 6x6).
            cov = geometry.rotate_cov6(geometry.FLU_FROM_RDF[:3, :3], pose.covariance)
            msg.pose.covariance = list(cov.reshape(-1))
        self._odom_pub.publish(msg)

        tf = TransformStamped()
        tf.header = msg.header
        tf.child_frame_id = "base_link"
        tf.transform.translation.x, tf.transform.translation.y, tf.transform.translation.z = pos
        (tf.transform.rotation.x, tf.transform.rotation.y,
         tf.transform.rotation.z, tf.transform.rotation.w) = quat
        self._tf.sendTransform(tf)

    def publish_map_tf(self, map_t_odom, timestamp: float = 0.0) -> None:
        """Broadcast map->odom (the loop-closure correction frame).

        Completes the reference's TF tree: map -> odom -> base_link, where
        odom carries smooth VO and map->odom absorbs loop corrections
        (reference scripts/publish_odom_tf.py:35-99 derives the same
        transform on the consumer side).
        """
        m = geometry.FLU_FROM_RDF @ np.asarray(map_t_odom, np.float64) @ geometry.RDF_FROM_FLU
        quat = geometry.matrix_to_quat(m[:3, :3])
        tf = TransformStamped()
        tf.header.stamp = _ros_time(timestamp)
        tf.header.frame_id = "map"
        tf.child_frame_id = self._odom_frame
        tf.transform.translation.x, tf.transform.translation.y, tf.transform.translation.z = m[:3, 3]
        (tf.transform.rotation.x, tf.transform.rotation.y,
         tf.transform.rotation.z, tf.transform.rotation.w) = quat
        self._tf.sendTransform(tf)

    def _publish_cloud(self, pub, points: np.ndarray, timestamp: float) -> None:
        data, step, count = pack_xyz_cloud(points)
        msg = PointCloud2()
        msg.header.stamp = _ros_time(timestamp)
        msg.header.frame_id = "map"
        msg.height = 1
        msg.width = count
        msg.fields = [
            PointField(name=n, offset=4 * i, datatype=PointField.FLOAT32, count=1)
            for i, n in enumerate("xyz")
        ]
        msg.is_bigendian = False
        msg.point_step = step
        msg.row_step = step * count
        msg.is_dense = True
        msg.data = data
        pub.publish(msg)

    def publish_landmarks(self, points: np.ndarray, timestamp: float) -> None:
        """Accumulated sparse map on ``/visual_slam/vis/landmarks_cloud``
        (feed with :meth:`TpuSlamEngine.get_landmark_cloud`)."""
        self._publish_cloud(self._landmarks_pub, points, timestamp)

    def publish_observations(self, points: np.ndarray, timestamp: float) -> None:
        """Currently tracked landmarks on
        ``/visual_slam/vis/observations_cloud`` (feed with
        ``engine.get_map().to_point_cloud()``)."""
        self._publish_cloud(self._observations_pub, points, timestamp)

    def publish_surface_cloud(
        self, points: np.ndarray, colors: np.ndarray, timestamp: float
    ) -> None:
        """Dense-mapper surface on ``/mapper/surface`` (xyz+rgb cloud).

        The nvblox-node output role. Published in the ODOM frame — the
        mapper integrates there (like the reference's nvblox
        ``global_frame: odom`` default); rviz places it via map->odom TF.
        """
        if not hasattr(self, "_surface_pub"):
            self._surface_pub = self._node.create_publisher(
                PointCloud2, "/mapper/surface", 2
            )
        data, step, count = pack_xyzrgb_cloud(points, colors)
        msg = PointCloud2()
        msg.header.stamp = _ros_time(timestamp)
        msg.header.frame_id = self._odom_frame
        msg.height = 1
        msg.width = count
        msg.fields = [
            PointField(name=n, offset=4 * i, datatype=PointField.FLOAT32, count=1)
            for i, n in enumerate("xyz")
        ] + [PointField(name="rgb", offset=12, datatype=PointField.FLOAT32, count=1)]
        msg.is_bigendian = False
        msg.point_step = step
        msg.row_step = step * count
        msg.is_dense = True
        msg.data = data
        self._surface_pub.publish(msg)

    def publish_mesh_marker(self, mesh, timestamp: float) -> None:
        """Surface-Nets mesh as a TRIANGLE_LIST marker on ``/mapper/mesh``.

        The NvbloxMesh-display role (config/nvblox.rviz) without the
        nvblox_msgs dependency: any stock rviz renders Marker triangles.
        """
        from geometry_msgs.msg import Point
        from std_msgs.msg import ColorRGBA
        from visualization_msgs.msg import Marker

        if not hasattr(self, "_mesh_pub"):
            self._mesh_pub = self._node.create_publisher(Marker, "/mapper/mesh", 1)
        m = Marker()
        m.header.stamp = _ros_time(timestamp)
        m.header.frame_id = self._odom_frame
        m.ns = "mapper"
        m.type = Marker.TRIANGLE_LIST
        m.action = Marker.ADD
        m.pose.orientation.w = 1.0
        m.scale.x = m.scale.y = m.scale.z = 1.0
        verts_flu = (
            np.asarray(mesh.vertices, np.float64) @ geometry.FLU_FROM_RDF[:3, :3].T
        )
        cols = np.asarray(mesh.colors, np.float64) / 255.0
        for tri in mesh.triangles:
            for vi in tri:
                p = Point()
                p.x, p.y, p.z = verts_flu[vi]
                m.points.append(p)
                c = ColorRGBA()
                c.r, c.g, c.b, c.a = (*cols[vi], 1.0)
                m.colors.append(c)
        self._mesh_pub.publish(m)

    def publish_rgbd(self, index: int, frame: RGBDFrame) -> None:
        """nvblox feed: /camera_{i}/{rgb,depth}/{image_raw,camera_info}."""
        if index not in self._rgbd_pubs:
            base = f"/camera_{index}"
            self._rgbd_pubs[index] = (
                self._node.create_publisher(Image, f"{base}/rgb/image_raw", 5),
                self._node.create_publisher(CameraInfo, f"{base}/rgb/camera_info", 5),
                self._node.create_publisher(Image, f"{base}/depth/image_raw", 5),
                self._node.create_publisher(CameraInfo, f"{base}/depth/camera_info", 5),
            )
        rgb_pub, rgb_info_pub, depth_pub, depth_info_pub = self._rgbd_pubs[index]
        stamp = _ros_time(frame.timestamp)
        frame_id = f"camera_{index}_optical"

        rgb = Image()
        rgb.header.stamp = stamp
        rgb.header.frame_id = frame_id
        rgb.height, rgb.width = frame.rgb.shape[:2]
        if frame.rgb.ndim == 2:
            rgb.encoding = "mono8"
            rgb.step = rgb.width
        else:
            rgb.encoding = "rgb8"
            rgb.step = rgb.width * 3
        rgb.data = frame.rgb.tobytes()
        rgb_pub.publish(rgb)

        depth = Image()
        depth.header = rgb.header
        depth.height, depth.width = frame.depth_mm.shape
        depth.encoding = "16UC1"  # millimeters (reference run_pipeline.py:247-252)
        depth.step = depth.width * 2
        depth.data = frame.depth_mm.tobytes()
        depth_pub.publish(depth)

        info = CameraInfo()
        info.header = rgb.header
        info.width = frame.intrinsics.width
        info.height = frame.intrinsics.height
        info.k = list(frame.intrinsics.matrix.reshape(-1))
        info.distortion_model = "plumb_bob"
        info.d = list(np.asarray(frame.intrinsics.coeffs).reshape(-1)[:5])
        p = np.zeros((3, 4))
        p[:3, :3] = frame.intrinsics.matrix
        info.p = list(p.reshape(-1))
        rgb_info_pub.publish(info)
        depth_info_pub.publish(info)

    def spin_once(self, timeout_sec: float = 0.0) -> None:
        rclpy.spin_once(self._node, timeout_sec=timeout_sec)

    def shutdown(self) -> None:
        self._node.destroy_node()
