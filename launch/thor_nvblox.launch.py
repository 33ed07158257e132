"""ROS 2 launch: nvblox reconstruction fed by this framework's RGB-D streams.

The twin of the reference's launch/thor_nvblox.launch.py: starts the nvblox
node with the same mapping parameters (voxel_size 0.05 m, TSDF max
integration distance 10 m, truncation 4 voxels — reference
launch/thor_nvblox.launch.py:26-36, Makefile nvblox-launch target) and
remaps its inputs to the topics ``scripts.run_pipeline --ros`` publishes:
``/camera_0/{rgb,depth}/{image_raw,camera_info}`` (nvblox expects
``color``; the reference performs the same rgb->color remapping,
reference launch/thor_nvblox.launch.py:53-59).

nvblox itself is an external CUDA package; this launch exists for parity
when nvblox sits on the ROS graph. Otherwise skip it:
``run_pipeline --map`` runs the in-process dense mapper with
the same parameters (``thor_slam_tpu/mapping/``), publishing its surface
cloud and mesh on ``/mapper/{surface,mesh}`` instead.

Usage: ros2 launch launch/thor_nvblox.launch.py [num_cameras:=1]
"""

from launch import LaunchDescription  # type: ignore[import-not-found]
from launch.actions import DeclareLaunchArgument  # type: ignore[import-not-found]
from launch.substitutions import LaunchConfiguration  # type: ignore[import-not-found]
from launch_ros.actions import Node  # type: ignore[import-not-found]


def generate_launch_description() -> LaunchDescription:
    return LaunchDescription(
        [
            DeclareLaunchArgument("global_frame", default_value="map"),
            Node(
                package="nvblox_ros",
                executable="nvblox_node",
                name="nvblox_node",
                output="screen",
                parameters=[
                    {
                        "global_frame": LaunchConfiguration("global_frame"),
                        "voxel_size": 0.05,
                        "num_cameras": 1,
                        "use_tf_transforms": True,
                        "projective_integrator_max_integration_distance_m": 10.0,
                        "projective_integrator_truncation_distance_vox": 4.0,
                        "max_back_projection_distance": 10.0,
                        "esdf_mode": 1,  # 3D ESDF
                    }
                ],
                remappings=[
                    ("camera_0/color/image", "/camera_0/rgb/image_raw"),
                    ("camera_0/color/camera_info", "/camera_0/rgb/camera_info"),
                    ("camera_0/depth/image", "/camera_0/depth/image_raw"),
                    ("camera_0/depth/camera_info", "/camera_0/depth/camera_info"),
                ],
            ),
        ]
    )
