"""ROS 2 launch: SLAM bridge + map->odom TF completion.

The role of the reference's launch/thor_visual_slam.launch.py — except the
SLAM core is this repo's in-process engine instead of a cuVSLAM
composable node, so the launch graph collapses to two plain processes:

* ``scripts.run_slam`` with ROS output enabled — tracks the rig on the GPU
  and publishes odometry on ``/visual_slam/tracking/odometry`` (the
  reference's topic, so downstream consumers are unchanged);
* ``scripts.publish_odom_tf`` — completes the TF tree with map->odom
  (reference scripts/publish_odom_tf.py:35-99).

The cuVSLAM tuning arguments the reference exposes (image jitter/sync
thresholds, IMU noise densities measured from a 2.5 h rosbag — reference
launch/thor_visual_slam.launch.py:76-104) map to engine config here: the
sync thresholds live in config/slam_config.yaml (rig queue settings) and
the IMU noise densities are this package's defaults in
``thor_slam_tpu.engine.imu`` (same measured values).

Usage: ros2 launch launch/thor_slam_tpu.launch.py [config:=path.yaml]
"""

from launch import LaunchDescription  # type: ignore[import-not-found]
from launch.actions import DeclareLaunchArgument, ExecuteProcess  # type: ignore[import-not-found]
from launch.substitutions import LaunchConfiguration  # type: ignore[import-not-found]


def generate_launch_description() -> LaunchDescription:
    config = LaunchConfiguration("config")
    return LaunchDescription(
        [
            DeclareLaunchArgument(
                "config",
                default_value="config/slam_config.yaml",
                description="Runtime YAML config (cameras, rig, backend)",
            ),
            ExecuteProcess(
                cmd=["python", "-m", "scripts.run_slam", "--config", config, "--ros"],
                name="thor_slam_tpu",
                output="screen",
            ),
            ExecuteProcess(
                cmd=["python", "-m", "scripts.publish_odom_tf"],
                name="odom_tf_publisher",
                output="screen",
            ),
        ]
    )
