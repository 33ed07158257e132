"""thor_slam_tpu — multi-camera visual SLAM framework in JAX.

A from-scratch rebuild of the capabilities of WT-MM/thor-slam, with the
hot path on one accelerator:

* The acquisition / synchronization / calibration layer keeps the reference's
  public API (``CameraSource``, ``CameraRig``, ``RigCalibration``,
  ``SlamEngine``, ``SlamPose``, ``SlamMap``, ``TrackingState``,
  ``SynchronizedFrameSet``) so drivers and launch scripts swap in unchanged
  (reference: thor_slam/camera/types.py, thor_slam/slam/interface.py).
* Everything the reference delegates to CUDA / camera ASICs / ROS
  (cuVSLAM visual odometry, StereoDepth, nvblox's RGB-D feed) is implemented
  here as JAX/XLA/Pallas compute: rectification, FAST/ORB features, Hamming
  matching, stereo depth, PnP-RANSAC, IMU preintegration, sliding-window
  bundle adjustment, loop closure and pose-graph optimization.
"""

__version__ = "0.1.0"

from thor_slam_tpu.camera.rig import CameraRig, RigCalibration
from thor_slam_tpu.camera.types import (
    CameraFrame,
    CameraSource,
    Extrinsics,
    FrameSet,
    IMUData,
    IMUExtrinsics,
    Intrinsics,
    IPv4,
    SensorData,
    SynchronizedFrameSet,
)
from thor_slam_tpu.slam.interface import (
    CameraConfig,
    MapPoint,
    SlamConfig,
    SlamEngine,
    SlamMap,
    SlamPose,
    TrackingState,
)

__all__ = [
    "CameraFrame",
    "CameraConfig",
    "CameraRig",
    "CameraSource",
    "Extrinsics",
    "FrameSet",
    "IMUData",
    "IMUExtrinsics",
    "IPv4",
    "Intrinsics",
    "MapPoint",
    "RigCalibration",
    "SensorData",
    "SlamConfig",
    "SlamEngine",
    "SlamMap",
    "SlamPose",
    "SynchronizedFrameSet",
    "TrackingState",
]
