"""The SLAM engine: the from-scratch replacement for cuVSLAM.

Implements visual odometry, IMU preintegration, sliding-window bundle
adjustment, keyframing, loop closure and pose-graph optimization as
jit-compiled JAX — everything the reference delegates to the closed-source
``isaac_ros_visual_slam`` CUDA node (reference
launch/thor_visual_slam.launch.py:30-64).
"""


def __getattr__(name: str):
    # Lazy re-export: ``from thor_slam_tpu.engine import TpuSlamEngine``
    # without importing jax at package-import time (the host layer stays
    # import-fast; the engine pulls the device stack only when used).
    if name == "TpuSlamEngine":
        from thor_slam_tpu.engine.tpu_engine import TpuSlamEngine

        return TpuSlamEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
