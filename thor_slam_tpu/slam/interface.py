"""Engine-agnostic SLAM contract.

API-compatible with the reference's ``thor_slam.slam.interface``
(reference: thor_slam/slam/interface.py:16-270). Quaternions are xyzw
(scalar-last). Rotation math uses :mod:`thor_slam_tpu.geometry` rather than
scipy so the core package has no scipy dependency.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from enum import Enum, auto
from types import TracebackType
from typing import Self

import numpy as np

from thor_slam_tpu import geometry
from thor_slam_tpu.camera.rig import RigCalibration
from thor_slam_tpu.camera.types import Extrinsics, Intrinsics, SynchronizedFrameSet


class TrackingState(Enum):
    """Lifecycle state of the tracker."""

    NOT_INITIALIZED = auto()
    INITIALIZING = auto()
    TRACKING = auto()
    LOST = auto()
    RELOCALIZING = auto()


@dataclass
class CameraConfig:
    """Flattened per-imager calibration handed to engines at initialize()."""

    intrinsics: Intrinsics
    extrinsics: Extrinsics
    source_name: str
    cam_idx: int


@dataclass
class SlamPose:
    """A pose estimate in the world frame.

    Attributes:
        position: [x, y, z] translation in meters.
        rotation: [qx, qy, qz, qw] unit quaternion (scalar-last).
        timestamp: Estimate time in seconds.
        tracking_state: Tracker state when this estimate was produced.
        confidence: Score in [0, 1]; 1 is most confident.
        covariance: Optional 6x6 covariance (translation block first).
    """

    position: np.ndarray
    rotation: np.ndarray
    timestamp: float
    tracking_state: TrackingState = TrackingState.TRACKING
    confidence: float = 1.0
    covariance: np.ndarray | None = None

    def to_4x4_matrix(self) -> np.ndarray:
        """As world_T_camera, a 4x4 homogeneous matrix."""
        return geometry.se3_from_pose(self.position, self.rotation)

    @classmethod
    def from_4x4_matrix(
        cls,
        matrix: np.ndarray,
        timestamp: float,
        tracking_state: TrackingState = TrackingState.TRACKING,
        confidence: float = 1.0,
    ) -> Self:
        """Build from a 4x4 homogeneous world_T_camera matrix."""
        position, rotation = geometry.pose_from_se3(np.asarray(matrix, dtype=np.float64))
        return cls(
            position=position,
            rotation=rotation,
            timestamp=timestamp,
            tracking_state=tracking_state,
            confidence=confidence,
        )

    @classmethod
    def identity(cls, timestamp: float = 0.0) -> Self:
        """Origin pose with identity orientation."""
        return cls(position=np.zeros(3), rotation=geometry.quat_identity(), timestamp=timestamp)


@dataclass
class MapPoint:
    """One landmark in the sparse map."""

    position: np.ndarray
    color: np.ndarray | None = None
    normal: np.ndarray | None = None
    observations: int = 1


@dataclass
class SlamMap:
    """Sparse map snapshot: landmarks plus keyframe poses."""

    points: list[MapPoint] = field(default_factory=list)
    keyframe_poses: list[SlamPose] = field(default_factory=list)
    timestamp: float = 0.0

    def to_point_cloud(self) -> np.ndarray:
        """Landmark positions as an Nx3 array (empty -> shape (0, 3))."""
        if not self.points:
            return np.empty((0, 3))
        return np.stack([p.position for p in self.points])


@dataclass
class SlamConfig:
    """Common engine configuration; engines extend with their own fields."""

    num_cameras: int = 2
    rectified_images: bool = True
    enable_loop_closure: bool = True
    enable_mapping: bool = True
    max_map_size: int = 100000
    expected_fps: float = 30.0


class SlamEngine(ABC):
    """Base class every SLAM engine implements.

    Usable as a context manager; ``__exit__`` calls :meth:`shutdown`.
    """

    @abstractmethod
    def initialize(self, calibration: RigCalibration, config: SlamConfig | None = None) -> None:
        """Prepare the engine with rig calibration; must precede process_frames().

        Accelerator engines precompute rectification maps and warm up jit caches here.

        Raises:
            RuntimeError: If the engine cannot be brought up.
        """

    @abstractmethod
    def process_frames(self, frame_set: SynchronizedFrameSet) -> SlamPose | None:
        """Consume one synchronized frame set; return the pose estimate or None."""

    @abstractmethod
    def get_tracking_state(self) -> TrackingState:
        """Current tracker state."""

    @abstractmethod
    def get_map(self) -> SlamMap:
        """Snapshot of the current sparse map."""

    @abstractmethod
    def reset(self) -> None:
        """Clear map and tracking state, keeping calibration."""

    @abstractmethod
    def shutdown(self) -> None:
        """Release all engine resources."""

    def save_map(self, path: str) -> bool:
        """Persist the map to ``path``; returns success."""
        raise NotImplementedError("This SLAM engine does not support map saving")

    def load_map(self, path: str) -> bool:
        """Load a previously saved map from ``path``; returns success."""
        raise NotImplementedError("This SLAM engine does not support map loading")

    def relocalize(self) -> bool:
        """Try to relocalize against a loaded map; returns success."""
        raise NotImplementedError("This SLAM engine does not support relocalization")

    def __enter__(self) -> Self:
        return self

    def __exit__(
        self,
        exc_type: type[BaseException] | None,
        exc_val: BaseException | None,
        exc_tb: TracebackType | None,
    ) -> None:
        self.shutdown()
