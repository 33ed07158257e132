"""Multi-camera rig: frame/IMU synchronization and calibration composition.

Reproduces the reference's synchronization semantics exactly
(reference: thor_slam/camera/rig.py:358-415 — slowest-camera reference
timestamp, per-queue closest match, closest IMU sample, ``max_time_delta``
quality metric) while fixing its known quirks:

* polling is non-blocking by default (the reference serially calls the
  *blocking* ``get_latest_frames`` per source, rig.py:286 — the latency
  hot spot flagged in its own call stack);
* the IMU queue is guarded by the same lock as the frame queues (the
  reference appends/reads it unsynchronized, rig.py:284,404).
"""

from __future__ import annotations

import logging
import time
from collections import deque
from dataclasses import dataclass, field
from threading import Lock
from types import TracebackType
from typing import Self, Sequence

import numpy as np

from thor_slam_tpu.camera.types import (
    CameraSource,
    Extrinsics,
    FrameSet,
    IMUExtrinsics,
    Intrinsics,
    SynchronizedFrameSet,
)

logger = logging.getLogger(__name__)


@dataclass
class RigCalibration:
    """Complete calibration of a multi-source camera rig.

    Attributes:
        intrinsics: source_name -> per-imager intrinsics.
        extrinsics: source_name -> per-imager extrinsics in the source frame.
        source_names: Stable ordering of sources.
        rig_extrinsics: source_name -> pose of the source in the rig frame.
        imu_extrinsics: IMU pose in the rig/world frame, if an IMU exists.
    """

    intrinsics: dict[str, list[Intrinsics]]
    extrinsics: dict[str, list[Extrinsics]]
    source_names: list[str] = field(default_factory=list)
    rig_extrinsics: dict[str, Extrinsics] = field(default_factory=dict)
    imu_extrinsics: IMUExtrinsics | None = None

    def get_world_extrinsics(self, source_name: str) -> list[Extrinsics] | None:
        """Per-imager extrinsics composed into the rig/world frame.

        ``world_T_camera = rig_T_source @ source_T_camera``
        (composition order per reference rig.py:35-70).
        """
        cams = self.extrinsics.get(source_name)
        if cams is None:
            return None
        rig_ext = self.rig_extrinsics.get(source_name)
        if rig_ext is None:
            logger.warning(
                "No rig extrinsics defined for source %s, returning camera extrinsics as-is", source_name
            )
            return cams
        return [rig_ext.compose(cam) for cam in cams]


class CameraRig:
    """Synchronizes frames (and IMU samples) across multiple camera sources.

    Keeps a bounded queue of recent :class:`FrameSet` per source. A
    synchronized set picks, per source, the queued set closest in time to a
    reference timestamp defined by the *slowest* source (the minimum over
    sources of each queue's newest timestamp) — guaranteeing every source has
    coverage at or after the reference.
    """

    def __init__(
        self,
        sources: Sequence[CameraSource],
        queue_size: int = 30,
        rig_extrinsics: dict[str, Extrinsics] | None = None,
        imu_extrinsics: IMUExtrinsics | None = None,
        imu_source: str | None = None,
        poll_blocking: bool = False,
        watchdog_timeout_s: float | None = None,
        clock_skew_limit_s: float = 5.0,
    ) -> None:
        """Create the rig.

        Args:
            sources: Camera sources to synchronize.
            queue_size: Bound on frame sets retained per source (and IMU samples).
            rig_extrinsics: source_name -> pose in the rig frame (identity if absent).
            imu_extrinsics: IMU pose in the rig frame (identity if absent).
            imu_source: Name of the source whose IMU stream to use.
            poll_blocking: If True, block on each source for a fresh frame per
                poll (the reference's behavior); default polls non-blocking.
            watchdog_timeout_s: If set, a source that produces no frames for
                this many wall-clock seconds is marked stale: it stops
                gating synchronization (the rig no longer waits for the
                slowest camera when the slowest camera is dead) and is
                reported in ``SynchronizedFrameSet.stale_sources`` so the
                engine can mask it. The reference has no such watchdog — a
                dead camera freezes its sync loop forever (SURVEY.md §5.3).
            clock_skew_limit_s: Frame/IMU clock-agreement guard. At the
                first poll that has both a frame and an IMU sample, their
                timestamps are compared; a skew beyond this limit means the
                two streams run on DIFFERENT clocks (e.g. a driver stamping
                frames with device time but IMU with host time) — every
                IMU preintegration window downstream would then be empty
                and the engine silently degrades to constant-velocity.
                Surfaced loudly at bring-up instead: logged as an error and
                exposed as :attr:`clock_skew_s`. The reference never
                checks (its timestamps happen to share the host clock,
                reference luxonis.py:790-791).
        """
        self.sources: dict[str, CameraSource] = {s.name: s for s in sources}
        if len(self.sources) != len(sources):
            raise ValueError("Duplicate source names in rig")
        self.queue_size = queue_size
        self._poll_blocking = poll_blocking
        self._frame_queues: dict[str, deque[FrameSet]] = {
            name: deque(maxlen=queue_size) for name in self.sources
        }
        self._imu_queue: deque[tuple[float, dict]] = deque(maxlen=max(queue_size, 256))
        self._lock = Lock()
        self._running = False
        self._imu_source = imu_source
        self._watchdog_timeout_s = watchdog_timeout_s
        self._last_frame_wall: dict[str, float] = {}
        self._clock_skew_limit_s = clock_skew_limit_s
        #: Measured frame-vs-IMU timestamp skew at bring-up (None until the
        #: first poll that saw both streams). Beyond ``clock_skew_limit_s``
        #: it is also logged as an error — see the ctor docstring.
        self.clock_skew_s: float | None = None

        if imu_source is not None:
            if imu_source not in self.sources:
                raise ValueError(
                    f"IMU source '{imu_source}' not found in sources. "
                    f"Available sources: {list(self.sources.keys())}"
                )
            if not self.sources[imu_source].has_sensor_data:
                raise ValueError(
                    f"IMU source '{imu_source}' does not have sensor data enabled. "
                    "Enable IMU reading when creating the camera source."
                )
            logger.info("Using '%s' as IMU source", imu_source)

        if not rig_extrinsics:
            logger.warning("No rig extrinsics provided, using identity transformation for all sources")
            rig_extrinsics = {name: Extrinsics.identity() for name in self.sources}
        if not imu_extrinsics:
            logger.warning("No imu extrinsics provided, using identity transformation for the IMU")
            imu_extrinsics = IMUExtrinsics(source_name=imu_source or "", extrinsics=Extrinsics.identity())

        self._calibration = self._build_calibration(rig_extrinsics, imu_extrinsics)

    # -- lifecycle ----------------------------------------------------------

    def __enter__(self) -> Self:
        self.start()
        return self

    def __exit__(
        self,
        exc_type: type[BaseException] | None,
        exc_val: BaseException | None,
        exc_tb: TracebackType | None,
    ) -> None:
        self.stop()

    def start(self) -> None:
        """Start every source (idempotent)."""
        if self._running:
            return
        for source in self.sources.values():
            source.start()
        now = time.monotonic()
        self._last_frame_wall = {name: now for name in self.sources}
        self._running = True

    def stop(self) -> None:
        """Stop every source and drop queued frames (idempotent)."""
        if not self._running:
            return
        for source in self.sources.values():
            source.stop()
        self._running = False
        self.clear_queues()

    def is_running(self) -> bool:
        """Whether start() has been called without a matching stop()."""
        return self._running

    # -- calibration --------------------------------------------------------

    def _build_calibration(
        self, rig_extrinsics: dict[str, Extrinsics], imu_extrinsics: IMUExtrinsics
    ) -> RigCalibration:
        return RigCalibration(
            intrinsics={name: s.get_intrinsics() for name, s in self.sources.items()},
            extrinsics={name: s.get_extrinsics() for name, s in self.sources.items()},
            rig_extrinsics=rig_extrinsics,
            imu_extrinsics=imu_extrinsics,
            source_names=list(self.sources.keys()),
        )

    @property
    def calibration(self) -> RigCalibration:
        """Current rig calibration."""
        return self._calibration

    def load_rig_extrinsics(
        self, rig_extrinsics: dict[str, Extrinsics], imu_extrinsics: IMUExtrinsics | None = None
    ) -> None:
        """Merge in updated rig extrinsics (e.g. parsed from a URDF)."""
        unknown = set(rig_extrinsics) - set(self.sources)
        if unknown:
            raise ValueError(f"Unknown source: {unknown.pop()}")
        merged = dict(self._calibration.rig_extrinsics)
        merged.update(rig_extrinsics)
        imu = imu_extrinsics or self._calibration.imu_extrinsics or IMUExtrinsics(
            source_name=self._imu_source or "", extrinsics=Extrinsics.identity()
        )
        self._calibration = self._build_calibration(merged, imu)

    def get_rig_extrinsics(self, source_name: str) -> Extrinsics | None:
        """Pose of a source in the rig frame, if set."""
        return self._calibration.rig_extrinsics.get(source_name)

    def get_world_extrinsics(self, source_name: str) -> list[Extrinsics] | None:
        """Per-imager extrinsics in the rig/world frame."""
        return self._calibration.get_world_extrinsics(source_name)

    # -- polling + synchronization -------------------------------------------

    def _poll_cameras(self) -> None:
        """Drain each source once: IMU (non-blocking) then frames."""
        for name, source in self.sources.items():
            if name == self._imu_source:
                data, ts = source.try_get_timestamped_sensor_data()
                if data is not None and ts is not None:
                    with self._lock:
                        self._imu_queue.append((ts, data))

            if self._poll_blocking:
                frames = source.get_latest_frames()
            else:
                frames = source.try_get_latest_frames()
            if frames:
                fs = FrameSet.from_frames(frames, source_name=name)
                with self._lock:
                    self._frame_queues[name].append(fs)
                self._last_frame_wall[name] = time.monotonic()
        if self.clock_skew_s is None and self._imu_source is not None:
            self._check_clock_agreement()

    def _check_clock_agreement(self) -> None:
        """One-shot bring-up check: frame and IMU timestamps share a clock.

        Uses the newest frame of the IMU's own source (same device, so the
        comparison is skew, not transport latency). A batched IMU payload
        compares its newest timestamp.
        """
        with self._lock:
            if not self._imu_queue:
                return
            queue = self._frame_queues.get(self._imu_source or "")
            if not queue:
                return
            frame_ts = queue[-1].timestamp
            imu_ts, data = self._imu_queue[-1]
        batch_ts = data.get("timestamps") if isinstance(data, dict) else None
        if batch_ts is not None and len(batch_ts):
            imu_ts = float(batch_ts[-1])
        self.clock_skew_s = abs(frame_ts - imu_ts)
        if self.clock_skew_s > self._clock_skew_limit_s:
            logger.error(
                "Frame/IMU clock disagreement at bring-up: |%.3f - %.3f| = "
                "%.1f s skew (> %.1f s limit). The streams are on different "
                "clocks — IMU fusion will see empty windows and silently "
                "degrade to constant-velocity. Fix the source's timestamping "
                "(device time for BOTH streams).",
                frame_ts, imu_ts, self.clock_skew_s, self._clock_skew_limit_s,
            )

    @staticmethod
    def _find_closest_frame_set(queue: deque[FrameSet], target_timestamp: float) -> FrameSet | None:
        """Queued set with minimal |timestamp − target|, or None if empty."""
        if not queue:
            return None
        return min(queue, key=lambda fs: abs(fs.timestamp - target_timestamp))

    @staticmethod
    def _find_closest_imu_data(
        queue: deque[tuple[float, dict]], target_timestamp: float
    ) -> tuple[float | None, dict | None]:
        """IMU sample with minimal |timestamp − target| as (ts, data)."""
        if not queue:
            return None, None
        ts, data = min(queue, key=lambda item: abs(item[0] - target_timestamp))
        return ts, data

    def _stale_sources(self) -> frozenset[str]:
        """Sources the watchdog considers dead (no frames within the timeout).

        Empty when the watchdog is disabled. Never marks *every* source stale
        — with no live camera there is nothing to synchronize against and the
        caller should see None from get_synchronized_frames instead.
        """
        if self._watchdog_timeout_s is None:
            return frozenset()
        now = time.monotonic()
        stale = frozenset(
            name
            for name, last in self._last_frame_wall.items()
            if now - last > self._watchdog_timeout_s
        )
        if len(stale) == len(self.sources):
            return frozenset()
        return stale

    def get_source_health(self) -> dict[str, float]:
        """Seconds since each source last produced a frame (watchdog view)."""
        now = time.monotonic()
        return {name: now - self._last_frame_wall.get(name, now) for name in self.sources}

    def _get_reference_timestamp(self, exclude: frozenset[str] = frozenset()) -> float | None:
        """min over sources of each queue's newest timestamp (slowest camera).

        None when any non-excluded queue is still empty — synchronization is
        impossible until every live source has produced at least one frame
        set. ``exclude`` removes watchdog-stale sources from the gate so a
        dead camera cannot freeze the rig (the reference's behavior without
        a watchdog, reference rig.py:336-356).
        """
        with self._lock:
            newest: list[float] = []
            for name, queue in self._frame_queues.items():
                if name in exclude:
                    continue
                if not queue:
                    return None
                newest.append(queue[-1].timestamp)
        return min(newest) if newest else None

    def get_synchronized_frames(self, max_wait_ms: float = 100.0) -> SynchronizedFrameSet | None:
        """Poll all sources and assemble a synchronized frame set.

        Algorithm (identical to reference rig.py:361-374):
          1. poll every camera (and the IMU source) once;
          2. reference timestamp = newest frame of the slowest camera;
          3. per source, pick the queued set closest to the reference;
          4. attach the IMU sample closest to the reference;
          5. report the worst per-source deviation as ``max_time_delta``.

        Args:
            max_wait_ms: Accepted for API parity; unused (as in the reference).

        Returns:
            A synchronized set, or None until every source has frames.
        """
        del max_wait_ms
        if not self._running:
            return None

        self._poll_cameras()

        stale = self._stale_sources()
        reference_timestamp = self._get_reference_timestamp(exclude=stale)
        if reference_timestamp is None:
            logger.debug("Not all cameras have frames yet; cannot synchronize")
            return None
        if stale:
            logger.warning("Watchdog: stale sources excluded from sync: %s", sorted(stale))

        picked: dict[str, FrameSet] = {}
        max_time_delta = 0.0
        with self._lock:
            for name, queue in self._frame_queues.items():
                closest = self._find_closest_frame_set(queue, reference_timestamp)
                if closest is None:
                    if name in stale:
                        continue  # dead before its first frame: omit entirely
                    return None
                picked[name] = closest
                if name not in stale:  # stale deltas would swamp the signal
                    max_time_delta = max(
                        max_time_delta, abs(closest.timestamp - reference_timestamp)
                    )

            sensor_data: dict | None = None
            sensor_timestamp: float | None = None
            if self._imu_source is not None:
                ts, data = self._find_closest_imu_data(self._imu_queue, reference_timestamp)
                if data is not None:
                    sensor_data, sensor_timestamp = data, ts

        return SynchronizedFrameSet(
            timestamp=reference_timestamp,
            frame_sets=picked,
            max_time_delta=max_time_delta,
            sensor_data=sensor_data,
            sensor_timestamp=sensor_timestamp,
            stale_sources=stale,
        )

    def get_latest_frames(self) -> SynchronizedFrameSet | None:
        """Newest frame set per source, without timestamp matching.

        The reference timestamp is the newest across sources and
        ``max_time_delta`` is the spread between sources' newest sets
        (reference rig.py:417-469 semantics).
        """
        if not self._running:
            return None

        self._poll_cameras()

        frame_sets: dict[str, FrameSet] = {}
        with self._lock:
            for name, queue in self._frame_queues.items():
                if not queue:
                    logger.debug("Camera %s has no frames yet", name)
                    return None
                frame_sets[name] = queue[-1]

            sensor_data: dict | None = None
            sensor_timestamp: float | None = None
            if self._imu_source is not None and self._imu_queue:
                sensor_timestamp, sensor_data = self._imu_queue[-1]

        timestamps = [fs.timestamp for fs in frame_sets.values()]
        return SynchronizedFrameSet(
            timestamp=max(timestamps),
            frame_sets=frame_sets,
            max_time_delta=max(timestamps) - min(timestamps),
            sensor_data=sensor_data,
            sensor_timestamp=sensor_timestamp,
        )

    # -- queue management ----------------------------------------------------

    def get_source_names(self) -> list[str]:
        """Names of every source in this rig."""
        return list(self.sources.keys())

    def get_source(self, name: str) -> CameraSource | None:
        """Look up a source by name."""
        return self.sources.get(name)

    def clear_queues(self) -> None:
        """Drop all queued frames and IMU samples."""
        with self._lock:
            for queue in self._frame_queues.values():
                queue.clear()
            self._imu_queue.clear()

    def get_queue_depths(self) -> dict[str, int]:
        """Current number of queued frame sets per source."""
        with self._lock:
            return {name: len(q) for name, q in self._frame_queues.items()}

    def prune_old_frames(self, max_age_seconds: float = 1.0) -> int:
        """Drop frame sets older than ``max_age_seconds`` behind the newest.

        Returns:
            The number of frame sets removed.
        """
        with self._lock:
            newest = max(
                (q[-1].timestamp for q in self._frame_queues.values() if q),
                default=None,
            )
            if newest is None:
                return 0
            cutoff = newest - max_age_seconds
            pruned = 0
            for queue in self._frame_queues.values():
                while queue and queue[0].timestamp < cutoff:
                    queue.popleft()
                    pruned += 1
        return pruned


def stack_synchronized_images(
    frame_set: SynchronizedFrameSet, source_order: Sequence[str] | None = None
) -> np.ndarray:
    """Stack a synchronized set into one dense [num_sources, frames_per_source, H, W(, C)] array.

    This is the host-side staging step before a single ``device_put`` onto the
    device — the whole rig's tick rides one transfer instead of one per camera.
    All sources must produce the same image shape and frames-per-source.
    """
    names = list(source_order) if source_order is not None else sorted(frame_set.frame_sets)
    per_source = [
        np.stack([f.image for f in frame_set.frame_sets[name].frames]) for name in names
    ]
    return np.stack(per_source)
