"""Host-side dense-mapping orchestration: the in-process nvblox node.

The reference runs nvblox as a separate CUDA process consuming the RGB-D
topics (reference launch/thor_nvblox.launch.py:62-91, fed by
run_pipeline.py's RGBDPublisher). :class:`DenseMapper` plays that node's
role in-process: it consumes the same :class:`~thor_slam_tpu.pipeline.rgbd.
RGBDFrame` product plus the engine's pose stream, keeps a device-resident
TSDF grid that ROLLS with the robot, and serves the nvblox output surface
(surface cloud, Surface-Nets mesh, 2D ESDF costmap slice).

Frames: integration happens in the engine's ODOM frame — exactly the
reference's nvblox configuration (``global_frame: odom``, reference
launch/thor_nvblox.launch.py default), so dense geometry stays consistent
with the smooth pose stream and is never yanked by loop-closure
corrections; consumers place it with the map->odom TF.

Host cost per integrated frame is ONE async dispatch — and zero bytes
when fed ``RGBDProcessor.process(..., fetch=False)`` device frames (depth
and color are consumed where the depth pipeline produced them). The grid
never leaves the device between ticks, and its channel buffers are
DONATED through every integrate/decay/recenter, so the ~100 MB state is
reused in place instead of churning the allocator (the tracker's
streaming pattern).
Consequence: a ``TsdfGrid`` reference obtained from :attr:`DenseMapper.
grid` is invalidated by the NEXT integrate/decay/recenter — read it (or
copy) before integrating again.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import jax.numpy as jnp
import numpy as np

from thor_slam_tpu.mapping import (
    GridSpec,
    TsdfGrid,
    SurfaceMesh,
    centered_origin,
    esdf_slice_2d,
    extract_mesh,
    extract_surface_points,
    load_grid,
    make_decay,
    make_grid,
    make_integrator,
    make_recenter,
    save_grid,
)
from thor_slam_tpu.pipeline.rgbd import RGBDFrame

logger = logging.getLogger(__name__)


@dataclass
class MapperConfig:
    """Dense-mapper options (defaults = the reference's nvblox launch).

    Attributes:
        voxel_size_m: Voxel edge (reference ``voxel_size: 0.05``).
        dims: Grid voxel counts (x, y, z); z innermost. The default
            256x256x128 spans 12.8 x 12.8 x 6.4 m around the robot.
        truncation_vox: TSDF truncation band in voxels (reference 4.0).
        max_integration_distance_m: Depth cutoff (reference 10.0).
        integrate_color: Carry a color channel for mesh/cloud export.
        recenter_margin_m: Roll the grid when the robot gets closer than
            this to a horizontal grid face (0 disables recentering).
        slice_axis: Grid/odom axis the costmap slices across (2 = z, the
            vertical for an FLU body rig — the odom frame is the body
            frame at start-up, so this matches the reference's absolute
            ``slice_height`` semantics in its global frame).
        slice_band_m: Costmap band (lo, hi) in ABSOLUTE odom coordinates
            along ``slice_axis`` (the nvblox map-slice role).
        esdf_max_distance_m: Costmap clamp radius.
    """

    voxel_size_m: float = 0.05
    dims: tuple[int, int, int] = (256, 256, 128)
    truncation_vox: float = 4.0
    max_integration_distance_m: float = 10.0
    integrate_color: bool = True
    recenter_margin_m: float = 2.0
    slice_axis: int = 2
    slice_band_m: tuple[float, float] = (0.0, 1.0)
    esdf_max_distance_m: float = 2.0


@dataclass
class MapperStats:
    """Observability counters for the status line."""

    integrated_frames: int = 0
    recenters: int = 0
    last_observed_voxels: int = 0
    shapes_compiled: set = field(default_factory=set)


class DenseMapper:
    """TSDF mapping service driven by RGB-D frames and SLAM poses."""

    def __init__(self, config: MapperConfig | None = None) -> None:
        self.config = config or MapperConfig()
        c = self.config
        self._spec = GridSpec(
            dims=tuple(c.dims),
            voxel_size_m=c.voxel_size_m,
            truncation_vox=c.truncation_vox,
            max_integration_distance_m=c.max_integration_distance_m,
            integrate_color=c.integrate_color,
        )
        self._grid: TsdfGrid | None = None
        self._integrators: dict[tuple[int, int], object] = {}
        self._recenter = make_recenter(self._spec, donate=True)
        self._decay = None
        # Host shadow of the grid origin: every origin change is computed
        # on the host (make_grid / recenter shift), so reading it must
        # never fetch grid.origin from the device — that 12-byte get
        # would SYNC on the previous integrate every frame.
        self._origin_host: np.ndarray | None = None
        self.stats = MapperStats()

    @property
    def spec(self) -> GridSpec:
        return self._spec

    @property
    def grid(self) -> TsdfGrid | None:
        """The live device-resident grid (None before the first frame).

        The reference is only valid until the next integrate/decay/
        recenter (buffer donation — see the module docstring).
        """
        return self._grid

    def integrate(self, frame: RGBDFrame, world_t_product: np.ndarray) -> None:
        """Fuse one RGB-D frame taken at ``world_t_product`` (odom frame).

        Never syncs: when ``frame`` carries device arrays
        (``RGBDProcessor.process(fetch=False)``) the whole depth->TSDF
        hop is device-side — one async dispatch, zero host round trips
        (guarded by tests/test_mapper.py transfer-guard test). Host-numpy
        frames upload their payloads, nothing is ever fetched.

        Args:
            frame: The RGB-D product (u16 millimeter depth + aligned rgb).
            world_t_product: (4, 4) pose of the frame's PRODUCT camera
                frame (``RGBDProcessor.product_t_in_left`` composed with
                the body pose) in the mapping frame.
        """
        cam_pos = np.asarray(world_t_product, np.float64)[:3, 3]
        if self._grid is None:
            self._origin_host = centered_origin(self._spec, cam_pos)
            self._grid = make_grid(self._spec, origin_m=self._origin_host)
        elif self.config.recenter_margin_m > 0:
            self._maybe_recenter(cam_pos)

        h, w = frame.depth_mm.shape
        integ = self._integrators.get((h, w))
        if integ is None:
            integ = make_integrator(self._spec, donate=True)
            self._integrators[(h, w)] = integ
            self.stats.shapes_compiled.add((h, w))
        k = np.asarray(frame.intrinsics.matrix, np.float64)
        # numpy, not jnp.asarray: the jitted call boundary uploads the
        # 16-byte operand for free; an eager device op would dispatch.
        intr4 = np.asarray([k[0, 0], k[1, 1], k[0, 2], k[1, 2]], np.float32)
        if self._spec.integrate_color:
            rgb = frame.rgb
            if rgb.ndim == 2:  # grayscale product: replicate ON DEVICE
                # (np.repeat on a device array would fetch it to the host)
                rgb = jnp.repeat(jnp.asarray(rgb)[..., None], 3, axis=-1)
            color = jnp.asarray(rgb)
        else:
            color = jnp.zeros((0,), jnp.uint8)
        cam_t_world = np.linalg.inv(np.asarray(world_t_product, np.float64))
        self._grid = integ(
            self._grid,
            frame.depth_mm,
            color,
            cam_t_world.astype(np.float32),
            intr4,
        )
        self.stats.integrated_frames += 1

    def _maybe_recenter(self, cam_pos: np.ndarray) -> None:
        origin = np.asarray(self._origin_host, np.float64)
        extent = np.asarray(self._spec.extent_m)
        margin = self.config.recenter_margin_m
        lo = origin + margin
        hi = origin + extent - margin
        # Only roll horizontally; z stays anchored (floors/ceilings).
        need = (cam_pos[:2] < lo[:2]) | (cam_pos[:2] > hi[:2])
        if not need.any():
            return
        target = centered_origin(self._spec, cam_pos)
        shift = np.zeros(3, np.int64)
        shift[:2] = np.round(
            (target[:2] - origin[:2]) / self._spec.voxel_size_m
        ).astype(np.int64)
        # The host computes the post-shift origin and hands it to the
        # kernel: the shadow and the device origin stay BIT-identical
        # (two f32 evaluations of origin + shift*vs may round apart).
        self._origin_host = (
            self._origin_host.astype(np.float32)
            + shift.astype(np.float32) * np.float32(self._spec.voxel_size_m)
        )
        self._grid = self._recenter(
            self._grid, shift.astype(np.int32), self._origin_host
        )
        self.stats.recenters += 1
        logger.info("mapper: recentered grid by %s voxels", shift.tolist())

    def decay(self, factor: float = 0.95) -> None:
        """Shrink observation weights (dynamic-scene maintenance).

        The nvblox TsdfDecayIntegrator role: stale geometry fades out
        instead of persisting; fully-decayed voxels revert to unobserved.
        Call at a fixed cadence (e.g. 1 Hz), independent of integration.
        """
        if self._grid is None:
            return
        if self._decay is None:
            self._decay = make_decay(self._spec, donate=True)
        self._grid = self._decay(self._grid, np.float32(factor))

    def save(self, path) -> None:
        """Persist the dense map (the nvblox save-map service role)."""
        if self._grid is None:
            raise RuntimeError("no map to save: nothing integrated yet")
        save_grid(path, self._grid, self._spec)

    def load(self, path) -> None:
        """Restore a saved dense map; its spec replaces the configured one
        (grids are only meaningful with the geometry they were built at)."""
        self._grid, self._spec = load_grid(path)
        self._origin_host = np.asarray(self._grid.origin)  # one-time fetch
        self._integrators.clear()  # spec changed: integrators rebuild lazily
        self._recenter = make_recenter(self._spec, donate=True)
        self._decay = None

    # --- the nvblox output surface -------------------------------------

    def surface_cloud(self, max_points: int = 131072) -> tuple[np.ndarray, np.ndarray]:
        """Colored surface point cloud ((N, 3) f32 m, (N, 3) u8)."""
        if self._grid is None:
            return np.empty((0, 3), np.float32), np.empty((0, 3), np.uint8)
        return extract_surface_points(self._grid, self._spec, max_points=max_points)

    def mesh(self, max_vertices: int = 65536, max_quads: int = 65536) -> SurfaceMesh:
        """Surface-Nets mesh of the current map (world/odom coordinates)."""
        if self._grid is None:
            return SurfaceMesh(
                vertices=np.empty((0, 3), np.float32),
                colors=np.empty((0, 3), np.uint8),
                triangles=np.empty((0, 3), np.int32),
            )
        return extract_mesh(
            self._grid, self._spec, max_vertices=max_vertices, max_quads=max_quads
        )

    def esdf_slice(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """2D costmap slice over the configured band of ``slice_axis``.

        Returns:
            ``(distance_m, occupied, observed, plane_origin)`` — 2D
            arrays over the two NON-slice grid axes (in ascending axis
            order) plus the odom coordinates of cell (0, 0)'s corner on
            that plane, for costmap export.
        """
        spec = self._spec
        axis = self.config.slice_axis
        plane_axes = [a for a in range(3) if a != axis]
        n0, n1 = spec.dims[plane_axes[0]], spec.dims[plane_axes[1]]
        if self._grid is None:
            return (
                np.full((n0, n1), self.config.esdf_max_distance_m, np.float32),
                np.zeros((n0, n1), bool),
                np.zeros((n0, n1), bool),
                np.zeros(2, np.float64),
            )
        origin = np.asarray(self._origin_host, np.float64)
        lo_m, hi_m = self.config.slice_band_m
        n_axis = spec.dims[axis]
        k_lo = int(np.clip((lo_m - origin[axis]) / spec.voxel_size_m, 0, n_axis - 1))
        k_hi = int(np.clip((hi_m - origin[axis]) / spec.voxel_size_m, k_lo + 1, n_axis))
        tsdf = jnp.moveaxis(self._grid.tsdf, axis, 2)
        weight = jnp.moveaxis(self._grid.weight, axis, 2)
        dist, occ, obs = esdf_slice_2d(
            tsdf,
            weight,
            voxel_size_m=spec.voxel_size_m,
            z_lo_vox=k_lo,
            z_hi_vox=k_hi,
            max_distance_m=self.config.esdf_max_distance_m,
        )
        self.stats.last_observed_voxels = int(np.asarray(obs).sum())
        plane_origin = origin[plane_axes]
        return np.asarray(dist), np.asarray(occ), np.asarray(obs), plane_origin
