"""Projective TSDF integration on a dense voxel grid.

The role nvblox's ``ProjectiveTsdfIntegrator`` plays in the reference
deployment (reference launch/thor_nvblox.launch.py:62-91 parameters:
``voxel_size 0.05``, ``tsdf_integrator_truncation_distance_vox 4.0``,
``tsdf_integrator_max_integration_distance_m 10.0`` — kept here as the
:class:`GridSpec` defaults).

Design
------
nvblox is built around sparse voxel *blocks* allocated on demand and a
per-block CUDA kernel. Here the formulation is the opposite, so that all
of it is plain XLA:

* one DENSE fixed-shape grid (static shapes: one compilation, ever);
* the update is voxel-parallel — every voxel projects into the depth
  image (a handful of fused element-wise ops on broadcasted iotas) and
  reads its depth sample with ONE gather; there are no scatters anywhere;
* the camera never sees the grid layout: moving the map is a roll of the
  grid contents (:func:`make_recenter`), so the world origin is dynamic
  state, not a compile-time constant.

Memory at the deployed parameters (256x256x128 voxels = 12.8x12.8x6.4 m
at 5 cm): 33.5 MB per f32 channel — trivially resident in device memory
next to the tracker.

The innermost grid axis is z, so voxel rows are contiguous in memory.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class GridSpec:
    """Static geometry + integration policy of a TSDF grid.

    Defaults mirror the reference's nvblox configuration (reference
    launch/thor_nvblox.launch.py:26-36).

    Attributes:
        dims: Voxel counts ``(nx, ny, nz)``; ``nz`` is the innermost
            (contiguous) axis.
        voxel_size_m: Edge length of one voxel.
        truncation_vox: Truncation band in voxels (metric band =
            ``truncation_vox * voxel_size_m``).
        max_integration_distance_m: Depth samples beyond this are ignored.
        min_integration_distance_m: Depth samples closer than this are
            treated as invalid (matches the RGB-D product's hole value 0).
        max_weight: Per-voxel observation weight cap (running-average
            window; nvblox's ``max_weight`` role).
        integrate_color: Whether grids carry a color channel.
    """

    dims: tuple[int, int, int] = (256, 256, 128)
    voxel_size_m: float = 0.05
    truncation_vox: float = 4.0
    max_integration_distance_m: float = 10.0
    min_integration_distance_m: float = 0.1
    max_weight: float = 100.0
    integrate_color: bool = True

    @property
    def truncation_m(self) -> float:
        return self.truncation_vox * self.voxel_size_m

    @property
    def extent_m(self) -> tuple[float, float, float]:
        return (
            self.dims[0] * self.voxel_size_m,
            self.dims[1] * self.voxel_size_m,
            self.dims[2] * self.voxel_size_m,
        )


class TsdfGrid(NamedTuple):
    """Device-resident TSDF state (a pytree; all leaves same grid shape).

    Attributes:
        tsdf: (nx, ny, nz) f32 truncated signed distance, METERS, clamped
            to +-truncation; unobserved voxels hold +truncation.
        weight: (nx, ny, nz) f32 accumulated observation weight (0 =
            never observed).
        color: (nx, ny, nz, 3) f32 running-mean RGB in [0, 255], or a
            (0,) placeholder when the spec disables color.
        origin: (3,) f32 world position of the (0, 0, 0) voxel CORNER.
            Dynamic state so recentering never recompiles.
    """

    tsdf: jnp.ndarray
    weight: jnp.ndarray
    color: jnp.ndarray
    origin: jnp.ndarray


def make_grid(spec: GridSpec, origin_m: np.ndarray | tuple = (0.0, 0.0, 0.0)) -> TsdfGrid:
    """Allocate an empty grid with its corner at ``origin_m`` (world)."""
    nx, ny, nz = spec.dims
    color = (
        jnp.zeros((nx, ny, nz, 3), jnp.float32)
        if spec.integrate_color
        else jnp.zeros((0,), jnp.float32)
    )
    return TsdfGrid(
        tsdf=jnp.full((nx, ny, nz), spec.truncation_m, jnp.float32),
        weight=jnp.zeros((nx, ny, nz), jnp.float32),
        color=color,
        origin=jnp.asarray(origin_m, jnp.float32),
    )


def centered_origin(spec: GridSpec, center_m: np.ndarray) -> np.ndarray:
    """World origin that centers the grid on ``center_m``, voxel-snapped."""
    half = 0.5 * np.asarray(spec.extent_m)
    raw = np.asarray(center_m, np.float64) - half
    return (np.round(raw / spec.voxel_size_m) * spec.voxel_size_m).astype(np.float32)


def _voxel_centers_cam(spec: GridSpec, origin: jnp.ndarray, cam_t_world: jnp.ndarray):
    """Camera-frame coordinates of every voxel center, as three planes.

    Kept as separate (nx, ny, nz) scalars rather than one (N, 3) tensor so
    XLA fuses the whole chain (iota -> affine -> projection) without ever
    materializing a point list.
    """
    nx, ny, nz = spec.dims
    vs = spec.voxel_size_m
    ix = jax.lax.broadcasted_iota(jnp.float32, (nx, ny, nz), 0)
    iy = jax.lax.broadcasted_iota(jnp.float32, (nx, ny, nz), 1)
    iz = jax.lax.broadcasted_iota(jnp.float32, (nx, ny, nz), 2)
    px = origin[0] + (ix + 0.5) * vs
    py = origin[1] + (iy + 0.5) * vs
    pz = origin[2] + (iz + 0.5) * vs
    r = cam_t_world[:3, :3]
    t = cam_t_world[:3, 3]
    xc = r[0, 0] * px + r[0, 1] * py + r[0, 2] * pz + t[0]
    yc = r[1, 0] * px + r[1, 1] * py + r[1, 2] * pz + t[1]
    zc = r[2, 0] * px + r[2, 1] * py + r[2, 2] * pz + t[2]
    return xc, yc, zc


def make_integrator(spec: GridSpec, donate: bool = False):
    """Build the jitted per-frame integrator for one depth-image shape.

    Returns:
        ``integrate(grid, depth_mm_u16, color_u8, cam_t_world, intr4)``
        -> new :class:`TsdfGrid`, where

        * ``depth_mm_u16``: (H, W) uint16 depth in millimeters, 0 =
          invalid — EXACTLY the RGB-D product encoding
          (``pipeline/rgbd.py``, reference run_pipeline.py:247-252), so
          the host uploads the product buffer as-is (2 bytes/px) and the
          meters conversion runs on device;
        * ``color_u8``: (H, W, 3) uint8 aligned color (pass an empty
          (0,) array when the spec disables color);
        * ``cam_t_world``: (4, 4) f32 world->camera transform (RDF
          camera, +z forward — §5.9 conventions);
        * ``intr4``: (4,) f32 ``[fx, fy, cx, cy]`` at the depth
          resolution (a runtime array so all cameras share one
          compilation per image shape).

    Args:
        spec: Static grid geometry/policy.
        donate: Donate the input grid's buffers to the output. The
            streaming mapper MUST use this: without donation each frame
            allocs/frees ~100 MB of grid channels. The caller must never
            reuse a grid after passing it.
    """
    def integrate(grid, depth_mm_u16, color_u8, cam_t_world, intr4):
        return _integrate_one(spec, grid, depth_mm_u16, color_u8, cam_t_world, intr4)

    return jax.jit(integrate, donate_argnums=(0,) if donate else ())


def make_scan_integrator(spec: GridSpec, donate: bool = False):
    """Build a jitted BULK integrator: N frames fused into ONE dispatch.

    ``integrate_scan(grid, depths, colors, poses, intr4) -> TsdfGrid``
    where ``depths`` is (N, H, W) uint16 mm, ``colors`` (N, H, W, 3)
    uint8 (or (N, 0) when color is disabled), ``poses`` (N, 4, 4) f32
    world->camera. Semantically identical to N sequential
    :func:`make_integrator` calls (same body, ``lax.scan`` over frames).

    This is the offline/batch form: dataset replay and map rebuilds
    integrate a whole recorded stack per dispatch, so per-dispatch
    host->device latency amortizes over N frames instead of serializing the loop. The online
    ``DenseMapper`` keeps the per-frame form — a live sensor has no
    future frames to batch.
    """

    def integrate_scan(grid: TsdfGrid, depths, colors, poses, intr4) -> TsdfGrid:
        def body(g, xs):
            depth, color, pose = xs
            return _integrate_one(spec, g, depth, color, pose, intr4), None

        grid, _ = jax.lax.scan(body, grid, (depths, colors, poses))
        return grid

    return jax.jit(integrate_scan, donate_argnums=(0,) if donate else ())


def _integrate_one(spec: GridSpec, grid: TsdfGrid, depth_mm_u16, color_u8, cam_t_world, intr4) -> TsdfGrid:
    """One frame's voxel-parallel TSDF update (shared by both integrators)."""
    trunc = spec.truncation_m  # sdf stored metric, like nvblox
    h, w = depth_mm_u16.shape
    depth_flat = depth_mm_u16.reshape(-1).astype(jnp.float32) * 1e-3
    xc, yc, zc = _voxel_centers_cam(spec, grid.origin, cam_t_world)
    fx, fy, cx, cy = intr4[0], intr4[1], intr4[2], intr4[3]
    zs = jnp.maximum(zc, 1e-6)
    u = fx * xc / zs + cx
    v = fy * yc / zs + cy
    ui = jnp.round(u).astype(jnp.int32)
    vi = jnp.round(v).astype(jnp.int32)
    in_view = (
        (zc > spec.min_integration_distance_m)
        & (zc < spec.max_integration_distance_m)
        & (ui >= 0)
        & (ui < w)
        & (vi >= 0)
        & (vi < h)
    )
    flat = jnp.clip(vi * w + ui, 0, h * w - 1)
    d = depth_flat[flat]  # the one gather
    valid = in_view & (d > spec.min_integration_distance_m)
    sdf = d - zc  # projective distance along the optical axis
    update = valid & (sdf > -trunc)
    w_obs = jnp.where(update, 1.0, 0.0).astype(jnp.float32)
    new_w = jnp.minimum(grid.weight + w_obs, spec.max_weight)
    sdf_c = jnp.clip(sdf, -trunc, trunc)
    num = grid.weight * grid.tsdf + w_obs * sdf_c
    tsdf = jnp.where(new_w > 0.0, num / jnp.maximum(new_w, 1e-9), grid.tsdf)

    if spec.integrate_color:
        color_flat = color_u8.reshape(h * w, 3).astype(jnp.float32)
        c = color_flat[flat]  # (nx, ny, nz, 3)
        # Color only carries meaning in the surface band.
        w_c = jnp.where(update & (jnp.abs(sdf) < trunc), 1.0, 0.0)[..., None]
        cw_old = jnp.minimum(grid.weight, spec.max_weight)[..., None]
        color = jnp.where(
            cw_old + w_c > 0.0,
            (cw_old * grid.color + w_c * c) / jnp.maximum(cw_old + w_c, 1e-9),
            grid.color,
        )
    else:
        color = grid.color
    return TsdfGrid(tsdf=tsdf, weight=new_w, color=color, origin=grid.origin)


def make_decay(spec: GridSpec, min_weight: float = 1e-2, donate: bool = False):
    """Build the jitted weight-decay pass (dynamic-scene maintenance).

    The nvblox ``TsdfDecayIntegrator`` role: observation weights shrink by
    a factor so stale geometry (moved obstacles, people) fades instead of
    persisting forever; voxels decayed below ``min_weight`` revert to
    unobserved. Run at a fixed cadence, independent of integration.
    ``donate`` as in :func:`make_integrator` (streaming callers reuse the
    grid buffers in place).
    """

    def decay(grid: TsdfGrid, factor) -> TsdfGrid:
        w = grid.weight * factor
        dead = w < min_weight
        tsdf = jnp.where(dead, spec.truncation_m, grid.tsdf)
        w = jnp.where(dead, 0.0, w)
        if spec.integrate_color:
            color = jnp.where(dead[..., None], 0.0, grid.color)
        else:
            color = grid.color
        return TsdfGrid(tsdf=tsdf, weight=w, color=color, origin=grid.origin)

    return jax.jit(decay, donate_argnums=(0,) if donate else ())


def save_grid(path, grid: TsdfGrid, spec: GridSpec) -> None:
    """Serialize a grid + its spec to ``.npz`` (the nvblox save-map role)."""
    np.savez_compressed(
        path,
        tsdf=np.asarray(grid.tsdf),
        weight=np.asarray(grid.weight),
        color=np.asarray(grid.color),
        origin=np.asarray(grid.origin),
        dims=np.asarray(spec.dims, np.int64),
        voxel_size_m=spec.voxel_size_m,
        truncation_vox=spec.truncation_vox,
        max_integration_distance_m=spec.max_integration_distance_m,
        min_integration_distance_m=spec.min_integration_distance_m,
        max_weight=spec.max_weight,
        integrate_color=spec.integrate_color,
    )


def load_grid(path) -> tuple[TsdfGrid, GridSpec]:
    """Load a grid saved by :func:`save_grid`; the spec rides the file."""
    d = np.load(path)
    spec = GridSpec(
        dims=tuple(int(x) for x in d["dims"]),
        voxel_size_m=float(d["voxel_size_m"]),
        truncation_vox=float(d["truncation_vox"]),
        max_integration_distance_m=float(d["max_integration_distance_m"]),
        min_integration_distance_m=float(d["min_integration_distance_m"]),
        max_weight=float(d["max_weight"]),
        integrate_color=bool(d["integrate_color"]),
    )
    grid = TsdfGrid(
        tsdf=jnp.asarray(d["tsdf"]),
        weight=jnp.asarray(d["weight"]),
        color=jnp.asarray(d["color"]),
        origin=jnp.asarray(d["origin"]),
    )
    return grid, spec


def make_recenter(spec: GridSpec, donate: bool = False):
    """Build the jitted rolling-grid shift (the map follows the robot).

    nvblox streams blocks in and out of an unbounded hash map; the dense
    grid instead ROLLS: content keeps its world position, voxels that
    wrap around are reset to unobserved. The shift is a traced argument,
    so recentering reuses the one compiled program. ``donate`` as in
    :func:`make_integrator`.

    Returns:
        ``recenter(grid, shift_vox, new_origin=None)`` -> new grid, where
        ``shift_vox`` is (3,) int32 voxels to ADD to the origin.
        ``new_origin`` optionally supplies the post-shift origin (3,) f32
        directly — callers keeping a HOST shadow of the origin (the
        DenseMapper, to avoid a per-frame device fetch) pass their own
        value so host and device stay bit-identical instead of trusting
        two f32 evaluations of ``origin + shift * vs`` to round alike.
    """
    nx, ny, nz = spec.dims
    vs = spec.voxel_size_m

    def recenter(grid: TsdfGrid, shift_vox, new_origin=None) -> TsdfGrid:
        s = shift_vox.astype(jnp.int32)
        # Content at world voxel j lands at local index j - shift.
        def invalid_mask(axis, n):
            i = jax.lax.broadcasted_iota(jnp.int32, (nx, ny, nz), axis)
            return (i >= n - jnp.maximum(s[axis], 0)) | (i < -jnp.minimum(s[axis], 0))

        bad = invalid_mask(0, nx) | invalid_mask(1, ny) | invalid_mask(2, nz)
        tsdf = jnp.roll(grid.tsdf, shift=(-s[0], -s[1], -s[2]), axis=(0, 1, 2))
        weight = jnp.roll(grid.weight, shift=(-s[0], -s[1], -s[2]), axis=(0, 1, 2))
        tsdf = jnp.where(bad, spec.truncation_m, tsdf)
        weight = jnp.where(bad, 0.0, weight)
        if spec.integrate_color:
            color = jnp.roll(grid.color, shift=(-s[0], -s[1], -s[2]), axis=(0, 1, 2))
            color = jnp.where(bad[..., None], 0.0, color)
        else:
            color = grid.color
        if new_origin is None:
            origin = grid.origin + s.astype(jnp.float32) * vs
        else:
            origin = jnp.asarray(new_origin, jnp.float32)
        return TsdfGrid(tsdf=tsdf, weight=weight, color=color, origin=origin)

    return jax.jit(recenter, donate_argnums=(0,) if donate else ())
