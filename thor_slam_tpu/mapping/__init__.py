"""Dense mapping in JAX: the nvblox replacement.

The reference delegates dense reconstruction to NVIDIA nvblox (CUDA TSDF,
reference launch/thor_nvblox.launch.py:62-91), consuming the RGB-D stream
this framework already produces (``pipeline/rgbd.py``). This package
closes the loop in-process, on the tracker's device:

* :mod:`tsdf` — projective TSDF integration over a dense voxel grid
  (voxel-parallel gather from the depth image; no scatters), with the
  reference deployment's parameters as defaults (voxel 0.05 m, truncation
  4 voxels, max integration distance 10 m).
* :mod:`esdf` — EXACT Euclidean signed-distance field via separable
  min-plus distance transforms (3D for planning, 2D slice for costmaps —
  the reference's ``esdf_mode: 1`` role).
* :mod:`mesh` — Surface-Nets dual contouring with a fixed active-cell
  budget (the NvbloxMesh display role; chosen over marching cubes because
  its regular stencils and table-free vertex rule are dense elementwise
  work).
"""

from thor_slam_tpu.mapping.esdf import esdf_from_tsdf, esdf_slice_2d
from thor_slam_tpu.mapping.mesh import SurfaceMesh, extract_mesh, extract_surface_points
from thor_slam_tpu.mapping.tsdf import (
    GridSpec,
    TsdfGrid,
    centered_origin,
    load_grid,
    make_decay,
    make_grid,
    make_integrator,
    make_recenter,
    make_scan_integrator,
    save_grid,
)

__all__ = [
    "GridSpec",
    "TsdfGrid",
    "SurfaceMesh",
    "centered_origin",
    "esdf_from_tsdf",
    "esdf_slice_2d",
    "extract_mesh",
    "extract_surface_points",
    "load_grid",
    "make_decay",
    "make_grid",
    "make_integrator",
    "make_recenter",
    "make_scan_integrator",
    "save_grid",
]
