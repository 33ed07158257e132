"""Surface extraction from the TSDF grid: point clouds and meshes.

The display/consumer products nvblox serves in the reference deployment
(``NvbloxMesh`` display in config/nvblox.rviz; mesh + surface cloud
topics). Two extractors:

* :func:`extract_surface_points` — zero-band voxel centers with colors,
  for PointCloud2 export (cheap, every-tick rate).
* :func:`extract_mesh` — SURFACE NETS dual contouring. nvblox marches
  cubes with a 256-case triangle table; Surface Nets needs only regular
  8-corner stencils and a table-free vertex rule (mean of edge
  zero-crossings), then one quad per sign-changing voxel edge. Same
  watertight surface class, all dense elementwise work.

Both run with FIXED budgets (``jnp.nonzero(size=...)`` selection) so the
jitted programs have static shapes. ``nonzero`` prefix-packs its hits, so
valid entries always occupy a prefix of the padded buffers: the host
fetches the count (a scalar) and then ONLY the valid prefix — fetch bytes
scale with actual surface content, not with the budget.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from thor_slam_tpu.mapping.tsdf import GridSpec, TsdfGrid

# Cell corners bit-packed (a, b, c) -> index a<<2 | b<<1 | c.
_CORNERS = [(a, b, c) for a in (0, 1) for b in (0, 1) for c in (0, 1)]
# The 12 cell edges as corner-index pairs (differ in exactly one bit).
_EDGES = [
    (i, j)
    for i in range(8)
    for j in range(i + 1, 8)
    if bin(i ^ j).count("1") == 1
]


@dataclass
class SurfaceMesh:
    """A compacted triangle mesh in world coordinates.

    Attributes:
        vertices: (V, 3) f32 world positions.
        colors: (V, 3) uint8 per-vertex RGB (zeros when color is off).
        triangles: (T, 3) int32 vertex indices, consistently wound with
            outward normals following the TSDF gradient.
        vertex_budget_hit: The extractor ran out of vertex slots — the
            mesh is valid but incomplete (raise ``max_vertices``).
    """

    vertices: np.ndarray
    colors: np.ndarray
    triangles: np.ndarray
    vertex_budget_hit: bool = False

    def save_ply(self, path) -> None:
        """Write binary little-endian PLY with per-vertex colors.

        The offline-mesh deliverable (nvblox's save-ply service role);
        loads in MeshLab/Open3D/Blender.
        """
        nv, nt = len(self.vertices), len(self.triangles)
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {nv}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            f"element face {nt}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        vrec = np.zeros(nv, dtype=[("xyz", np.float32, 3), ("rgb", np.uint8, 3)])
        vrec["xyz"] = self.vertices.astype(np.float32)
        vrec["rgb"] = self.colors
        frec = np.zeros(nt, dtype=[("n", np.uint8), ("idx", np.int32, 3)])
        frec["n"] = 3
        frec["idx"] = self.triangles
        with open(path, "wb") as f:
            f.write(header.encode("ascii"))
            f.write(vrec.tobytes())
            f.write(frec.tobytes())


@lru_cache(maxsize=8)
def _build_surface_points_fn(spec: GridSpec, max_points: int):
    nx, ny, nz = spec.dims
    half = 0.5 * spec.voxel_size_m

    @jax.jit
    def fn(grid: TsdfGrid):
        near = (grid.weight > 0.0) & (jnp.abs(grid.tsdf) < half)
        # nonzero prefix-packs hits: valid points are slots [0, count).
        (sel,) = jnp.nonzero(near.reshape(-1), size=max_points, fill_value=-1)
        count = jnp.sum(sel >= 0)
        idx = jnp.maximum(sel, 0)
        i = idx // (ny * nz)
        j = (idx // nz) % ny
        k = idx % nz
        pts = (
            grid.origin[None, :]
            + (jnp.stack([i, j, k], axis=-1).astype(jnp.float32) + 0.5) * spec.voxel_size_m
        )
        if spec.integrate_color:
            cols = jnp.clip(grid.color.reshape(-1, 3)[idx], 0.0, 255.0).astype(jnp.uint8)
        else:
            cols = jnp.zeros((max_points, 3), jnp.uint8)
        return pts, cols, count

    return fn


def extract_surface_points(
    grid: TsdfGrid, spec: GridSpec, max_points: int = 131072
) -> tuple[np.ndarray, np.ndarray]:
    """Surface-band voxel centers as a colored point cloud.

    Returns:
        ``(points, colors)`` — (N, 3) f32 world meters and (N, 3) uint8.
    """
    pts, cols, count = _build_surface_points_fn(spec, int(max_points))(grid)
    n = int(count)  # scalar fetch, then only the valid prefix moves
    return jax.device_get((pts[:n], cols[:n]))


@lru_cache(maxsize=8)
def _build_mesh_fn(spec: GridSpec, max_vertices: int, max_quads: int):
    nx, ny, nz = spec.dims
    cx, cy, cz = nx - 1, ny - 1, nz - 1
    n_cells = cx * cy * cz
    vs = spec.voxel_size_m
    corner_off_flat = np.array([a * ny * nz + b * nz + c for a, b, c in _CORNERS], np.int32)
    corner_pos = np.asarray(_CORNERS, np.float32) * vs  # (8, 3) within-cell offsets

    @jax.jit
    def fn(grid: TsdfGrid):
        tsdf_flat = grid.tsdf.reshape(-1)
        inside = grid.tsdf < 0.0
        observed = grid.weight > 0.0

        # --- active cells: all 8 corners observed, mixed signs ----------
        all_obs = jnp.ones((cx, cy, cz), bool)
        any_in = jnp.zeros((cx, cy, cz), bool)
        all_in = jnp.ones((cx, cy, cz), bool)
        for a, b, c in _CORNERS:
            all_obs &= observed[a : a + cx, b : b + cy, c : c + cz]
            corner_in = inside[a : a + cx, b : b + cy, c : c + cz]
            any_in |= corner_in
            all_in &= corner_in
        active = all_obs & any_in & ~all_in
        (sel,) = jnp.nonzero(active.reshape(-1), size=max_vertices, fill_value=-1)
        vert_valid = sel >= 0
        csel = jnp.maximum(sel, 0)
        ci = csel // (cy * cz)
        cj = (csel // cz) % cy
        ck = csel % cz
        vox_base = ci * (ny * nz) + cj * nz + ck
        corner_idx = vox_base[:, None] + corner_off_flat[None, :]  # (K, 8)
        v8 = tsdf_flat[corner_idx]  # (K, 8)

        # Vertex = mean of the edge zero-crossings (the Surface Nets rule).
        acc = jnp.zeros((max_vertices, 3), jnp.float32)
        cnt = jnp.zeros((max_vertices,), jnp.float32)
        for e0, e1 in _EDGES:
            va, vb = v8[:, e0], v8[:, e1]
            cross = (va < 0.0) != (vb < 0.0)
            t = jnp.clip(va / jnp.where(jnp.abs(va - vb) < 1e-12, 1e-12, va - vb), 0.0, 1.0)
            p = corner_pos[e0][None, :] + t[:, None] * (corner_pos[e1] - corner_pos[e0])[None, :]
            acc += jnp.where(cross[:, None], p, 0.0)
            cnt += cross.astype(jnp.float32)
        cell_corner_world = (
            grid.origin[None, :]
            + (jnp.stack([ci, cj, ck], axis=-1).astype(jnp.float32) + 0.5) * vs
        )
        verts = cell_corner_world + acc / jnp.maximum(cnt, 1.0)[:, None]
        if spec.integrate_color:
            col_flat = grid.color.reshape(-1, 3)
            colors = jnp.mean(col_flat[corner_idx], axis=1)  # (K, 3)
        else:
            colors = jnp.zeros((max_vertices, 3), jnp.float32)

        # Dense cell -> vertex-slot map for face lookup. Budget overflow
        # simply leaves cells unmapped (their quads drop).
        ids = jnp.full((n_cells,), -1, jnp.int32)
        scatter_at = jnp.where(vert_valid, csel, n_cells)  # OOB drops
        ids = ids.at[scatter_at].set(
            jnp.arange(max_vertices, dtype=jnp.int32), mode="drop"
        )

        # --- quads: one per sign-changing voxel edge --------------------
        tris = []
        tri_valid = []
        axes = (
            # (axis, interior slices for the two cross axes)
            (0, (slice(0, nx - 1), slice(1, ny - 1), slice(1, nz - 1))),
            (1, (slice(1, nx - 1), slice(0, ny - 1), slice(1, nz - 1))),
            (2, (slice(1, nx - 1), slice(1, ny - 1), slice(0, nz - 1))),
        )
        for axis, sl in axes:
            shift = [slice(None)] * 3
            shift[axis] = slice(1, None)
            base = [slice(None)] * 3
            base[axis] = slice(0, -1)
            in_lo = inside[tuple(base)]
            in_hi = inside[tuple(shift)]
            obs_edge = observed[tuple(base)] & observed[tuple(shift)]
            cross = ((in_lo != in_hi) & obs_edge)[sl[0], sl[1], sl[2]]
            flip_full = in_lo[sl[0], sl[1], sl[2]]
            dims_sl = cross.shape
            (esel,) = jnp.nonzero(cross.reshape(-1), size=max_quads, fill_value=-1)
            evalid = esel >= 0
            eidx = jnp.maximum(esel, 0)
            ei = eidx // (dims_sl[1] * dims_sl[2]) + sl[0].start
            ej = (eidx // dims_sl[2]) % dims_sl[1] + sl[1].start
            ek = eidx % dims_sl[2] + sl[2].start
            flip = flip_full.reshape(-1)[eidx]
            # The 4 cells cycling around the edge (right-hand rule about
            # +axis); flip when the surface faces -axis.
            u_axis, v_axis = [(1, 2), (2, 0), (0, 1)][axis]
            coords = [ei, ej, ek]
            quad_ids = []
            for du, dv in ((-1, -1), (0, -1), (0, 0), (-1, 0)):
                cc = list(coords)
                cc[u_axis] = cc[u_axis] + du
                cc[v_axis] = cc[v_axis] + dv
                flat_cell = cc[0] * (cy * cz) + cc[1] * cz + cc[2]
                quad_ids.append(ids[jnp.clip(flat_cell, 0, n_cells - 1)])
            q = jnp.stack(quad_ids, axis=-1)  # (M, 4)
            qvalid = evalid & jnp.all(q >= 0, axis=-1)
            q1 = jnp.where(flip[:, None], q[:, ::-1], q)
            tris.append(jnp.stack([q1[:, 0], q1[:, 1], q1[:, 2]], axis=-1))
            tris.append(jnp.stack([q1[:, 0], q1[:, 2], q1[:, 3]], axis=-1))
            tri_valid.extend([qvalid, qvalid])
        triangles = jnp.concatenate(tris, axis=0)
        tvalid = jnp.concatenate(tri_valid, axis=0)
        # Prefix-pack valid triangles so the host fetches only the count.
        (tsel,) = jnp.nonzero(tvalid, size=triangles.shape[0], fill_value=-1)
        triangles = triangles[jnp.maximum(tsel, 0)]
        n_tris = jnp.sum(tvalid)
        n_verts = jnp.sum(vert_valid)
        colors = jnp.clip(colors, 0.0, 255.0).astype(jnp.uint8)
        budget_hit = jnp.sum(active) > max_vertices
        return verts, colors, n_verts, triangles, n_tris, budget_hit

    return fn


def extract_mesh(
    grid: TsdfGrid,
    spec: GridSpec,
    max_vertices: int = 65536,
    max_quads: int = 65536,
) -> SurfaceMesh:
    """Extract the Surface-Nets mesh of the current zero level set."""
    fn = _build_mesh_fn(spec, int(max_vertices), int(max_quads))
    verts, colors, n_verts, triangles, n_tris, budget_hit = fn(grid)
    # Two round trips total: one batched scalar fetch, then one batched prefix fetch — valid vertices and
    # triangles are device-side prefixes, and triangle indices are vertex
    # slots = packed indices, so no host remapping is needed.
    nv, nt, hit = (int(x) for x in jax.device_get((n_verts, n_tris, budget_hit)))
    v, c, t = jax.device_get((verts[:nv], colors[:nv], triangles[:nt]))
    return SurfaceMesh(
        vertices=v,
        colors=c,
        triangles=np.asarray(t, dtype=np.int32),
        vertex_budget_hit=bool(hit),
    )
