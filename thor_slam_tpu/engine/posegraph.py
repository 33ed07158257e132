"""Pose-graph optimization: Gauss-Newton over SE(3) relative constraints.

The loop-closure backend (cuVSLAM's internal pose-graph role). Fixed-shape
formulation: up to K nodes and E edges as dense masked arrays; the
residual of edge (i, j) is ``log(inv(T_meas) inv(X_i) X_j)`` and the full
Jacobian comes from one ``jax.jacfwd`` over the stacked (K, 6) tangent —
at pose-graph scale (hundreds of nodes) the dense (6K x 6K) normal system
is a trivial dense solve, so no sparsity machinery is needed.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from thor_slam_tpu.ops import lie


class PoseGraph(NamedTuple):
    """A fixed-capacity pose graph.

    Attributes:
        poses: (K, 4, 4) node poses (world_T_body).
        node_mask: (K,) float 1/0 — nodes in use.
        edge_i: (E,) int32 source node per edge.
        edge_j: (E,) int32 target node per edge.
        edge_t: (E, 4, 4) measured relative transforms body_i_T_body_j.
        edge_weight: (E,) float edge weights (0 disables an edge).
    """

    poses: jnp.ndarray
    node_mask: jnp.ndarray
    edge_i: jnp.ndarray
    edge_j: jnp.ndarray
    edge_t: jnp.ndarray
    edge_weight: jnp.ndarray


def sequential_graph(poses, rel_noise_weight: float = 1.0, capacity_edges: int | None = None):
    """Build odometry-chain edges from a pose sequence (host-side helper)."""
    import numpy as np

    poses = np.asarray(poses)
    k = poses.shape[0]
    e = capacity_edges or (k - 1)
    edge_i = np.zeros(e, np.int32)
    edge_j = np.zeros(e, np.int32)
    edge_t = np.tile(np.eye(4, dtype=np.float32), (e, 1, 1))
    w = np.zeros(e, np.float32)
    for idx in range(min(k - 1, e)):
        edge_i[idx] = idx
        edge_j[idx] = idx + 1
        edge_t[idx] = np.linalg.inv(poses[idx]) @ poses[idx + 1]
        w[idx] = rel_noise_weight
    return edge_i, edge_j, edge_t, w


def _residuals(deltas: jnp.ndarray, graph: PoseGraph) -> jnp.ndarray:
    """(E, 6) stacked se(3) residuals at tangent offsets ``deltas`` (K, 6)."""
    poses = jax.vmap(lambda d, x: lie.se3_exp(d) @ x)(deltas, graph.poses)

    def edge_res(i, j, t_meas, w):
        xi = poses[i]
        xj = poses[j]
        err = lie.se3_inverse(t_meas) @ (lie.se3_inverse(xi) @ xj)
        return lie.se3_log(err) * w

    return jax.vmap(edge_res)(graph.edge_i, graph.edge_j, graph.edge_t, graph.edge_weight)


@partial(jax.jit, static_argnames=("iters",))
def optimize(graph: PoseGraph, iters: int = 10, damping: float = 1e-5) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Gauss-Newton pose-graph solve; node 0 is the gauge anchor.

    Returns:
        (poses (K,4,4), final residual RMS).
    """
    k = graph.poses.shape[0]

    def step(_, poses):
        g = graph._replace(poses=poses)
        zero = jnp.zeros((k, 6))
        r = _residuals(zero, g).reshape(-1)  # (E*6,)
        jac = jax.jacfwd(lambda d: _residuals(d, g).reshape(-1))(zero)  # (E*6, K, 6)
        jac = jac.reshape(r.shape[0], k * 6)

        # Gauge + unused nodes: free mask excludes node 0 and masked nodes.
        free = graph.node_mask.at[0].set(0.0)
        sel = jnp.repeat(free, 6)
        jac = jac * sel[None, :]
        h = jac.T @ jac + damping * jnp.eye(k * 6)
        h = h + jnp.diag(1.0 - sel)  # pin fixed vars
        b = jac.T @ r
        delta = -jnp.linalg.solve(h, b)
        delta = jnp.where(jnp.all(jnp.isfinite(delta)), delta, jnp.zeros_like(delta))
        return jax.vmap(lambda d, x: lie.se3_exp(d) @ x)(delta.reshape(k, 6) * free[:, None], poses)

    poses = jax.lax.fori_loop(0, iters, step, graph.poses)
    final = _residuals(jnp.zeros((k, 6)), graph._replace(poses=poses))
    active = jnp.sum(graph.edge_weight > 0)
    rms = jnp.sqrt(jnp.sum(final**2) / jnp.maximum(active * 6, 1))
    return poses, rms
