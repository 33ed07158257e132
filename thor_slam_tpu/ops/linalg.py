"""Small-matrix linear algebra, unrolled into fused elementwise ops.

jnp.linalg.solve / inv / cholesky on tiny systems (the 6x6 Gauss-Newton
normal equations solved dozens of times per tracking tick) lower to LU
with sequential pivoting loops — work out of all proportion to the
math. For a damped SPD system of static size n, an
UNROLLED Cholesky factor + two triangular substitutions is ~n^3/3 fused
elementwise ops that vectorize over any batch (the RANSAC hypothesis
axis rides along for free).

Every entry point requires SPD input (all call sites are Levenberg-damped
normal equations, so positive-definiteness holds by construction).
"""

from __future__ import annotations

import jax.numpy as jnp


def _chol_rows(a: jnp.ndarray) -> list[list[jnp.ndarray]]:
    """Lower-triangular Cholesky factor of (..., n, n) as unrolled scalars.

    Returns rows[i][j] (j <= i) of shape (...,). Statically unrolled over
    the (small) n; clamped diagonals keep near-singular inputs finite
    (call sites guard non-finite updates anyway).
    """
    n = a.shape[-1]
    rows: list[list[jnp.ndarray]] = [[None] * (i + 1) for i in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - rows[i][k] * rows[j][k]
            if i == j:
                rows[i][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
            else:
                rows[i][j] = s / rows[j][j]
    return rows


def _solve_from_rows(rows: list[list[jnp.ndarray]], b: jnp.ndarray) -> jnp.ndarray:
    """Solve L L^T x = b given unrolled Cholesky rows; b is (..., n)."""
    n = len(rows)
    # Forward: L y = b.
    y: list[jnp.ndarray] = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - rows[i][k] * y[k]
        y[i] = s / rows[i][i]
    # Backward: L^T x = y.
    x: list[jnp.ndarray] = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - rows[k][i] * x[k]
        x[i] = s / rows[i][i]
    return jnp.stack(x, axis=-1)


def spd_solve(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve a @ x = b for SPD ``a``: (..., n, n) @ (..., n) -> (..., n).

    Batched over leading dims; n is static and should be small (<= ~12).
    """
    return _solve_from_rows(_chol_rows(a), b)


def spd_inverse(a: jnp.ndarray) -> jnp.ndarray:
    """Inverse of SPD ``a`` (..., n, n) via n unrolled Cholesky solves."""
    n = a.shape[-1]
    rows = _chol_rows(a)
    eye = jnp.eye(n, dtype=a.dtype)
    cols = [
        _solve_from_rows(rows, jnp.broadcast_to(eye[i], a.shape[:-2] + (n,)))
        for i in range(n)
    ]
    inv = jnp.stack(cols, axis=-1)  # columns of A^-1 (== rows; symmetric)
    return 0.5 * (inv + jnp.swapaxes(inv, -1, -2))
