"""SGM path aggregation as one Pallas-Triton streaming kernel (GPU path).

The SGM recurrence
    L[x] = c[x] + min(L[x-1], L[x-1] +/- 1 disparity + P1, min L[x-1] + P2)
            - min(L[x-1])
is sequential along each image path, so as XLA it is one dependent step per
pixel column or row. This kernel streams the cost volume instead: one read
of the volume and one write of each direction's aggregated volume, exact
recurrence, no halo.

Layout: each path runs over a STEP-MAJOR volume, ``(S, D, X)`` — S = path
length (W for horizontal paths, H for vertical), D = disparities, X = the
cross-section. A program owns one ``_TILE_X``-wide tile of X, so every
``(X_tile,)`` row it loads is contiguous, and walks the S steps in an inner
loop with the running cost held in registers as D separate rows. Keeping
the disparities as separate rows makes the d +/- 1 neighbours a matter of
indexing at trace time (Triton has no lane shuffle), needs no sentinel at
the disparity ends, and lets D be any size. X is padded up to the tile.

All directions run in one launch: the grid enumerates (path volume,
direction, X tile), so at 640x400 the horizontal and vertical pairs
together put 66 one-warp programs in flight, and blocks run in any order —
nothing carries between programs.

Arithmetic is float32 in registers; input and output keep the volume's
dtype. For bfloat16 volumes with integral penalties the running cost is an
exact small integer (see :func:`thor_slam_tpu.ops.stereo.sgm_disparity`),
so the result is bit-identical to the textbook recurrence.

Replaces the path-aggregation stage of the OAK StereoDepth ASIC's SGM
(reference luxonis.py:513-536).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

_TILE_X = 32  # cross-section lanes per program: one warp, one lane each
_NUM_WARPS = 1


def _tree_min(rows):
    while len(rows) > 1:
        rows = [jnp.minimum(a, b) for a, b in zip(rows[::2], rows[1::2])] + (
            [rows[-1]] if len(rows) % 2 else []
        )
    return rows[0]


def _walk(cost_ref, out_ref, rev, x0, *, p1, p2):
    """Run the recurrence over every step of one (S, D, X_tile) column.

    ``rev`` (0/1, traced) selects the walking direction and the output
    slot; the output holds both directions of this volume. Each step issues
    all D row loads before any arithmetic or store, so their memory
    latencies overlap instead of serialising behind the previous row's
    store.
    """
    steps, d, _ = cost_ref.shape
    xs = pl.ds(x0, _TILE_X)

    def body(i, prev):
        s = jnp.where(rev == 1, steps - 1 - i, i)
        c = [cost_ref[s, k, xs] for k in range(d)]
        m = _tree_min(list(prev))
        new = []
        for k in range(d):
            best = prev[k]
            if k > 0:
                best = jnp.minimum(best, prev[k - 1] + p1)
            if k < d - 1:
                best = jnp.minimum(best, prev[k + 1] + p1)
            best = jnp.minimum(best, m + p2)
            new.append(c[k].astype(jnp.float32) + (best - m))
        for k in range(d):
            out_ref[rev, s, k, xs] = new[k].astype(out_ref.dtype)
        return tuple(new)

    # A UNIFORM start makes the first step exact: best - min == 0, so
    # L[0] == c[0] without a special case.
    zero = jnp.zeros((_TILE_X,), jnp.float32)
    jax.lax.fori_loop(0, steps, body, (zero,) * d)


def _kernel(*refs, tiles, p1, p2):
    """Program ``pid`` walks one (volume, direction, X tile) job.

    ``refs`` = the step-major input volumes, then one output per volume
    holding its forward and reverse directions; ``tiles[v]`` is volume v's
    X-tile count. Job ids run volume by volume, direction fastest.
    """
    n = len(tiles)
    pid = pl.program_id(0)
    start = 0
    for v, t in enumerate(tiles):
        j = pid - start

        @pl.when((j >= 0) & (j < 2 * t))
        def _():
            _walk(refs[v], refs[n + v], j % 2, (j // 2) * _TILE_X, p1=p1, p2=p2)

        start += 2 * t


def _pad_x(vol_sdx: jnp.ndarray) -> jnp.ndarray:
    x = vol_sdx.shape[2]
    return jnp.pad(vol_sdx, ((0, 0), (0, 0), (0, -x % _TILE_X)))


@partial(jax.jit, static_argnames=("p1", "p2", "num_paths", "interpret"))
def sgm_aggregate(
    cost_dhw: jnp.ndarray,
    p1: float,
    p2: float,
    num_paths: int = 4,
    interpret: bool = False,
) -> jnp.ndarray:
    """Sum of the exact path costs of a (D, H, W) volume over 2 or 4 paths.

    Args:
        cost_dhw: (D, H, W) matching costs (bfloat16 or float32).
        p1: Small-jump penalty (|dd| = 1).
        p2: Large-jump penalty.
        num_paths: 2 (left-right and right-left) or 4 (+ top-down and
            bottom-up).
        interpret: Run the kernel in the Pallas interpreter (CPU tests).

    Returns:
        (D, H, W) float32 sum of the aggregated path costs.
    """
    d, h, w = cost_dhw.shape
    vols = [_pad_x(cost_dhw.transpose(2, 0, 1))]  # (W, D, Hp): horizontal paths
    if num_paths >= 4:
        vols.append(_pad_x(cost_dhw.transpose(1, 0, 2)))  # (H, D, Wp): vertical
    tiles = tuple(v.shape[2] // _TILE_X for v in vols)
    outs = pl.pallas_call(
        partial(_kernel, tiles=tiles, p1=float(p1), p2=float(p2)),
        grid=(2 * sum(tiles),),
        out_shape=[jax.ShapeDtypeStruct((2, *v.shape), v.dtype) for v in vols],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="sgm_aggregate",
    )(*vols)
    agg = outs[0].astype(jnp.float32).sum(0)[:, :, :h].transpose(1, 2, 0)
    if num_paths >= 4:
        agg = agg + outs[1].astype(jnp.float32).sum(0)[:, :, :w].transpose(1, 0, 2)
    return agg
