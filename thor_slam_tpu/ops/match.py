"""Binary descriptor matching: Hamming distance + mutual-NN/ratio filtering.

Replaces cuVSLAM's matcher (closed CUDA). Two distance backends:

* **SWAR popcount** on the packed uint32 words (elementwise, exact, no
  unpacking).
* **Matmul path** (``use_mxu``): unpack bits to ±1 bf16 and compute
  distances as a single matmul (`hamming = (256 - A·Bᵀ) / 2`).

All outputs are fixed-shape with explicit masks; invalid slots are driven
to +inf distance so they can never match.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from thor_slam_tpu.ops.brief import NUM_BITS

# Python scalar on purpose: a module-level jnp scalar is a DEVICE array,
# captured as a constant by every executable that uses it (see
# tracker.make_track_step).
_INF = 1e9


class Matches(NamedTuple):
    """Matches from set A into set B, fixed capacity = len(A).

    Attributes:
        idx: (N,) int32 — index into B per A-slot (undefined where invalid).
        distance: (N,) float32 Hamming distance of the match.
        valid: (N,) bool — True where a confident mutual match exists.
    """

    idx: jnp.ndarray
    distance: jnp.ndarray
    valid: jnp.ndarray


def popcount_u32(v: jnp.ndarray) -> jnp.ndarray:
    """Branch-free SWAR population count of uint32 values."""
    v = v - ((v >> jnp.uint32(1)) & jnp.uint32(0x55555555))
    v = (v & jnp.uint32(0x33333333)) + ((v >> jnp.uint32(2)) & jnp.uint32(0x33333333))
    v = (v + (v >> jnp.uint32(4))) & jnp.uint32(0x0F0F0F0F)
    return (v * jnp.uint32(0x01010101)) >> jnp.uint32(24)


def hamming_matrix_swar(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """(N, 8) x (M, 8) packed descriptors -> (N, M) Hamming distances."""
    x = desc_a[:, None, :] ^ desc_b[None, :, :]  # (N, M, 8)
    return jnp.sum(popcount_u32(x), axis=-1).astype(jnp.float32)


def unpack_to_signs(desc: jnp.ndarray) -> jnp.ndarray:
    """(N, 8) uint32 -> (N, 256) bf16 in {-1, +1} (bit 1 -> +1)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)  # (N, 8, 32)
    return (bits.reshape(desc.shape[0], NUM_BITS).astype(jnp.float32) * 2.0 - 1.0).astype(
        jnp.bfloat16
    )


def hamming_matrix_mxu(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """Hamming distances via one matmul on ±1-encoded bits.

    For a, b in {-1, +1}^256: a·b = 256 - 2*hamming, so
    hamming = (256 - a·b) / 2. Exact — the bf16 mantissa covers ±256.
    """
    sa = unpack_to_signs(desc_a)
    sb = unpack_to_signs(desc_b)
    # Explicit DEFAULT (bf16) precision: the tracker wraps its tick in
    # default_matmul_precision("float32") for subpixel/geometry exactness,
    # but THIS matmul is exact in bf16 by construction (±1 operands,
    # f32 accumulation, |sum| <= 256) — opt back into the fast path.
    corr = jax.lax.dot_general(
        sa, sb, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32, precision=jax.lax.Precision.DEFAULT,
    )
    return 0.5 * (NUM_BITS - corr)


@partial(jax.jit, static_argnames=("max_distance", "ratio", "use_mxu"))
def match_descriptors(
    desc_a: jnp.ndarray,
    valid_a: jnp.ndarray,
    desc_b: jnp.ndarray,
    valid_b: jnp.ndarray,
    max_distance: float = 64.0,
    ratio: float = 0.9,
    use_mxu: bool = True,
    allowed: jnp.ndarray | None = None,
) -> Matches:
    """Mutual nearest-neighbor matching with Lowe ratio and distance gates.

    Args:
        desc_a: (N, 8) uint32 packed descriptors (query).
        valid_a: (N,) bool.
        desc_b: (M, 8) uint32 packed descriptors (train).
        valid_b: (M,) bool.
        max_distance: Reject matches with Hamming distance above this.
        ratio: Reject unless best < ratio * second-best (set >= 1 to disable).
        use_mxu: Select the matmul backend (static; both are exact).
        allowed: Optional (N, M) bool *guided-matching* gate — pairs outside
            it can never match. Spatial gating (predicted reprojection
            windows, epipolar bands) is what makes descriptor matching
            robust in self-similar scenes; every production tracker does it.

    Returns:
        :class:`Matches` of capacity N.
    """
    if use_mxu:
        dist = hamming_matrix_mxu(desc_a, desc_b)
    else:
        dist = hamming_matrix_swar(desc_a, desc_b)
    gate = valid_a[:, None] & valid_b[None, :]
    if allowed is not None:
        gate = gate & allowed
    dist = jnp.where(gate, dist, _INF)

    # Best and second best along B for the ratio test — two rounds of
    # (min, argmin, mask) instead of lax.top_k. Tie order matches top_k
    # (first lowest index).
    best = jnp.min(dist, axis=1)
    best_idx = jnp.argmin(dist, axis=1).astype(jnp.int32)
    iota_b = jnp.arange(dist.shape[1], dtype=jnp.int32)[None, :]
    second = jnp.min(jnp.where(iota_b == best_idx[:, None], _INF, dist), axis=1)

    # Mutual check: A-row i must also be B-column best_idx[i]'s argmin.
    b_best_of_a = jnp.argmin(dist, axis=0)  # (M,)
    mutual = b_best_of_a[best_idx] == jnp.arange(dist.shape[0])

    ok = (
        (best <= max_distance)
        & (best < ratio * jnp.maximum(second, 1e-6))
        & mutual
        & valid_a
    )
    return Matches(idx=best_idx.astype(jnp.int32), distance=best, valid=ok)
