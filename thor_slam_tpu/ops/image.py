"""Image ops in JAX: grayscale, blur, bilinear remap, resize, pyramids.

These replace the reference's delegated image path — the OAK camera ISP
resize/letterbox (reference luxonis.py:405-444) and OpenCV color conversion
in the adapter (reference isaac_ros.py:357-358) — with fused XLA ops.
All functions are shape-polymorphic at trace time but produce static shapes,
and every one of them is safe to `vmap` over leading batch axes.

Layout note: images are (H, W) or (H, W, C) float32 in [0, 1] unless a
function documents otherwise; rows are contiguous, so row-major ops
(separable convolutions along W) are the fast path.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def to_float(image: jnp.ndarray) -> jnp.ndarray:
    """uint8 [0,255] or float -> float32 [0,1]."""
    if image.dtype == jnp.uint8:
        return image.astype(jnp.float32) * (1.0 / 255.0)
    return image.astype(jnp.float32)


def to_uint8(image: jnp.ndarray) -> jnp.ndarray:
    """float [0,1] -> uint8 [0,255] with rounding."""
    return jnp.clip(jnp.round(image * 255.0), 0.0, 255.0).astype(jnp.uint8)


def rgb_to_gray(image: jnp.ndarray) -> jnp.ndarray:
    """(H, W, 3) RGB -> (H, W) luma (BT.601 weights, matching OpenCV)."""
    w = jnp.array([0.299, 0.587, 0.114], dtype=image.dtype)
    return image @ w


def bgr_to_rgb(image: jnp.ndarray) -> jnp.ndarray:
    """Channel swap for OpenCV-style BGR frames (reference isaac_ros.py:357)."""
    return image[..., ::-1]


def _gaussian_kernel1d(sigma: float, radius: int) -> jnp.ndarray:
    x = jnp.arange(-radius, radius + 1, dtype=jnp.float32)
    k = jnp.exp(-0.5 * (x / sigma) ** 2)
    return k / jnp.sum(k)


def gaussian_blur(image: jnp.ndarray, sigma: float = 1.0, radius: int | None = None) -> jnp.ndarray:
    """Separable Gaussian blur on an (H, W) image with edge replication."""
    if radius is None:
        radius = max(1, int(3.0 * sigma + 0.5))
    k = _gaussian_kernel1d(sigma, radius)
    padded = jnp.pad(image, ((radius, radius), (0, 0)), mode="edge")
    # Vertical pass: sum of shifted rows (unrolled — radius is small/static).
    h = image.shape[0]
    out = jnp.zeros_like(image)
    for i in range(2 * radius + 1):
        out = out + k[i] * jax.lax.dynamic_slice_in_dim(padded, i, h, axis=0)
    padded = jnp.pad(out, ((0, 0), (radius, radius)), mode="edge")
    w = image.shape[1]
    out2 = jnp.zeros_like(image)
    for i in range(2 * radius + 1):
        out2 = out2 + k[i] * jax.lax.dynamic_slice_in_dim(padded, i, w, axis=1)
    return out2


def remap_bilinear(image: jnp.ndarray, map_x: jnp.ndarray, map_y: jnp.ndarray) -> jnp.ndarray:
    """Sample ``image`` at fractional coordinates — the rectification core.

    Equivalent to ``cv2.remap(..., INTER_LINEAR, BORDER_CONSTANT)``:
    ``out[i, j] = image(map_y[i, j], map_x[i, j])`` with bilinear weights;
    samples falling outside the image are 0.

    Args:
        image: (H, W) float32 source.
        map_x: (Ho, Wo) x (column) source coordinates.
        map_y: (Ho, Wo) y (row) source coordinates.

    Returns:
        (Ho, Wo) float32 resampled image.
    """
    h, w = image.shape
    x0 = jnp.floor(map_x)
    y0 = jnp.floor(map_y)
    fx = map_x - x0
    fy = map_y - y0
    x0i = x0.astype(jnp.int32)
    y0i = y0.astype(jnp.int32)

    valid = (map_x >= 0) & (map_x <= w - 1) & (map_y >= 0) & (map_y <= h - 1)

    x0c = jnp.clip(x0i, 0, w - 1)
    x1c = jnp.clip(x0i + 1, 0, w - 1)
    y0c = jnp.clip(y0i, 0, h - 1)
    y1c = jnp.clip(y0i + 1, 0, h - 1)

    flat = image.reshape(-1)
    def take(yy, xx):
        return flat[(yy * w + xx).reshape(-1)].reshape(map_x.shape)

    v00 = take(y0c, x0c)
    v01 = take(y0c, x1c)
    v10 = take(y1c, x0c)
    v11 = take(y1c, x1c)

    top = v00 * (1.0 - fx) + v01 * fx
    bot = v10 * (1.0 - fx) + v11 * fx
    out = top * (1.0 - fy) + bot * fy
    return jnp.where(valid, out, 0.0)


def resize_bilinear(image: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """Bilinear resize of an (H, W) image (align_corners=False semantics)."""
    h, w = image.shape
    ys = (jnp.arange(out_h, dtype=jnp.float32) + 0.5) * (h / out_h) - 0.5
    xs = (jnp.arange(out_w, dtype=jnp.float32) + 0.5) * (w / out_w) - 0.5
    map_y, map_x = jnp.meshgrid(ys, xs, indexing="ij")
    # Clamp-to-edge (resize semantics, not border-zero).
    map_y = jnp.clip(map_y, 0.0, h - 1.0)
    map_x = jnp.clip(map_x, 0.0, w - 1.0)
    return remap_bilinear(image, map_x, map_y)


def downsample2(image: jnp.ndarray, blur: bool = True) -> jnp.ndarray:
    """Halve an (H, W) image (2x2 mean after optional Gaussian), for pyramids."""
    if blur:
        image = gaussian_blur(image, sigma=1.0, radius=2)
    h2, w2 = image.shape[0] // 2, image.shape[1] // 2
    return image[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2).mean(axis=(1, 3))


def build_pyramid(image: jnp.ndarray, num_levels: int) -> list[jnp.ndarray]:
    """Gaussian pyramid: level 0 is the input, each level halves H and W."""
    levels = [image]
    for _ in range(num_levels - 1):
        levels.append(downsample2(levels[-1]))
    return levels


def median3x3(image: jnp.ndarray) -> jnp.ndarray:
    """3x3 median filter via the 19-comparator median-of-9 network.

    Exact salt-and-pepper (dead pixel / EMI) rejection: an isolated
    extreme pixel can never be the median of its neighborhood, while
    step edges and corners pass through unblurred (unlike a Gaussian).
    Pure min/max elementwise ops — XLA fuses the whole network into one
    pass, so it is far cheaper than a sort. Edge-replicated borders.
    """
    h, w = image.shape
    p = jnp.pad(image, 1, mode="edge")
    n = [p[dy : dy + h, dx : dx + w] for dy in range(3) for dx in range(3)]

    def srt(a, b):
        n[a], n[b] = jnp.minimum(n[a], n[b]), jnp.maximum(n[a], n[b])

    # Smith's median-of-9 exchange network (19 compare-exchanges).
    for a, b in (
        (1, 2), (4, 5), (7, 8), (0, 1), (3, 4), (6, 7), (1, 2), (4, 5),
        (7, 8), (0, 3), (5, 8), (4, 7), (3, 6), (1, 4), (2, 5), (4, 7),
        (4, 2), (6, 4), (4, 2),
    ):
        srt(a, b)
    return n[4]


def sobel_gradients(image: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Sobel dI/dx, dI/dy of an (H, W) image with edge replication."""
    p = jnp.pad(image, 1, mode="edge")
    # Smooth along one axis, differentiate along the other (separable Sobel).
    sm_x = p[:, :-2] + 2.0 * p[:, 1:-1] + p[:, 2:]   # horizontal smooth
    gy = sm_x[2:, :] - sm_x[:-2, :]
    sm_y = p[:-2, :] + 2.0 * p[1:-1, :] + p[2:, :]   # vertical smooth
    gx = sm_y[:, 2:] - sm_y[:, :-2]
    return gx, gy


@partial(jax.jit, static_argnums=(1, 2))
def batched_resize(images: jnp.ndarray, out_h: int, out_w: int) -> jnp.ndarray:
    """vmap'd resize over a leading batch axis: (B, H, W) -> (B, Ho, Wo)."""
    return jax.vmap(lambda im: resize_bilinear(im, out_h, out_w))(images)


def extract_patches(image: jnp.ndarray, centers: jnp.ndarray, size: int) -> jnp.ndarray:
    """(N, size, size) patches at integer centers, as one XLA gather.

    Args:
        image: (H, W) source.
        centers: (N, 2) integer (x, y) patch centers; patches are clipped
            fully inside the image (edge replication via index clamping).
        size: Odd patch side length (static).

    Returns:
        (N, size, size) patches (exact reads of ``image``).
    """
    return extract_patches_rig(image[None], jnp.zeros(centers.shape[0], jnp.int32), centers, size)


def extract_patches_rig(
    images: jnp.ndarray, cams: jnp.ndarray, centers: jnp.ndarray, size: int
) -> jnp.ndarray:
    """(N, size, size) patches from a (C, H, W) stack; patch i from camera
    ``cams[i]`` at integer center ``centers[i]`` (clipped inside the image).
    """
    _, h, w = images.shape
    r = size // 2
    cx = jnp.clip(centers[:, 0], r, w - r - 1) - r
    cy = jnp.clip(centers[:, 1], r, h - r - 1) - r
    cut = lambda c, y, x: jax.lax.dynamic_slice(images, (c, y, x), (1, size, size))[0]
    return jax.vmap(cut)(cams, cy, cx)
