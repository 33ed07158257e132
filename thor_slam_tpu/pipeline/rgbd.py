"""The RGB-D product stream: dense SGM depth aligned with an RGB image.

This is the nvblox feed contract the reference implements with the OAK
ASIC's StereoDepth + host Sync + RGBDPublisher (reference
luxonis.py:513-549, run_pipeline.py:166-292): per configured camera, an
aligned (rgb, depth) pair at resolutions independent of the SLAM stream,
depth encoded 16UC1 millimeters (reference run_pipeline.py:247-252).

Compute is one jitted pipeline per camera: full-frame rectification (the
one place the framework still remaps images — this path runs at the
consumer's rate, not the tracker's), SGM, invalid masking, u16 encode,
and resize to the configured output resolution.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from thor_slam_tpu.camera.types import Intrinsics, SynchronizedFrameSet
from thor_slam_tpu.ops import stereo
from thor_slam_tpu.ops.image import remap_bilinear, resize_bilinear
from thor_slam_tpu.ops.rectify import StereoRectification, rectification_from_extrinsics


@dataclass
class RGBDFrame:
    """One aligned RGB-D product frame.

    Attributes:
        rgb: (H, W) or (H, W, 3) uint8 image at the RGB output resolution.
        depth_mm: (H, W) uint16 depth in millimeters (0 = invalid).
        intrinsics: Intrinsics of the aligned pair (rectified model scaled
            to the output resolution).
        timestamp: Source frame timestamp.
        camera_name: Source name.

    ``rgb``/``depth_mm`` are host numpy arrays when produced with the
    default ``fetch=True``, and DEVICE-RESIDENT ``jax.Array``\\ s with
    ``fetch=False`` — the zero-host-round-trip feed for the in-process
    :class:`~thor_slam_tpu.pipeline.mapper.DenseMapper` (the nvblox
    integrate-at-sensor-rate contract, reference
    launch/thor_nvblox.launch.py:62-91). Call :meth:`fetched` at consumer
    edges (ROS publish, disk) that need host bytes.
    """

    rgb: np.ndarray
    depth_mm: np.ndarray
    intrinsics: Intrinsics
    timestamp: float
    camera_name: str

    @property
    def device_resident(self) -> bool:
        """Whether the image payloads still live on the accelerator."""
        return not isinstance(self.depth_mm, np.ndarray)

    def fetched(self) -> "RGBDFrame":
        """Host copy of this frame (one batched d2h; self if already host)."""
        if not self.device_resident:
            return self
        import jax

        rgb, depth = jax.device_get((self.rgb, self.depth_mm))
        return RGBDFrame(
            rgb=rgb,
            depth_mm=depth,
            intrinsics=self.intrinsics,
            timestamp=self.timestamp,
            camera_name=self.camera_name,
        )


def make_depth_to_color_aligner(
    sr: StereoRectification,
    color_matrix: np.ndarray,
    rect_t_color: np.ndarray,
    out_wh: tuple[int, int],
    iters: int = 2,
    z_init: float = 2.0,
    min_depth_m: float = 0.05,
):
    """Jitted ``depth_rect -> depth_color``: depth along the COLOR rays.

    The role the reference delegates to the camera ASIC's
    ``setDepthAlign(CAM_A)`` (reference luxonis.py:538-549). Design: a
    forward splat would be a scatter with collisions, so alignment runs as
    an INVERSE warp with a short fixed-point iteration — for every color
    output pixel, guess its depth, project the implied 3D point into the
    rectified-left depth map, read the depth there, lift it back into the
    color frame, repeat. Converges wherever depth is locally smooth (the
    baseline between imagers is centimeters, so the parallax correction is
    a few pixels); depth discontinuities land within a pixel of the true
    occlusion boundary, exactly like ASIC aligners.

    Args:
        sr: The stereo rectification (depth lives in its left frame).
        color_matrix: 3x3 color camera matrix AT the output resolution.
        rect_t_color: (4, 4) pose of the color imager in the RECTIFIED
            left frame (rectifying rotation composed with left_T_color).
        out_wh: Color output (width, height).
        iters: Fixed-point iterations (static).
        z_init: Initial depth guess (meters).
        min_depth_m: Sampled depths below this are invalid (holes).

    Returns:
        A jitted function ``(H_rect, W_rect) f32 depth -> (H_out, W_out)
        f32 depth`` (0 = invalid) in the color frame.
    """
    out_w, out_h = out_wh
    kc = np.asarray(color_matrix, np.float64)
    fx_c, fy_c, cx_c, cy_c = kc[0, 0], kc[1, 1], kc[0, 2], kc[1, 2]
    kr = np.asarray(sr.new_matrix, np.float64)
    fx_r, fy_r, cx_r, cy_r = kr[0, 0], kr[1, 1], kr[0, 2], kr[1, 2]
    r = np.asarray(rect_t_color[:3, :3], np.float32)
    t = np.asarray(rect_t_color[:3, 3], np.float32)
    h_r, w_r = sr.height, sr.width

    uu, vv = np.meshgrid(np.arange(out_w, dtype=np.float32), np.arange(out_h, dtype=np.float32))
    ray = np.stack(
        [(uu - cx_c) / fx_c, (vv - cy_c) / fy_c, np.ones_like(uu)], axis=-1
    ).astype(np.float32)  # (H, W, 3) color-frame rays

    @jax.jit
    def align(depth_rect: jnp.ndarray) -> jnp.ndarray:
        z = jnp.full((out_h, out_w), z_init, jnp.float32)
        d = jnp.zeros((out_h, out_w), jnp.float32)
        u = jnp.zeros((out_h, out_w), jnp.float32)
        v = jnp.zeros((out_h, out_w), jnp.float32)
        for _ in range(iters):
            p_c = ray * z[..., None]
            p_r = p_c @ r.T + t
            zr = jnp.maximum(p_r[..., 2], 1e-6)
            u = fx_r * p_r[..., 0] / zr + cx_r
            v = fy_r * p_r[..., 1] / zr + cy_r
            d = remap_bilinear(depth_rect, u, v)
            # Lift the sampled rect-frame depth back into the color frame.
            xr = (u - cx_r) / fx_r * d
            yr = (v - cy_r) / fy_r * d
            p_r2 = jnp.stack([xr, yr, d], axis=-1)
            z = ((p_r2 - t) @ r)[..., 2]
        in_bounds = (u >= 0) & (u <= w_r - 1) & (v >= 0) & (v <= h_r - 1)
        valid = in_bounds & (d > min_depth_m) & (z > min_depth_m)
        return jnp.where(valid, z, 0.0)

    return align


class RGBDProcessor:
    """Produces RGB-D frames for one stereo camera source.

    Two modes (the reference's two RGB-D configurations):

    * grayscale: rgb = the rectified left image, depth in the rectified
      left frame (no color imager needed);
    * color-aligned: rgb = the CAM_A COLOR image and depth reprojected
      into the color camera at an independent output resolution — what
      nvblox actually consumes from the reference (reference
      luxonis.py:464-549).
    """

    def __init__(
        self,
        camera_name: str,
        intrinsics: list[Intrinsics],
        extrinsics: list,
        output_resolution: tuple[int, int] | None = None,
        num_disparities: int = 64,
        color_intrinsics: Intrinsics | None = None,
        left_t_color: np.ndarray | None = None,
    ) -> None:
        """Build rectification maps and the jitted depth pipeline.

        Args:
            camera_name: Source name (topic naming).
            intrinsics: [left, right] raw intrinsics.
            extrinsics: [left, right] source-frame extrinsics.
            output_resolution: (width, height) of the product; defaults to
                the stereo resolution (grayscale mode) or the color
                resolution (color mode) — independent of the SLAM stream.
            num_disparities: SGM search range.
            color_intrinsics: COLOR imager intrinsics (enables color mode).
            left_t_color: (4, 4) pose of the color imager in the raw LEFT
                camera frame (driver ``get_rgb_extrinsics``).
        """
        self.camera_name = camera_name
        self._sr: StereoRectification = rectification_from_extrinsics(
            intrinsics[0], intrinsics[1], extrinsics[0], extrinsics[1]
        )
        self._color = color_intrinsics is not None and left_t_color is not None
        self._left_t_color = left_t_color
        if self._color:
            default_out = (color_intrinsics.width, color_intrinsics.height)
        else:
            default_out = (self._sr.width, self._sr.height)
        self._out_w, self._out_h = output_resolution or default_out
        self._num_disp = num_disparities
        self._align = None
        if self._color:
            # Color K at the OUTPUT resolution; depth lives in the
            # rectified-left frame, so compose the rectifying rotation
            # into the color extrinsics.
            kc = np.asarray(color_intrinsics.matrix, np.float64).copy()
            kc[0, :] *= self._out_w / color_intrinsics.width
            kc[1, :] *= self._out_h / color_intrinsics.height
            rect4 = np.eye(4)
            rect4[:3, :3] = self._sr.rect_rotation_left
            rect_t_color = rect4 @ np.asarray(left_t_color, np.float64)
            self._align = make_depth_to_color_aligner(
                self._sr, kc, rect_t_color, (self._out_w, self._out_h)
            )
            self._color_out_matrix = kc

        sr = self._sr
        maps = (
            jnp.asarray(sr.map_left[0]),
            jnp.asarray(sr.map_left[1]),
            jnp.asarray(sr.map_right[0]),
            jnp.asarray(sr.map_right[1]),
        )
        out_w, out_h = self._out_w, self._out_h
        align = self._align

        def rect_depth(left_raw, right_raw):
            left = remap_bilinear(left_raw, maps[0], maps[1])
            right = remap_bilinear(right_raw, maps[2], maps[3])
            disp, valid = stereo.sgm_disparity(left, right, num_disparities=num_disparities)
            depth = stereo.disparity_to_depth(disp, valid, sr.fx, sr.baseline_m)
            return left, depth

        @partial(jax.jit, static_argnames=())
        def compute(left_raw, right_raw):
            left, depth = rect_depth(left_raw, right_raw)
            if (out_h, out_w) != left.shape:
                depth = resize_bilinear(depth, out_h, out_w)
                left = resize_bilinear(left, out_h, out_w)
            depth_mm = stereo.depth_to_millimeters_u16(depth)
            rgb_u8 = jnp.clip(jnp.round(left * 255.0), 0, 255).astype(jnp.uint8)
            return rgb_u8, depth_mm

        @partial(jax.jit, static_argnames=())
        def compute_color(left_raw, right_raw, color_img):
            _, depth = rect_depth(left_raw, right_raw)
            depth_c = align(depth)
            depth_mm = stereo.depth_to_millimeters_u16(depth_c)
            if color_img.shape[:2] != (out_h, out_w):
                chans = [
                    resize_bilinear(color_img[..., c].astype(jnp.float32), out_h, out_w)
                    for c in range(color_img.shape[-1])
                ]
                color_img = jnp.clip(
                    jnp.round(jnp.stack(chans, axis=-1)), 0, 255
                ).astype(jnp.uint8)
            return color_img, depth_mm

        self._compute = compute
        self._compute_color = compute_color if self._color else None

        # Intrinsics of the product: the color camera's model in color
        # mode, else the rectified model — both scaled to the output size.
        if self._color:
            self._out_intrinsics = Intrinsics(
                width=self._out_w, height=self._out_h,
                matrix=self._color_out_matrix, coeffs=np.zeros(5),
            )
        else:
            k = sr.new_matrix.copy()
            k[0, :] *= self._out_w / sr.width
            k[1, :] *= self._out_h / sr.height
            self._out_intrinsics = Intrinsics(
                width=self._out_w, height=self._out_h, matrix=k, coeffs=np.zeros(5)
            )

    @property
    def output_intrinsics(self) -> Intrinsics:
        return self._out_intrinsics

    @property
    def product_t_in_left(self) -> np.ndarray:
        """(4, 4) pose of the PRODUCT frame in the raw left-camera frame.

        The RGB-D pair lives in the rectified-left frame (grayscale mode)
        or the color camera frame (color mode). Downstream consumers that
        need the product's world pose (the dense mapper) compose
        ``world_T_body @ body_T_left @ product_t_in_left``.
        """
        if self._color:
            return np.asarray(self._left_t_color, np.float64)
        m = np.eye(4)
        m[:3, :3] = np.asarray(self._sr.rect_rotation_left, np.float64).T
        return m

    @property
    def color_mode(self) -> bool:
        """Whether this processor produces color-aligned RGB-D."""
        return self._color

    def process(
        self,
        frame_set: SynchronizedFrameSet,
        color_frame=None,
        fetch: bool = True,
    ) -> RGBDFrame | None:
        """Produce the RGB-D frame for this camera from a synchronized tick.

        Args:
            frame_set: The rig tick ([left, right] frames for this source).
            color_frame: The color :class:`CameraFrame` to align depth to
                (color mode; drained separately from the SLAM stream, as
                in the reference — reference run_pipeline.py:624-631).
            fetch: Materialize the product on the host (default — the
                publishing contract). ``fetch=False`` returns the frame
                with DEVICE-RESIDENT arrays and never syncs: the dense
                mapper consumes it where it lives, so depth->TSDF costs
                zero host round trips (sensor-rate integration); call
                :meth:`RGBDFrame.fetched` at edges that need host bytes.
        """
        frames = frame_set.get_frames_for_source(self.camera_name)
        if frames is None or len(frames) < 2:
            return None
        left = jnp.asarray(frames[0].image.astype(np.float32) / 255.0)
        right = jnp.asarray(frames[1].image.astype(np.float32) / 255.0)
        if self._compute_color is not None and color_frame is not None:
            rgb, depth_mm = self._compute_color(
                left, right, jnp.asarray(color_frame.image)
            )
            ts = color_frame.timestamp
        else:
            rgb, depth_mm = self._compute(left, right)
            ts = frames[0].timestamp
        if fetch:
            rgb, depth_mm = jax.device_get((rgb, depth_mm))
        return RGBDFrame(
            rgb=rgb,
            depth_mm=depth_mm,
            intrinsics=self._out_intrinsics,
            timestamp=ts,
            camera_name=self.camera_name,
        )
