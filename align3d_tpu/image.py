"""RGB-D image containers and color conversions.

Counterpart of the reference's ``src/image/`` module group. Frames are loaded
on the host (PIL/numpy) and become device arrays at the RangeImage boundary.

Luma conversions mirror the reference exactly:
* ``rgb_to_luma_u8`` — 0.3/0.59/0.11 weights with truncation
  (reference ``src/image/luma.rs:75-83``), used for ICP intensity terms.
* Gaussian blur + stride-2 color downsample mirrors
  ``image::imageops::blur`` semantics (f32 intermediate, kernel support
  2*sigma, replicated borders) used by ``py_scale_down``
  (reference ``src/image/rgb.rs:74-84``).
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np

from align3d_tpu.config import MATMUL_PRECISION
from align3d_tpu.camera import CameraIntrinsics
from align3d_tpu.se3 import Transform

Array = jax.Array


@dataclasses.dataclass
class RgbdImage:
    """Color (H, W, 3) u8 + depth (H, W) u16 + depth scale (src/image/rgbd_image.rs:13)."""

    color: np.ndarray
    depth: np.ndarray
    depth_scale: float | None = None

    @property
    def width(self) -> int:
        return self.color.shape[1]

    @property
    def height(self) -> int:
        return self.color.shape[0]

    def downsample(self, sigma: float) -> "RgbdImage":
        """Half-resolution copy: Gaussian-blurred stride-2 color + bilateral
        filter-then-decimate depth (reference ``Downsample for RgbdImage``,
        src/image/rgbd_image.rs:45-59)."""
        from align3d_tpu.ops.bilateral import BilateralFilter

        color = np.asarray(py_scale_down(jnp.asarray(self.color), sigma))
        depth = np.asarray(
            BilateralFilter().scale_down(jnp.asarray(self.depth))
        ).astype(self.depth.dtype)
        return RgbdImage(color=color, depth=depth, depth_scale=self.depth_scale)


@dataclasses.dataclass
class RgbdFrame:
    """Camera intrinsics + optional GT pose + RGB-D image (src/image/rgbd_image.rs:62)."""

    camera: CameraIntrinsics
    image: RgbdImage
    camera_to_world: Transform | None = None

    def get_pinhole_camera(self):
        """Intrinsics + pose, when ground truth exists (rgbd_image.rs:88-93)."""
        from align3d_tpu.camera import PinholeCamera

        if self.camera_to_world is None:
            return None
        return PinholeCamera(self.camera, self.camera_to_world)

    def downsample(self, sigma: float) -> "RgbdFrame":
        """Half resolution: image downsampled, intrinsics scaled by 0.5
        (reference ``Downsample for RgbdFrame``, src/image/rgbd_image.rs:95-106)."""
        image = self.image.downsample(sigma)
        # The reference's scale() keeps width/height (src/camera.rs:119-128);
        # we additionally sync them to the decimated image so the frame stays
        # internally consistent.
        camera = self.camera.scale(0.5).with_size(image.width, image.height)
        return RgbdFrame(
            camera=camera, image=image, camera_to_world=self.camera_to_world
        )


def rgb_to_luma(r, g, b):
    """Normalized [0,1] luma (reference src/image/luma.rs:75-79)."""
    return (r * 0.3 + g * 0.59 + b * 0.11) * (1.0 / 255.0)


def rgb_to_luma_u8(rgb: Array) -> Array:
    """(..., 3) u8 RGB -> (...,) u8 luma, truncating like Rust ``as u8``.

    Reference src/image/luma.rs:81-83.
    """
    rgb = rgb.astype(jnp.float32)
    luma = rgb[..., 0] * 0.3 + rgb[..., 1] * 0.59 + rgb[..., 2] * 0.11
    return luma.astype(jnp.uint8)  # f32 -> u8 truncates toward zero


def _blur_offsets_weights(sigma: float) -> tuple[int, int, np.ndarray]:
    """Integer tap offsets + normalized Gaussian weights.

    Mirrors the windowing of ``image::imageops::sample``: for ratio-1
    resampling the window is ``floor(0.5 - 2s) ..= ceil(0.5 + 2s) - 1`` around
    each pixel, with weights ``gaussian(offset)`` normalized to sum 1.
    """
    sigma = 1.0 if sigma <= 0.0 else sigma
    support = 2.0 * sigma
    lo = int(math.floor(0.5 - support))
    hi = int(math.ceil(0.5 + support))  # exclusive
    offs = np.arange(lo, hi)
    w = np.exp(-(offs.astype(np.float64) ** 2) / (2.0 * sigma * sigma))
    w /= w.sum()
    return lo, hi, w.astype(np.float32)


def gaussian_blur(image: Array, sigma: float) -> Array:
    """Separable Gaussian blur with replicated borders; f32 in/out.

    Vertical pass then horizontal, matching ``imageops::blur``'s order.
    ``image`` is (H, W) or (H, W, C).
    """
    lo, hi, weights = _blur_offsets_weights(sigma)
    img = image.astype(jnp.float32)

    def pass_axis(x: Array, axis: int) -> Array:
        # Edge-replicate pad once, then STATIC slices per tap (an index-array
        # take would lower to a gather; slices are free).
        n = x.shape[axis]
        pad = [(0, 0)] * x.ndim
        pad[axis] = (-lo, hi - 1)
        xp = jnp.pad(x, pad, mode="edge")
        acc = None
        for k, w in enumerate(weights):
            sl = [slice(None)] * x.ndim
            sl[axis] = slice(k, k + n)
            term = w * xp[tuple(sl)]
            acc = term if acc is None else acc + term
        return acc

    return pass_axis(pass_axis(img, 0), 1)


def _hblur_decimate_matrix(w: int, sigma: float):
    """(w, w//2) matrix = horizontal Gaussian blur (edge-replicated, the
    ``jnp.pad(mode='edge')`` semantics) fused with even-column decimation —
    one contraction replaces the per-tap shifts AND the stride-2
    decimation."""
    import numpy as np

    lo, hi, weights = _blur_offsets_weights(sigma)
    dw = w // 2
    m = np.zeros((w, dw), np.float32)
    for k, wt in enumerate(weights):
        src = np.clip(np.arange(dw) * 2 + lo + k, 0, w - 1)
        np.add.at(m, (src, np.arange(dw)), np.float32(wt))
    return m


def py_scale_down(color: Array, sigma: float) -> Array:
    """Gaussian blur then stride-2 decimation of a (H, W, 3) u8 image.

    Reference ``py_scale_down`` (src/image/rgb.rs:74-84): blur in f32, sample
    at (2i, 2j), truncate back to u8. Even-sized images take the fast
    path: per-channel planes, vertical taps evaluated only at even output
    rows (reshape-selects), and the horizontal blur+decimation as one
    constant banded matmul.
    """
    h2, w2 = color.shape[0] // 2, color.shape[1] // 2
    hh, ww = color.shape[0], color.shape[1]
    if hh == 2 * h2 and ww == 2 * w2 and color.ndim == 3:
        lo, hi, weights = _blur_offsets_weights(sigma)
        m = jnp.asarray(_hblur_decimate_matrix(ww, sigma))
        outs = []
        for c in range(color.shape[2]):
            x = color[..., c].astype(jnp.float32)
            xp = jnp.pad(x, ((-lo, hi - 1), (0, 0)), mode="edge")
            acc = None
            for k, wt in enumerate(weights):
                # Vertical tap, sampled at even output rows only.
                t = wt * xp[k : k + hh].reshape(h2, 2, ww)[:, 0]
                acc = t if acc is None else acc + t
            outs.append(
                jnp.einsum(
                    "hw,wd->hd",
                    acc,
                    m,
                    preferred_element_type=jnp.float32,
                    precision=MATMUL_PRECISION,
                )
            )
        sampled = jnp.stack(outs, axis=-1)
        return jnp.clip(sampled, 0.0, 255.0).astype(jnp.uint8)

    blurred = gaussian_blur(color, sigma)
    sampled = _decimate2(blurred, h2, w2)
    return jnp.clip(sampled, 0.0, 255.0).astype(jnp.uint8)


def _decimate2(x: Array, h: int, w: int) -> Array:
    """x[:2h:2, :2w:2] without stride-2 slices (reshape-pair + static
    index is contiguous)."""
    if x.shape[0] == 2 * h and x.shape[1] == 2 * w:
        return x.reshape((h, 2, w, 2) + x.shape[2:])[:, 0, :, 0]
    return x[: 2 * h : 2, : 2 * w : 2]


def normalize_to_luma_u8(image: Array) -> Array:
    """f32 image -> u8 via (x - min) / (max - min) * 255 (src/image/luma.rs:9-27)."""
    image = image.astype(jnp.float32)
    mx = jnp.max(image)
    mn = jnp.min(image)
    return (((image - mn) / (mx - mn)) * 255.0).astype(jnp.uint8)
