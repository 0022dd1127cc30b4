"""Masked pyramid downsampling of range-image points/normals.

Counterpart of the reference ``src/range_image/resize.rs``: each destination
pixel looks at the 2x2 source neighborhood at ``(floor(v * ratio),
floor(u * ratio))``, takes the masked mean, and picks the source value
nearest to that mean ("nearest-to-mean" pick). Empty neighborhoods produce
mask 0 / zero values.

Exact half-resolution step: row pairs split by a reshape-select, and the
even/odd COLUMN extraction runs as one contraction per tap against a
constant 0/1 selection matrix (exact: one unit weight per output column).
The nearest-to-mean pick is then a running compare-select on full-width
(dh, dw) planes.
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np

from align3d_tpu.config import MATMUL_PRECISION

Array = jax.Array


@lru_cache(maxsize=None)
def _col_select(w: int, du: int):
    """(w, w//2) 0/1 matrix picking columns du::2 — decimation as a contraction."""
    dw = w // 2
    s = np.zeros((w, dw), np.float32)
    s[np.arange(dw) * 2 + du, np.arange(dw)] = 1.0
    return s


def _window_taps(src: Array, src_v: Array, src_u: Array) -> list[Array]:
    """The 2x2 window as a list of 4 (dst_h, dst_w, ...) arrays in
    ((0,0), (0,1), (1,0), (1,1)) offset order."""
    h, w = src.shape[0], src.shape[1]
    dh, dw = src_v.shape[0], src_u.shape[0]
    taps = []
    if h == 2 * dh and w == 2 * dw:
        planar = src.ndim == 2
        chans = 1 if planar else src.shape[2]
        planes = [src] if planar else [src[..., c] for c in range(chans)]
        for dv in (0, 1):
            rows = [x.reshape(dh, 2, w)[:, dv] for x in planes]  # (dh, w)
            for du in (0, 1):
                sel = jnp.asarray(_col_select(w, du))
                picked = [
                    jnp.einsum(
                        "hw,wd->hd",
                        x,
                        sel,
                        preferred_element_type=jnp.float32,
                        precision=MATMUL_PRECISION,
                    )
                    for x in rows
                ]
                # Keep taps as per-channel PLANES — the select math below
                # runs on full-width (dh, dw) arrays.
                taps.append(picked[0] if planar else picked)
    else:
        for dv in (0, 1):
            for du in (0, 1):
                vv = jnp.clip(src_v + dv, 0, h - 1)
                uu = jnp.clip(src_u + du, 0, w - 1)
                taps.append(src[vv[:, None], uu[None, :]])
    return taps


def resize_nearest_to_mean(
    src_values: Array, src_mask: Array, dst_height: int, dst_width: int
) -> tuple[Array, Array]:
    """(H, W, 3) values + (H, W) mask -> ((dst_h, dst_w, 3), (dst_h, dst_w) mask).

    Used for both points (resize_range_points, resize.rs:42-74) and normals
    (resize_range_normals, resize.rs:76-104 — which also keys off the point
    mask); callers discard the mask for normals.
    """
    src_h, src_w = src_values.shape[:2]
    chans = src_values.shape[2]
    height_ratio = src_h / dst_height
    width_ratio = src_w / dst_width
    src_v = (jnp.arange(dst_height, dtype=jnp.float32) * height_ratio).astype(jnp.int32)
    src_u = (jnp.arange(dst_width, dtype=jnp.float32) * width_ratio).astype(jnp.int32)

    vals = _window_taps(src_values.astype(jnp.float32), src_v, src_u)
    masks = _window_taps(src_mask.astype(jnp.float32), src_v, src_u)
    if not isinstance(vals[0], list):  # general path: split into planes
        vals = [[v[..., c] for c in range(chans)] for v in vals]

    count = masks[0] + masks[1] + masks[2] + masks[3]
    any_valid = count > 0
    safe_count = jnp.where(any_valid, count, 1.0)
    means = [
        sum(v[c] * m for v, m in zip(vals, masks)) / safe_count
        for c in range(chans)
    ]

    # Nearest-to-mean: running compare-select; strict < keeps the FIRST tap
    # on ties, matching argmin over the tap axis (and the reference's scan).
    # All math runs on full-width per-channel planes.
    best_val = None
    best_dist = None
    for v, m in zip(vals, masks):
        dist = sum((v[c] - means[c]) ** 2 for c in range(chans))
        dist = jnp.where(m > 0, dist, jnp.inf)
        if best_val is None:
            best_val, best_dist = list(v), dist
        else:
            better = dist < best_dist
            best_dist = jnp.where(better, dist, best_dist)
            best_val = [
                jnp.where(better, v[c], best_val[c]) for c in range(chans)
            ]

    out_vals = jnp.stack(
        [jnp.where(any_valid, b, 0.0) for b in best_val], axis=-1
    )
    return out_vals, any_valid
