"""Range-image normal estimation as one fused elementwise stencil.

Vectorized version of the reference's rayon-chunked neighbor-difference
normals (``src/range_image/structure.rs:184-262``): the entire image is a
single stencil (shifted arrays + ``where`` selection), which XLA fuses into
one elementwise pass — no chunking, no gather.

Semantics replicated exactly, including the quirks:
* out-of-bounds or masked-out neighbors read as the zero point;
* the distance-ratio selection (threshold 2, squared = 4) decides between
  central, backward and forward differences per axis;
* 0/0 ratios produce NaN which fails both ratio comparisons — falling through
  to the same branch as Rust's NaN comparisons;
* normals with magnitude <= 1e-6 stay zero.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array

_RATIO_THRESHOLD_SQ = 4.0  # ratio_threshold = 2 (structure.rs:188)


def _axis_difference(center, backward, forward):
    """The reference's per-axis difference selection (structure.rs:215-248)
    on per-channel planes (lists of 3 (H, W) arrays).

    backward/forward are the (-) and (+) neighbors (left/right or top/bottom
    in the reference's naming: note its "bottom" is row+1 = our forward is
    `bottom`, backward is `top` for the vertical axis — see caller).
    """
    b_dist = sum((backward[c] - center[c]) ** 2 for c in range(3))
    f_dist = sum((forward[c] - center[c]) ** 2 for c in range(3))
    ratio = b_dist / f_dist
    central = (ratio < _RATIO_THRESHOLD_SQ) & (ratio > 1.0 / _RATIO_THRESHOLD_SQ)
    back_closer = b_dist < f_dist
    return [
        jnp.where(
            central,
            forward[c] - backward[c],
            jnp.where(
                back_closer, center[c] - backward[c], forward[c] - center[c]
            ),
        )
        for c in range(3)
    ]


def compute_normals(points: Array, mask: Array) -> Array:
    """(H, W, 3) points + (H, W) validity mask -> (H, W, 3) unit normals.

    Cross product of the horizontal and vertical selected differences,
    normalized; zero where degenerate. Matches
    ``RangeImage::compute_normals`` output bit-for-bit up to f32 fusion
    reassociation. Everything runs on per-channel (H, W) planes rather than
    a trailing-3 layout.
    """
    h, w = mask.shape
    mask_f = mask.astype(jnp.float32)
    center = [points[..., c].astype(jnp.float32) for c in range(3)]
    # One zero-pad per channel; every neighbor is then a STATIC slice of it
    # (the roll + border-set form costs 12 full-plane copies).
    padded = [
        jnp.pad(c * mask_f, ((1, 1), (1, 1))) for c in center
    ]  # (H+2, W+2)

    def at(dv, du):
        return [p[1 + dv : 1 + dv + h, 1 + du : 1 + du + w] for p in padded]

    left = at(0, -1)
    right = at(0, 1)
    top = at(-1, 0)
    bottom = at(1, 0)

    # Reference: center is the raw (unmasked) point value; invalid centers
    # are zero anyway because backprojection only writes valid pixels.
    # Horizontal: ratio = left/right distances; central diff = right - left.
    lr = _axis_difference(center, left, right)
    # Vertical: the reference computes bottom/top ratio with bottom = row+1;
    # central diff = top - bottom (structure.rs:229-248).
    bt = _axis_difference(center, bottom, top)

    nx = lr[1] * bt[2] - lr[2] * bt[1]
    ny = lr[2] * bt[0] - lr[0] * bt[2]
    nz = lr[0] * bt[1] - lr[1] * bt[0]
    mag = jnp.sqrt(nx * nx + ny * ny + nz * nz)
    ok = mag > 1e-6
    safe = jnp.where(ok, mag, 1.0)  # division, not reciprocal-multiply:
    zero = jnp.zeros_like(mag)  # bit-parity with the r2 form
    return jnp.stack(
        [
            jnp.where(ok, nx / safe, zero),
            jnp.where(ok, ny / safe, zero),
            jnp.where(ok, nz / safe, zero),
        ],
        axis=-1,
    )
