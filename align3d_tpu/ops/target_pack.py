"""Packed per-pixel target tables for the projective ICP inner loop.

The reference's inner loop (src/icp/image_icp.rs:106-137) reads, per source
pixel, the target point/normal/valid at the nearest projected pixel plus 12
bilinear taps of the intensity map (value + two numeric-gradient offsets,
src/intensity_map.rs:150-210).  Expressed naively that is ~15 gathers per
Gauss-Newton iteration, each a separate scattered read of the target.

This module packs everything those reads need into wide per-pixel tables so
one iteration needs exactly TWO row gathers:

* ``pack_geometry`` -> (H*W, 8): [px py pz nx ny nz valid pad], indexed by the
  nearest projected pixel (trunc(u + 0.5), image_icp.rs:108).
* ``pack_intensity_taps`` -> (H*W, 12): the 3x3 tap neighborhood
  I[v0+dv, u0+du], dv,du in {0,1,2} (+3 pad lanes), indexed by the bilinear
  base pixel (trunc(u), trunc(v)).  The 9 taps reconstruct the reference's
  bilinear value AND both numeric-gradient samples exactly, including the
  cell-crossing case where u + 0.005 lands in the next cell
  (src/intensity_map.rs:184-210): crossing just selects the shifted 2x2
  sub-quad of the same 3x3 neighborhood.

Both tables are built once per align from dense shifts/stacks (no gathers)
and reused across all GN iterations and pyramid levels' inner loops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from align3d_tpu.ops.intensity import GRAD_H, GRAD_H_INV

Array = jax.Array

GEO_CHANNELS = 8
TAP_CHANNELS = 12


def pack_geometry(points: Array, normals: Array, mask: Array) -> Array:
    """(H, W, 3), (H, W, 3), (H, W) -> (H*W, 8) f32 row table."""
    h, w = mask.shape
    n = h * w
    cols = [
        points.reshape(n, 3),
        normals.reshape(n, 3),
        mask.reshape(n, 1).astype(jnp.float32),
        jnp.zeros((n, 1), jnp.float32),
    ]
    return jnp.concatenate(cols, axis=1)


def pack_intensity_taps(intensity_map: Array) -> Array:
    """(H+2, W+2) bordered map -> (H*W, 12) f32 tap table.

    Row (v * W + u) holds I[v+dv, u+du] for (dv, du) in row-major {0,1,2}^2.
    The map's 2-px replicated border (src/intensity_map.rs:37-79) supplies the
    out-of-range taps exactly as the reference's unchecked indexing would.
    """
    h2, w2 = intensity_map.shape
    h, w = h2 - 2, w2 - 2
    taps = [
        intensity_map[dv : dv + h, du : du + w].reshape(h * w)
        for dv in range(3)
        for du in range(3)
    ]
    taps.append(jnp.zeros((h * w,), jnp.float32))
    taps.append(jnp.zeros((h * w,), jnp.float32))
    taps.append(jnp.zeros((h * w,), jnp.float32))
    return jnp.stack(taps, axis=1)


def _lerp2(t00, t01, t10, t11, fu, fv):
    a = t00 * (1.0 - fu) + t01 * fu
    b = t10 * (1.0 - fu) + t11 * fu
    return a * (1.0 - fv) + b * fv


def taps_bilinear_grad(
    taps: Array, u: Array, v: Array
) -> tuple[Array, Array, Array]:
    """Reference bilinear + numeric gradient from gathered 3x3 taps.

    ``taps`` is (..., 12) rows from :func:`pack_intensity_taps` at base
    (trunc(v), trunc(u)); ``u``/``v`` are the (clamped, >= 0) sample
    coordinates.  Reproduces src/intensity_map.rs:150-210 bit-for-bit:
    value = bilinear(u, v), du = (bilinear(u + H, v) - value) / H, dv
    likewise.  The +H sample re-truncates — fractions are computed as
    (u + H) - trunc(u + H), NOT frac(u) + H, which rounds differently and
    would perturb the x200-amplified gradient — and crossing into the next
    cell selects the shifted 2x2 sub-quad of the 3x3 neighborhood.
    """
    return bilinear_grad_from_taps(jnp.moveaxis(taps, -1, 0), u, v)


def bilinear_grad_from_taps(t, u: Array, v: Array) -> tuple[Array, Array, Array]:
    """:func:`taps_bilinear_grad` on taps given as a sequence ``t[0..8]``
    of arrays shaped like ``u`` (the fused ICP kernel's per-pixel vectors)."""
    u0 = jnp.trunc(u)
    v0 = jnp.trunc(v)
    fu = u - u0
    fv = v - v0

    value = _lerp2(t[0], t[1], t[3], t[4], fu, fv)

    # u + H sample: re-truncate exactly like the reference.
    uh_c = u + jnp.float32(GRAD_H)
    u0h = jnp.trunc(uh_c)
    cross_u = u0h > u0
    fuh = uh_c - u0h
    u00 = jnp.where(cross_u, t[1], t[0])
    u01 = jnp.where(cross_u, t[2], t[1])
    u10 = jnp.where(cross_u, t[4], t[3])
    u11 = jnp.where(cross_u, t[5], t[4])
    uh = _lerp2(u00, u01, u10, u11, fuh, fv)

    vh_c = v + jnp.float32(GRAD_H)
    v0h = jnp.trunc(vh_c)
    cross_v = v0h > v0
    fvh = vh_c - v0h
    v00 = jnp.where(cross_v, t[3], t[0])
    v01 = jnp.where(cross_v, t[4], t[1])
    v10 = jnp.where(cross_v, t[6], t[3])
    v11 = jnp.where(cross_v, t[7], t[4])
    vh = _lerp2(v00, v01, v10, v11, fu, fvh)

    ginv = jnp.float32(GRAD_H_INV)
    return value, (uh - value) * ginv, (vh - value) * ginv
