"""Fused projective-ICP Gauss-Newton step: a Pallas kernel on the Triton route.

The ``xla`` engine (:func:`align3d_tpu.icp.image_icp.icp_step`) gathers one
row of the packed geometry table and one row of the tap table per source
pixel, forms residuals and Jacobians, and contracts them into two 6x6
systems; XLA materialises the per-pixel rows between its fusions. This
kernel does the same work for one block of ``block`` source pixels of one
pair per program, entirely in registers:

* transform, project and nearest-pixel association (``trunc(u + 0.5)``,
  reference ``image_icp.rs:106-114``) gather straight from the target tables
  in device memory — the same tables (:mod:`align3d_tpu.ops.target_pack`)
  and the same gates as the ``xla`` engine, so association is exact;
* the photometric term reuses :func:`bilinear_grad_from_taps`;
* each program writes the 29 partial sums of each system (upper triangle of
  H, g, sum w r^2, sum w) to its own row of a ``(B, nblocks, 64)`` output,
  and XLA adds the rows afterwards. Blocks run in any order and write
  disjoint rows, so the result is deterministic; nothing is atomic.

Sums accumulate in float32. The source pack is padded to a whole number of
blocks; padded pixels (and any pixel past ``n``) carry zero weight.

The kernel compiles only for an NVIDIA GPU. Elsewhere it runs only when the
caller passes ``interpret=True`` (the Pallas interpreter, used by the tests).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from align3d_tpu.camera import CameraIntrinsics
from align3d_tpu.optim.gauss_newton import GNSystem
from align3d_tpu.ops.target_pack import bilinear_grad_from_taps

Array = jax.Array

BLOCK = 1024  # source pixels per program (a power of two, as Triton needs)
NUM_WARPS = 4
SRC_CHANNELS = 8  # x, y, z, valid, intensity, 3 x pad
_SYS = 29  # 21 (upper H) + 6 (g) + sum w r^2 + sum w
_COLOR_OFFSET = 32
OUT_WIDTH = 64
_UPPER = tuple((a, b) for a in range(6) for b in range(a, 6))


def num_blocks(n: int, block: int = BLOCK) -> int:
    return -(-n // block)


def pack_source(points: Array, mask: Array, intensity: Array, block: int = BLOCK) -> Array:
    """(B, N, 3), (B, N), (B, N) -> (B, 8, nblocks * block) f32 channel-major
    source pack; the padded tail has valid = 0."""
    bsz, n = mask.shape
    np_ = num_blocks(n, block) * block
    chans = jnp.concatenate(
        [
            jnp.moveaxis(points.astype(jnp.float32), -1, 1),
            mask.astype(jnp.float32)[:, None],
            intensity.astype(jnp.float32)[:, None],
            jnp.zeros((bsz, SRC_CHANNELS - 5, n), jnp.float32),
        ],
        axis=1,
    )
    return jnp.pad(chans, ((0, 0), (0, 0), (0, np_ - n)))


def _system_sums(jac, r, wgt):
    """The 29 weighted sums of one system for a block, in output order."""
    jw = [j * wgt for j in jac]
    sums = [jnp.sum(jw[a] * jac[b]) for a, b in _UPPER]
    sums += [jnp.sum(jw[a] * r) for a in range(6)]
    sums += [jnp.sum(wgt * r * r), jnp.sum(wgt)]
    return sums


def _kernel(
    pose_ref,  # (16,) [r00..r22, t0, t1, t2, pad]
    src_ref,  # (8, block) source pack block
    geo_ref,  # (N, 8) target geometry table of this pair
    taps_ref,  # (N, 12) target tap table of this pair
    out_ref,  # (64,) partial sums of this block
    *,
    block: int,
    n: int,
    h: int,
    w: int,
    fx: float,
    fy: float,
    cx: float,
    cy: float,
    max_distance_sqr: float,
    max_normal_angle: float,
    max_color_distance_sqr: float,
    huber_delta: float,
):
    f32 = jnp.float32
    pix = pl.program_id(1) * block + jnp.arange(block, dtype=jnp.int32)
    sx, sy, sz = src_ref[0, :], src_ref[1, :], src_ref[2, :]
    smask = (src_ref[3, :] > 0.0) & (pix < n)
    s_int = src_ref[4, :]
    r = [pose_ref[k] for k in range(12)]

    px = sx * r[0] + sy * r[1] + sz * r[2] + r[9]
    py = sx * r[3] + sy * r[4] + sz * r[5] + r[10]
    pz = sx * r[6] + sy * r[7] + sz * r[8] + r[11]

    safe_z = jnp.where(pz == 0.0, f32(1e-12), pz)
    u = px * f32(fx) / safe_z + f32(cx)
    v = py * f32(fy) / safe_z + f32(cy)

    u_int = jnp.trunc(u + 0.5)
    v_int = jnp.trunc(v + 0.5)
    inb = (u_int >= 0) & (u_int < w) & (v_int >= 0) & (v_int < h)
    ui = jnp.clip(u_int, 0, w - 1).astype(jnp.int32)
    vi = jnp.clip(v_int, 0, h - 1).astype(jnp.int32)
    # Out-of-bounds pixels carry zero weight; row 0 keeps their reads in range.
    idx = jnp.where(inb, vi * w + ui, 0)

    tpx, tpy, tpz = geo_ref[idx, 0], geo_ref[idx, 1], geo_ref[idx, 2]
    nx, ny, nz = geo_ref[idx, 3], geo_ref[idx, 4], geo_ref[idx, 5]
    valid = smask & inb & (geo_ref[idx, 6] > 0.0)

    dx, dy, dz = tpx - px, tpy - py, tpz - pz
    dist_ok = dx * dx + dy * dy + dz * dz <= f32(max_distance_sqr)
    # Reference quirk (image_icp.rs:119): the transformed source POINT
    # against the target normal; a NaN angle passes the gate.
    angle = jnp.abs(jnp.arccos(px * nx + py * ny + pz * nz))
    angle_rejected = angle >= f32(max_normal_angle)
    w_geom = (valid & dist_ok & ~angle_rejected).astype(f32)

    r_geom = dx * nx + dy * ny + dz * nz
    if huber_delta > 0.0:
        abs_r = jnp.abs(r_geom)
        w_geom = w_geom * jnp.where(
            abs_r <= f32(huber_delta),
            f32(1.0),
            f32(huber_delta) / jnp.maximum(abs_r, f32(1e-30)),
        )
    jac_geom = (nx, ny, nz, py * nz - pz * ny, pz * nx - px * nz, px * ny - py * nx)
    geom_sums = _system_sums(jac_geom, r_geom, w_geom)

    u_s = jnp.clip(u, 0.0, f32(w - 1))
    v_s = jnp.clip(v, 0.0, f32(h - 1))
    base = jnp.trunc(v_s).astype(jnp.int32) * w + jnp.trunc(u_s).astype(jnp.int32)
    base = jnp.where(inb, base, 0)
    taps = [taps_ref[base, k] for k in range(9)]
    target_color, du, dv = bilinear_grad_from_taps(taps, u_s, v_s)
    source_color = s_int * f32(0.003921569)  # 1/255

    zz = safe_z * safe_z
    gx = du * (f32(fx) / safe_z)
    gy = dv * (f32(fy) / safe_z)
    gz = du * (-px * f32(fx) / zz) + dv * (-py * f32(fy) / zz)
    r_color = source_color - target_color
    color_ok = r_color * r_color <= f32(max_color_distance_sqr)
    w_color = w_geom * color_ok.astype(f32)
    jac_color = (gx, gy, gz, py * gz - pz * gy, pz * gx - px * gz, px * gy - py * gx)
    color_sums = _system_sums(jac_color, r_color, w_color)

    lane = jnp.arange(OUT_WIDTH, dtype=jnp.int32)
    out = jnp.zeros((OUT_WIDTH,), f32)
    for offset, sums in ((0, geom_sums), (_COLOR_OFFSET, color_sums)):
        for k, s in enumerate(sums):
            out = jnp.where(lane == offset + k, s, out)
    out_ref[...] = out


@functools.partial(
    jax.jit,
    static_argnames=("intrinsics", "h", "w", "params_tuple", "interpret", "block"),
)
def step_partials(
    rotation: Array,  # (B, 3, 3)
    translation: Array,  # (B, 3)
    source_pack: Array,  # (B, 8, nblocks * block) from pack_source
    target_geo: Array,  # (B, N, 8) pack_geometry
    target_taps: Array,  # (B, N, 12) pack_intensity_taps
    intrinsics: CameraIntrinsics,
    h: int,
    w: int,
    params_tuple: tuple,  # (max_distance, max_normal_angle, max_color_distance, huber_delta)
    interpret: bool = False,
    block: int = BLOCK,
) -> Array:
    """Per-block partial sums ``(B, nblocks, 64)`` of one GN accumulation."""
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the fused ICP kernel compiles only for an NVIDIA GPU; "
            "pass interpret=True to run it in the Pallas interpreter"
        )
    bsz, n = target_geo.shape[0], target_geo.shape[1]
    nblocks = source_pack.shape[2] // block
    if nblocks * block != source_pack.shape[2] or nblocks != num_blocks(n, block):
        raise ValueError(
            f"source pack of width {source_pack.shape[2]} does not match "
            f"{n} target pixels in blocks of {block}"
        )
    max_distance, max_normal_angle, max_color_distance, huber_delta = params_tuple
    pose = jnp.concatenate(
        [
            rotation.reshape(bsz, 9).astype(jnp.float32),
            translation.reshape(bsz, 3).astype(jnp.float32),
            jnp.zeros((bsz, 4), jnp.float32),
        ],
        axis=1,
    )
    kernel = functools.partial(
        _kernel,
        block=block,
        n=n,
        h=h,
        w=w,
        fx=float(intrinsics.fx),
        fy=float(intrinsics.fy),
        cx=float(intrinsics.cx),
        cy=float(intrinsics.cy),
        max_distance_sqr=float(max_distance) ** 2,
        max_normal_angle=float(max_normal_angle),
        max_color_distance_sqr=float(max_color_distance) ** 2,
        huber_delta=float(huber_delta),
    )
    return pl.pallas_call(
        kernel,
        grid=(bsz, nblocks),
        in_specs=[
            pl.BlockSpec((None, 16), lambda b, i: (b, 0)),
            pl.BlockSpec((None, SRC_CHANNELS, block), lambda b, i: (b, 0, i)),
            pl.BlockSpec((None, n, target_geo.shape[2]), lambda b, i: (b, 0, 0)),
            pl.BlockSpec((None, n, target_taps.shape[2]), lambda b, i: (b, 0, 0)),
        ],
        out_specs=pl.BlockSpec((None, None, OUT_WIDTH), lambda b, i: (b, i, 0)),
        out_shape=jax.ShapeDtypeStruct((bsz, nblocks, OUT_WIDTH), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="icp_fused_step",
    )(pose, source_pack, target_geo, target_taps)


def _unpack_system(s: Array) -> GNSystem:
    """(..., 29) sums -> GNSystem with a symmetric (..., 6, 6) hessian."""
    rows = [[None] * 6 for _ in range(6)]
    for k, (a, b) in enumerate(_UPPER):
        rows[a][b] = rows[b][a] = s[..., k]
    hessian = jnp.stack([jnp.stack(row, axis=-1) for row in rows], axis=-2)
    return GNSystem(hessian, s[..., 21:27], s[..., 27], s[..., 28])


def systems_from_partials(partials: Array) -> tuple[GNSystem, GNSystem]:
    """Sum the per-block rows and unpack the (geometric, color) systems."""
    total = jnp.sum(partials, axis=-2)
    return (
        _unpack_system(total[..., :_SYS]),
        _unpack_system(total[..., _COLOR_OFFSET : _COLOR_OFFSET + _SYS]),
    )
