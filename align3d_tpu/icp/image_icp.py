"""Projective RGB-D ICP (point-to-plane + photometric) — the hottest loop.

Redesign of the reference ``src/icp/image_icp.rs``: the rayon
chunk-accumulate-merge inner loop becomes one fully-vectorized GN step
over all H*W source pixels — transform, project, gather from the target,
gates-as-weights, residual/Jacobian formation, and a (6, N) @ (N, 6)
contraction for JtJ/Jtr. The iteration loop is a ``lax.fori_loop`` carrying
(transform, best_residual, best_transform), so a whole multi-iteration align
is a single XLA computation; frame-pair batching is just ``vmap`` over the
leading axis (see :func:`align_batched`).

Replicated reference semantics (bit-level quirks included):
* pixel lookup at ``trunc(u + 0.5)`` with bounds + target-mask gating
  (image_icp.rs:106-114);
* distance gate ``||q - p||^2 > max_distance^2`` skips (``:114``);
* the normal-angle gate compares the *transformed source point* (not its
  normal) against the target normal — ``acos(p . n)`` (``:119``), and a NaN
  angle passes the gate (Rust ``NaN >= x`` is false);
* photometric residual uses the intensity-map bilinear gradient chained with
  the projection Jacobian (``:130-137``), gated by max color distance;
* geometric and color systems merge with weights (w^2 on H, w on g)
  (gaussnewton.rs:115-121);
* the returned transform is the best-mean-squared-residual one, where the
  residual is evaluated *before* an iteration's update but paired with the
  *updated* transform (image_icp.rs:150-161).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from align3d_tpu.camera import CameraIntrinsics
from align3d_tpu.icp.params import IcpParams
from align3d_tpu.ops import icp_fused
from align3d_tpu.ops.target_pack import (
    pack_geometry,
    pack_intensity_taps,
    taps_bilinear_grad,
)
from align3d_tpu.optim.gauss_newton import GNSystem
from align3d_tpu.range_image import RangeImage
from align3d_tpu.se3 import Transform

Array = jax.Array


def _se3_jacobian(points: Array, normals: Array) -> Array:
    """J = [n, p x n] per residual (reference cost_function.rs:5-15)."""
    return jnp.concatenate([normals, jnp.cross(points, normals)], axis=-1)


def icp_step(
    transform: Transform,
    source_points: Array,  # (N, 3)
    source_mask: Array,  # (N,) bool
    source_intensity: Array,  # (N,) u8
    target_geo: Array,  # (N, 8) packed [p, n, valid, pad] (target_pack)
    target_taps: Array,  # (N, 12) packed 3x3 intensity taps
    h: int,  # target image dims — from array shapes, NOT intrinsics:
    w: int,  # the reference bound-checks against the level's array dims
    intrinsics: CameraIntrinsics,  # (image_icp.rs:109 get_point), while
    params: IcpParams,  # intrinsics.scale keeps size (camera.rs:119-127)
) -> tuple[GNSystem, GNSystem]:
    """One fused GN accumulation pass; returns (geometric, color) systems.

    Gather budget: exactly two row gathers (the packed geometry table at the
    nearest projected pixel and the packed tap table at the bilinear base) —
    everything else is dense elementwise work and two small contractions.
    """
    fdtype = jnp.float32

    p = transform.apply(source_points)  # (N, 3)
    z = p[..., 2]
    safe_z = jnp.where(z == 0.0, 1e-12, z)
    u = p[..., 0] * fdtype(intrinsics.fx) / safe_z + fdtype(intrinsics.cx)
    v = p[..., 1] * fdtype(intrinsics.fy) / safe_z + fdtype(intrinsics.cy)

    # Nearest-pixel lookup: trunc(u + 0.5) (image_icp.rs:108). NaN/inf fold to
    # out-of-bounds through the comparisons below.
    u_int = jnp.trunc(u + 0.5)
    v_int = jnp.trunc(v + 0.5)
    inbounds = (u_int >= 0) & (u_int < w) & (v_int >= 0) & (v_int < h)
    ui = jnp.clip(u_int, 0, w - 1).astype(jnp.int32)
    vi = jnp.clip(v_int, 0, h - 1).astype(jnp.int32)
    idx = vi * w + ui

    geo = jnp.take(target_geo, idx, axis=0)  # (N, 8)
    tp = geo[:, 0:3]
    tn = geo[:, 3:6]
    tvalid = geo[:, 6] > 0.0

    valid = source_mask & inbounds & tvalid

    diff = tp - p
    dist_ok = jnp.sum(diff * diff, axis=-1) <= fdtype(
        params.max_distance * params.max_distance
    )

    # Normal-angle gate — reference quirk: uses the transformed source POINT
    # against the target normal (image_icp.rs:119). NaN angle => keep.
    angle = jnp.abs(jnp.arccos(jnp.sum(p * tn, axis=-1)))
    angle_rejected = angle >= fdtype(params.max_normal_angle)  # NaN -> False

    w_geom = (valid & dist_ok & ~angle_rejected).astype(fdtype)

    residual_geom = jnp.sum(diff * tn, axis=-1)
    jac_geom = _se3_jacobian(p, tn)
    if params.huber_delta is not None:
        from align3d_tpu.optim.gauss_newton import huber_weight

        w_geom = w_geom * huber_weight(residual_geom, params.huber_delta)
    geom = GNSystem.from_residuals(jac_geom, residual_geom, w_geom)

    # ---- photometric term (image_icp.rs:129-138) -----------------------
    # Clamp sampling coords so masked-out lanes stay in-bounds; the reference
    # only reaches bilinear_grad when the pixel gate passed, which bounds
    # trunc(u) <= w - 1.
    u_s = jnp.clip(u, 0.0, fdtype(w - 1))
    v_s = jnp.clip(v, 0.0, fdtype(h - 1))
    base = jnp.trunc(v_s).astype(jnp.int32) * w + jnp.trunc(u_s).astype(jnp.int32)
    taps = jnp.take(target_taps, base, axis=0)  # (N, 12)
    target_color, du, dv = taps_bilinear_grad(taps, u_s, v_s)
    source_color = source_intensity.astype(fdtype) * fdtype(0.003921569)  # 1/255

    zz = safe_z * safe_z
    dfx = fdtype(intrinsics.fx) / safe_z
    dcx = -p[..., 0] * fdtype(intrinsics.fx) / zz
    dfy = fdtype(intrinsics.fy) / safe_z
    dcy = -p[..., 1] * fdtype(intrinsics.fy) / zz
    color_gradient = jnp.stack(
        [du * dfx, dv * dfy, du * dcx + dv * dcy], axis=-1
    )
    residual_color = source_color - target_color
    color_ok = residual_color * residual_color <= fdtype(
        params.max_color_distance * params.max_color_distance
    )
    w_color = w_geom * color_ok.astype(fdtype)
    jac_color = _se3_jacobian(p, color_gradient)
    color = GNSystem.from_residuals(jac_color, residual_color, w_color)

    return geom, color


def _gn_loop(systems, initial_rotation, initial_translation, params):
    """The GN iteration loop shared by the engines, as one ``fori_loop``.

    ``systems(rot, trans)`` returns the (geometric, color) systems at the
    current transform; leading batch axes pass through. The returned
    transform is the best-mean-squared-residual one, where the residual is
    evaluated *before* an iteration's update but paired with the *updated*
    transform (image_icp.rs:150-161).
    """

    def body(_, carry):
        rot, trans, best_res, best_rot, best_trans = carry
        geom, color = systems(rot, trans)
        merged = geom.add_weighted(
            color, jnp.float32(params.weight), jnp.float32(params.color_weight)
        )
        residual = merged.mean_squared_residual()
        update = merged.solve()
        new_transform = Transform.exp(update) @ Transform(rot, trans)

        better = residual < best_res
        best_res = jnp.where(better, residual, best_res)
        best_rot = jnp.where(better[..., None, None], new_transform.rotation, best_rot)
        best_trans = jnp.where(better[..., None], new_transform.translation, best_trans)
        return (new_transform.rotation, new_transform.translation, best_res, best_rot, best_trans)

    init = (
        initial_rotation,
        initial_translation,
        jnp.full(initial_rotation.shape[:-2], jnp.inf, jnp.float32),
        initial_rotation,
        initial_translation,
    )
    _, _, best_res, best_rot, best_trans = jax.lax.fori_loop(
        0, params.max_iterations, body, init
    )
    return best_rot, best_trans, best_res


def align_impl(
    initial_rotation: Array,
    initial_translation: Array,
    source_points: Array,
    source_mask: Array,
    source_intensity: Array,
    target_points: Array,
    target_mask: Array,
    target_normals: Array,
    target_intensity_map: Array,
    intrinsics: CameraIntrinsics,
    params: IcpParams,
) -> tuple[Array, Array, Array]:
    """Full ICP align as one compiled loop. Returns (best_R, best_t, best_residual)."""
    h2, w2 = target_intensity_map.shape
    h, w = h2 - 2, w2 - 2
    target_geo = pack_geometry(
        target_points.reshape(h, w, 3),
        target_normals.reshape(h, w, 3),
        target_mask.reshape(h, w),
    )
    target_taps = pack_intensity_taps(target_intensity_map)

    def systems(rot, trans):
        return icp_step(
            Transform(rot, trans),
            source_points,
            source_mask,
            source_intensity,
            target_geo,
            target_taps,
            h,
            w,
            intrinsics,
            params,
        )

    return _gn_loop(systems, initial_rotation, initial_translation, params)


def align_impl_fused_batched(
    initial_rotation: Array,  # (B, 3, 3)
    initial_translation: Array,  # (B, 3)
    source_points: Array,  # (B, N, 3)
    source_mask: Array,  # (B, N)
    source_intensity: Array,  # (B, N)
    target_points: Array,  # (B, N, 3)
    target_mask: Array,  # (B, N)
    target_normals: Array,  # (B, N, 3)
    target_intensity_map: Array,  # (B, H+2, W+2)
    intrinsics: CameraIntrinsics,
    params: IcpParams,
) -> tuple[Array, Array, Array]:
    """:func:`align_impl` over a batch of pairs on the fused kernel
    (:mod:`align3d_tpu.ops.icp_fused`): one kernel launch per GN iteration
    covers every pair."""
    bsz = source_points.shape[0]
    h2, w2 = target_intensity_map.shape[1:]
    h, w = h2 - 2, w2 - 2
    source_pack = icp_fused.pack_source(source_points, source_mask, source_intensity)
    target_geo = jax.vmap(pack_geometry)(
        target_points.reshape(bsz, h, w, 3),
        target_normals.reshape(bsz, h, w, 3),
        target_mask.reshape(bsz, h, w),
    )
    target_taps = jax.vmap(pack_intensity_taps)(target_intensity_map)
    params_tuple = (
        params.max_distance,
        params.max_normal_angle,
        params.max_color_distance,
        0.0 if params.huber_delta is None else params.huber_delta,
    )

    def systems(rot, trans):
        partials = icp_fused.step_partials(
            rot, trans, source_pack, target_geo, target_taps,
            intrinsics, h, w, params_tuple, params.interpret,
        )
        return icp_fused.systems_from_partials(partials)

    return _gn_loop(systems, initial_rotation, initial_translation, params)


def align_impl_fused(*args) -> tuple[Array, Array, Array]:
    """Single-pair :func:`align_impl_fused_batched` (a batch of one); same
    arguments as :func:`align_impl`."""
    *arrays, intrinsics, params = args
    rot, trans, res = align_impl_fused_batched(
        *(a[None] for a in arrays), intrinsics, params
    )
    return rot[0], trans[0], res[0]


ENGINES = {"xla": align_impl, "fused": align_impl_fused}
BATCHED_ENGINES = {"fused": align_impl_fused_batched}


def engine_impl(engine: str):
    """The single-pair align of an engine id; unknown ids raise."""
    try:
        return ENGINES[engine]
    except KeyError:
        raise ValueError(
            f"unknown ICP engine {engine!r}; expected one of {sorted(ENGINES)}"
        ) from None


def align_dispatch(
    initial_rotation: Array,
    initial_translation: Array,
    source_points: Array,
    source_mask: Array,
    source_intensity: Array,
    target_points: Array,
    target_mask: Array,
    target_normals: Array,
    target_intensity_map: Array,
    intrinsics: CameraIntrinsics,
    params: IcpParams,
) -> tuple[Array, Array, Array]:
    """align_impl with engine selection from ``params.engine``."""
    return engine_impl(params.engine)(
        initial_rotation,
        initial_translation,
        source_points,
        source_mask,
        source_intensity,
        target_points,
        target_mask,
        target_normals,
        target_intensity_map,
        intrinsics,
        params,
    )


_align_jit = partial(jax.jit, static_argnames=("intrinsics", "params"))(
    align_dispatch
)


class ImageIcp:
    """Aligns a source RangeImage onto a target (reference image_icp.rs:19-43)."""

    def __init__(self, params: IcpParams, target: RangeImage):
        if target.intensity_map is None:
            raise ValueError("the target image should have an intensity map")
        if target.normals is None:
            raise ValueError("the target image should have normals")
        self.params = params
        self.target = target
        self.initial_transform = Transform.identity()
        self.last_residual: float | None = None  # best mean-squared residual

    def align(self, source: RangeImage) -> Transform:
        if source.intensities is None:
            raise ValueError("the source image should have intensity colors")
        t = self.target
        n = t.height * t.width
        best_rot, best_trans, best_res = _align_jit(
            self.initial_transform.rotation,
            self.initial_transform.translation,
            source.points.reshape(-1, 3),
            source.mask.reshape(-1),
            source.intensities.reshape(-1),
            t.points.reshape(n, 3),
            t.mask.reshape(n),
            t.normals.reshape(n, 3),
            t.intensity_map,
            t.intrinsics,
            self.params,
        )
        self.last_residual = float(best_res)
        return Transform(best_rot, best_trans)


def align_batched(
    initial: Transform,
    source_points: Array,  # (B, N, 3)
    source_mask: Array,
    source_intensity: Array,
    target_points: Array,  # (B, N, 3)
    target_mask: Array,
    target_normals: Array,
    target_intensity_map: Array,  # (B, H+2, W+2)
    intrinsics: CameraIntrinsics,
    params: IcpParams,
) -> tuple[Transform, Array]:
    """vmap of the full align over a leading frame-pair batch axis.

    All pairs share one compiled program.
    """
    fn = jax.vmap(
        lambda rot, tr, sp, sm, si, tp, tm, tn, tim: _align_jit(
            rot, tr, sp, sm, si, tp, tm, tn, tim, intrinsics, params
        )
    )
    best_rot, best_trans, best_res = fn(
        initial.rotation,
        initial.translation,
        source_points,
        source_mask,
        source_intensity,
        target_points,
        target_mask,
        target_normals,
        target_intensity_map,
    )
    return Transform(best_rot, best_trans), best_res
