"""Frame-pair batching and device-mesh data parallelism.

The throughput configuration: every per-pair op is vmapped over a leading
batch axis and the batch axis is sharded across the device mesh — pairs are independent, so DP
sharding compiles to zero collectives until pose composition, which is a
replicated ``associative_scan`` over tiny 4x4 matrices.

The odometry "step" (:func:`odometry_step`) is the whole pipeline — batched
preprocessing, multiscale ICP over all adjacent pairs, parallel pose
composition, metrics — as one jitted, mesh-sharded computation.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from align3d_tpu.camera import CameraIntrinsics
from align3d_tpu.icp.image_icp import BATCHED_ENGINES, engine_impl
from align3d_tpu.icp.params import MsIcpParams
from align3d_tpu.range_image import RangeImage, build_pyramid_impl
from align3d_tpu.se3 import Transform
from align3d_tpu.trajectory import Trajectory, accumulate_scan

Array = jax.Array

BATCH_AXIS = "pairs"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D device mesh over the batch ('pairs') axis."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (BATCH_AXIS,))


def build_pyramids_batched(
    intrinsics: CameraIntrinsics,
    depth_scale: float,
    colors: Array,  # (B, H, W, 3) u8
    depths: Array,  # (B, H, W) u16 (bilateral pre-applied if desired)
    with_normals: bool = True,
    with_intensity: bool = True,
    pyramid_levels: int = 3,
    blur_sigma: float = 1.0,
) -> list[RangeImage]:
    """vmapped pyramid construction: list (fine->coarse) of batched RangeImages."""
    fn = partial(
        build_pyramid_impl,
        with_normals,
        with_intensity,
        pyramid_levels,
        blur_sigma,
        intrinsics,
        depth_scale,
    )
    return jax.vmap(fn)(colors, depths)


def _flatten_level(ri: RangeImage) -> tuple[Array, Array, Array, Array, Array]:
    """Batched RangeImage -> flattened per-pair arrays for the ICP step."""
    b = ri.points.shape[0]
    n = ri.points.shape[1] * ri.points.shape[2]
    return (
        ri.points.reshape(b, n, 3),
        ri.mask.reshape(b, n),
        ri.intensities.reshape(b, n),
        ri.normals.reshape(b, n, 3),
        ri.intensity_map,
    )


def multiscale_align_batched(
    target_pyramid: list[RangeImage],
    source_pyramid: list[RangeImage],
    params: MsIcpParams,
    initial: Transform | None = None,
) -> Transform:
    """Batched coarse-to-fine multiscale ICP.

    ``target_pyramid``/``source_pyramid`` are lists (fine->coarse) of batched
    RangeImages with a shared leading pair axis B. Returns a batched
    Transform (B,).
    """
    b = target_pyramid[0].points.shape[0]
    if initial is None:
        initial = Transform.identity((b,))
    rot, trans = initial.rotation, initial.translation

    for level_params, target, source in reversed(
        list(zip(params, target_pyramid, source_pyramid))
    ):
        sp, sm, si, _, _ = _flatten_level(source)
        tp, tm, _, tn, tim = _flatten_level(target)
        if level_params.engine in BATCHED_ENGINES:
            rot, trans, _ = BATCHED_ENGINES[level_params.engine](
                rot, trans, sp, sm, si, tp, tm, tn, tim,
                target.intrinsics, level_params,
            )
        else:
            impl = engine_impl(level_params.engine)
            fn = jax.vmap(
                lambda r, t, a, bm, c, d, e, f, g: impl(
                    r, t, a, bm, c, d, e, f, g, target.intrinsics, level_params
                )
            )
            rot, trans, _ = fn(rot, trans, sp, sm, si, tp, tm, tn, tim)
    return Transform(rot, trans)


def _align_pairs_sharded(
    target_pyramid: list[RangeImage],
    source_pyramid: list[RangeImage],
    params: MsIcpParams,
    mesh: Mesh,
) -> Transform:
    """:func:`multiscale_align_batched` with the pair axis split over
    ``mesh`` under ``shard_map``: each device aligns its own pairs, so a
    Pallas kernel in the engine runs per device. The pair axis is padded to
    a multiple of the mesh by repeating the last pair, and trimmed after."""
    b = target_pyramid[0].points.shape[0]
    pad = (-b) % mesh.devices.size

    def padded(ri):
        if not pad:
            return ri
        return jax.tree.map(
            lambda a: jnp.concatenate([a, jnp.repeat(a[-1:], pad, axis=0)]), ri
        )

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(BATCH_AXIS), P(BATCH_AXIS)),
        out_specs=(P(BATCH_AXIS), P(BATCH_AXIS)),
        check_vma=False,
    )
    def align(tgt, src):
        t = multiscale_align_batched(tgt, src, params)
        return t.rotation, t.translation

    rot, trans = align(
        [padded(ri) for ri in target_pyramid], [padded(ri) for ri in source_pyramid]
    )
    return Transform(rot[:b], trans[:b])


def odometry_step(
    intrinsics: CameraIntrinsics,
    depth_scale: float,
    colors: Array,  # (N, H, W, 3) u8 — N consecutive frames
    depths: Array,  # (N, H, W) u16
    params: MsIcpParams | None = None,
    pyramid_levels: int = 3,
    mesh: Mesh | None = None,
) -> Trajectory:
    """Whole-sequence odometry as one computation.

    Builds pyramids for all N frames, aligns all N-1 adjacent pairs
    (source = frame i, target = frame i-1, matching the sequential driver),
    and composes relative poses with a parallel prefix scan. With ``mesh``,
    the frame and pair axes are sharded across devices and each device
    aligns its own pairs (pure DP — no collectives until the final tiny
    scan).
    """
    params = params or MsIcpParams.default()

    def step(colors_in, depths_in):
        pyr = build_pyramids_batched(
            intrinsics,
            depth_scale,
            colors_in,
            depths_in,
            pyramid_levels=pyramid_levels,
        )
        source_pyr = [jax.tree.map(lambda a: a[1:], ri) for ri in pyr]
        target_pyr = [jax.tree.map(lambda a: a[:-1], ri) for ri in pyr]
        if mesh is None:
            relative = multiscale_align_batched(target_pyr, source_pyr, params)
        else:
            relative = _align_pairs_sharded(target_pyr, source_pyr, params, mesh)
        traj = accumulate_scan(relative)
        return traj.camera_to_world.rotation, traj.camera_to_world.translation

    if mesh is not None:
        sharded = NamedSharding(mesh, P(BATCH_AXIS))
        replicated = NamedSharding(mesh, P())
        step = jax.jit(
            step,
            in_shardings=(sharded, sharded),
            out_shardings=(replicated, replicated),
        )
    else:
        step = jax.jit(step)

    rot, trans = step(colors, depths)
    n = rot.shape[0]
    return Trajectory(Transform(rot, trans), jnp.arange(n, dtype=jnp.float32))
