"""Unordered point-cloud ICP (point-to-plane) — reference ``src/icp/pcl_icp.rs``.

Association uses the voxel-hash grid NN (:mod:`align3d_tpu.ops.voxel_hash`)
instead of the reference's descent-only kd-tree — both are approximate NN,
ours with a within-radius exactness guarantee (SURVEY.md §2.3: the kd-tree
never backtracks, so exact-NN parity is not required).

Per iteration (pcl_icp.rs:49-98): transform points and normals, NN lookup,
distance gate (strict >), normal-angle gate between the *transformed source
normal* and target normal (strict >, proper normals here unlike ImageIcp),
point-to-plane GN step; the mean-squared residual is read *before*
``weight()`` scales the system; best-residual transform tracking as in
ImageIcp.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from align3d_tpu.icp.params import IcpParams
from align3d_tpu.ops import voxel_hash
from align3d_tpu.optim.gauss_newton import GNSystem
from align3d_tpu.se3 import Transform

Array = jax.Array


@partial(jax.jit, static_argnames=("params", "max_per_cell"))
def _align_jit(
    initial_rotation: Array,
    initial_translation: Array,
    source_points: Array,  # (N, 3)
    source_normals: Array,  # (N, 3)
    source_mask: Array,  # (N,) bool
    grid: voxel_hash.VoxelHashGrid,
    target_points: Array,  # (M, 3)
    target_normals: Array,  # (M, 3)
    params: IcpParams,
    max_per_cell: int,
) -> tuple[Array, Array, Array]:
    max_distance_sqr = jnp.float32(params.max_distance * params.max_distance)
    mask_f = source_mask.astype(jnp.float32)

    def body(_, carry):
        rot, trans, best_res, best_rot, best_trans = carry
        transform = Transform(rot, trans)
        p = transform.apply(source_points)
        n = transform.apply_normals(source_normals)

        idx, sq_dist = voxel_hash.nearest(grid, p, max_per_cell=max_per_cell)
        tp = jnp.take(target_points, idx, axis=0)
        tn = jnp.take(target_normals, idx, axis=0)
        n_dot_tn = jnp.sum(n * tn, axis=-1)
        residual = jnp.sum((tp - p) * tn, axis=-1)

        dist_ok = ~(sq_dist > max_distance_sqr)  # inf -> rejected
        angle = jnp.abs(jnp.arccos(n_dot_tn))
        angle_rejected = angle > jnp.float32(params.max_normal_angle)  # NaN -> keep
        w = mask_f * dist_ok.astype(jnp.float32) * (
            ~angle_rejected
        ).astype(jnp.float32)

        jac = jnp.concatenate([tn, jnp.cross(p, tn)], axis=-1)
        system = GNSystem.from_residuals(jac, residual, w)

        # Residual read before weight() (pcl_icp.rs:91-93).
        res_now = system.mean_squared_residual()
        system = system.weight(jnp.float32(params.weight))
        update = system.solve()
        new_t = Transform.exp(update) @ transform

        better = res_now < best_res
        best_res = jnp.where(better, res_now, best_res)
        best_rot = jnp.where(better, new_t.rotation, best_rot)
        best_trans = jnp.where(better, new_t.translation, best_trans)
        return (new_t.rotation, new_t.translation, best_res, best_rot, best_trans)

    init = (
        initial_rotation,
        initial_translation,
        jnp.float32(jnp.inf),
        initial_rotation,
        initial_translation,
    )
    _, _, best_res, best_rot, best_trans = jax.lax.fori_loop(
        0, params.max_iterations, body, init
    )
    return best_rot, best_trans, best_res


class Icp:
    """Point-cloud ICP against a fixed target (reference pcl_icp.rs:15-47).

    The voxel grid is built once at construction (the reference builds its
    kd-tree in ``new``). ``cell_size`` defaults to ``max_distance / 10`` — on
    dense range-image clouds small cells keep per-bucket occupancy below the
    candidate cap (the accuracy/speed sweet spot); associations farther than
    one cell ring are missed, which the distance gate would mostly reject
    anyway (the reference kd-tree is similarly approximate: descent-only).
    """

    def __init__(
        self,
        params: IcpParams,
        target_points: Array,
        target_normals: Array,
        cell_size: float | None = None,
        max_per_cell: int = 32,
    ):
        if target_normals is None:
            raise ValueError("the target point cloud should have normals")
        self.params = params
        self.initial_transform = Transform.identity()
        self.target_points = jnp.asarray(target_points, jnp.float32)
        self.target_normals = jnp.asarray(target_normals, jnp.float32)
        self.cell_size = float(
            cell_size if cell_size is not None else params.max_distance / 10.0
        )
        self.max_per_cell = max_per_cell
        self.grid = voxel_hash.VoxelHashGrid.build(self.target_points, self.cell_size)

    def align(
        self,
        source_points: Array,
        source_normals: Array,
        source_mask: Array | None = None,
    ) -> Transform:
        source_points = jnp.asarray(source_points, jnp.float32)
        if source_mask is None:
            source_mask = jnp.ones(source_points.shape[0], bool)
        best_rot, best_trans, _ = _align_jit(
            self.initial_transform.rotation,
            self.initial_transform.translation,
            source_points,
            jnp.asarray(source_normals, jnp.float32),
            jnp.asarray(source_mask),
            self.grid,
            self.target_points,
            self.target_normals,
            self.params,
            self.max_per_cell,
        )
        return Transform(best_rot, best_trans)
