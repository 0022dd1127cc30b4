"""Voxel-hash grid nearest-neighbor search — the kd-tree replacement.

The reference's ``R3dTree`` (``src/kdtree.rs``) is a pointer-chasing
median-split tree whose ``nearest`` descends WITHOUT backtracking
(kdtree.rs:69-105) — i.e. it is already an approximate NN. Pointer chasing
does not vectorize; instead we bucket points into hashed voxel cells via a
sort, and each query gathers the 3^3 neighboring cells' candidates and
min-reduces — dense vectorized gathers + fused distance math, batchable over
hundreds of thousands of queries in one XLA program.

Guarantee: with cell size >= the search radius of interest, the 27-cell scan
finds the exact nearest neighbor within that radius up to the per-cell
candidate cap (``max_per_cell``); hash collisions only add (losing)
candidates, never drop the true one within the cap.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from align3d_tpu.config import MATMUL_PRECISION

Array = jax.Array

# Large primes for the 3D cell hash (standard spatial-hash constants).
_P1, _P2, _P3 = 73856093, 19349663, 83492791


def _cell_hash(cell_ids: Array) -> Array:
    """(..., 3) int32 cell coords -> int32 hash (collisions are benign)."""
    return (
        cell_ids[..., 0] * _P1 ^ cell_ids[..., 1] * _P2 ^ cell_ids[..., 2] * _P3
    ).astype(jnp.int32)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class VoxelHashGrid:
    """Sorted-bucket voxel hash over a fixed point set."""

    sorted_hash: Array  # (M,) int32, ascending
    sorted_points: Array  # (M, 3) f32
    sorted_indices: Array  # (M,) int32 — original indices
    cell_size: float

    def tree_flatten(self):
        return (self.sorted_hash, self.sorted_points, self.sorted_indices), self.cell_size

    @classmethod
    def tree_unflatten(cls, cell_size, children):
        return cls(*children, cell_size=cell_size)

    @classmethod
    def build(cls, points: Array, cell_size: float) -> "VoxelHashGrid":
        points = points.astype(jnp.float32)
        cell_ids = jnp.floor(points / cell_size).astype(jnp.int32)
        h = _cell_hash(cell_ids)
        order = jnp.argsort(h)
        return cls(
            sorted_hash=h[order],
            sorted_points=points[order],
            sorted_indices=order.astype(jnp.int32),
            cell_size=cell_size,
        )


@partial(jax.jit, static_argnames=("max_per_cell", "query_chunk"))
def nearest(
    grid: VoxelHashGrid,
    queries: Array,
    max_per_cell: int = 16,
    query_chunk: int = 8192,
) -> tuple[Array, Array]:
    """Nearest DB point for each query: returns (indices (Q,), sq_distances (Q,)).

    Scans the 27 cells around each query; each cell contributes up to
    ``max_per_cell`` candidates (cells are contiguous runs in the sorted
    order). Queries with no candidate in range get index 0 and +inf distance
    — callers gate by distance like the ICP does.

    Memory layout notes: candidate coordinates are gathered per-axis from
    (M,) planes rather than as one (Q, 27, K, 3) gather. Queries process in
    ``query_chunk`` blocks under ``lax.map`` so peak memory is
    O(chunk * 27 * K), independent of Q.
    """
    queries = queries.astype(jnp.float32)
    q = queries.shape[0]
    m = grid.sorted_points.shape[0]
    px = grid.sorted_points[:, 0]
    py = grid.sorted_points[:, 1]
    pz = grid.sorted_points[:, 2]

    offsets = jnp.stack(
        jnp.meshgrid(*([jnp.arange(-1, 2)] * 3), indexing="ij"), axis=-1
    ).reshape(27, 3)

    def chunk_fn(q_blk: Array) -> tuple[Array, Array]:  # (C, 3)
        c = q_blk.shape[0]
        q_cells = jnp.floor(q_blk / grid.cell_size).astype(jnp.int32)  # (C, 3)
        neighbor_cells = q_cells[:, None, :] + offsets[None, :, :]  # (C, 27, 3)
        neighbor_hash = _cell_hash(neighbor_cells)  # (C, 27)

        starts = jnp.searchsorted(
            grid.sorted_hash, neighbor_hash.reshape(-1)
        ).reshape(neighbor_hash.shape)  # (C, 27)

        lanes = jnp.arange(max_per_cell, dtype=jnp.int32)
        cand = starts[..., None] + lanes  # (C, 27, K)
        cand_clipped = jnp.minimum(cand, m - 1).reshape(c, -1)  # (C, 27K)
        cand_hash = jnp.take(grid.sorted_hash, cand_clipped)
        cand_valid = (cand.reshape(c, -1) < m) & (
            cand_hash == jnp.repeat(neighbor_hash, max_per_cell, axis=1)
        )

        dx = jnp.take(px, cand_clipped) - q_blk[:, 0:1]
        dy = jnp.take(py, cand_clipped) - q_blk[:, 1:2]
        dz = jnp.take(pz, cand_clipped) - q_blk[:, 2:3]
        sq = dx * dx + dy * dy + dz * dz
        sq = jnp.where(cand_valid, sq, jnp.inf)

        best = jnp.argmin(sq, axis=-1)
        best_sq = jnp.take_along_axis(sq, best[:, None], axis=-1)[:, 0]
        best_sorted_idx = jnp.take_along_axis(cand_clipped, best[:, None], axis=-1)[
            :, 0
        ]
        return jnp.take(grid.sorted_indices, best_sorted_idx), best_sq

    if q <= query_chunk:
        return chunk_fn(queries)

    pad = (-q) % query_chunk
    q_padded = jnp.concatenate([queries, jnp.zeros((pad, 3), jnp.float32)])
    blocks = q_padded.reshape(-1, query_chunk, 3)
    idx_b, sq_b = jax.lax.map(chunk_fn, blocks)
    return idx_b.reshape(-1)[:q], sq_b.reshape(-1)[:q]


def nearest_brute_force(db: Array, queries: Array) -> tuple[Array, Array]:
    """Exact NN via one matmul: ||q - p||^2 = |q|^2 + |p|^2 - 2 q.p.

    Used as the oracle in tests and for small clouds.
    """
    db = db.astype(jnp.float32)
    queries = queries.astype(jnp.float32)
    dots = jnp.matmul(queries, db.T, precision=MATMUL_PRECISION)  # (Q, M)
    sq = (
        jnp.sum(queries * queries, axis=-1, keepdims=True)
        - 2.0 * dots
        + jnp.sum(db * db, axis=-1)[None, :]
    )
    idx = jnp.argmin(sq, axis=-1)
    best = jnp.take_along_axis(sq, idx[:, None], axis=-1)[:, 0]
    return idx.astype(jnp.int32), jnp.maximum(best, 0.0)
