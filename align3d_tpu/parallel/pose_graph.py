"""Distributed pose-graph optimization (SURVEY §7 phase 5 — beyond the
reference, which has no global refinement at all).

A pose graph has N keyframe poses and E relative-pose constraints
(odometry edges i->i+1 plus loop closures). Gauss-Newton minimizes

    sum_e w_e || log( Z_e^{-1} * T_i^{-1} * T_j ) ||^2

over all poses, with pose 0 gauge-fixed. Structure:

* Edge residuals/Jacobians are embarrassingly parallel over the edge axis —
  with a device mesh they are computed under ``shard_map`` with edges
  sharded, and each shard's contribution to the global normal equations is
  combined with a single ``psum``. The reduced system
  is tiny (6N x 6N for keyframe counts that fit global refinement), solved
  replicated on every device.
* Jacobians use the standard right-perturbation numeric form: each edge
  contributes a 6x6 block pair (d r / d xi_i, d r / d xi_j) obtained by
  differentiating the log-residual with ``jax.jacfwd`` — exactness beats
  hand-derived small-angle approximations and XLA fuses the whole thing.

Loop-closure edge DETECTION (:func:`propose_loop_closures`) follows the
classic pose-distance heuristic; measurement REFINEMENT is the caller's
job (run ImageIcp between the candidate frames).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from align3d_tpu.config import MATMUL_PRECISION
from align3d_tpu.optim.pcg import pcg
from align3d_tpu.se3 import Transform
from align3d_tpu.trajectory import Trajectory

Array = jax.Array

EDGE_AXIS = "edges"


@dataclasses.dataclass
class PoseGraph:
    """Nodes (batched Transform), edges (E, 2) i32, measurements (batched
    Transform, one per edge: expected T_i^{-1} T_j), weights (E,)."""

    nodes: Transform
    edges: Array
    measurements: Transform
    weights: Array

    @classmethod
    def from_trajectory(cls, traj: Trajectory) -> "PoseGraph":
        """Odometry chain: consecutive relative-pose edges."""
        n = len(traj)
        poses = traj.camera_to_world
        idx = jnp.arange(n - 1, dtype=jnp.int32)
        edges = jnp.stack([idx, idx + 1], axis=1)
        t_i = poses[np.arange(0, n - 1)]
        t_j = poses[np.arange(1, n)]
        meas = t_i.inverse() @ t_j
        return cls(poses, edges, meas, jnp.ones(n - 1, jnp.float32))

    def with_edge(
        self, i: int, j: int, measurement: Transform, weight: float = 1.0
    ) -> "PoseGraph":
        edges = jnp.concatenate(
            [self.edges, jnp.asarray([[i, j]], jnp.int32)], axis=0
        )
        meas = Transform(
            jnp.concatenate(
                [self.measurements.rotation, measurement.rotation[None]], axis=0
            ),
            jnp.concatenate(
                [self.measurements.translation, measurement.translation[None]],
                axis=0,
            ),
        )
        weights = jnp.concatenate(
            [self.weights, jnp.asarray([weight], jnp.float32)]
        )
        return PoseGraph(self.nodes, edges, meas, weights)


def propose_loop_closures(
    traj: Trajectory,
    min_separation: int = 10,
    max_translation: float = 0.5,
    max_candidates: int = 32,
    row_chunk: int = 256,
) -> np.ndarray:
    """Pose-distance loop-closure candidates: frame pairs far in time but
    near in space, RANKED by spatial distance (closest first) so truncation
    to ``max_candidates`` keeps the most promising pairs rather than the
    earliest frames. Returns (K, 2) int array (host side).

    Memory is O(row_chunk * N + nchunks * K), never the dense (N, N)
    pose-distance matrix: rows are scanned in chunks and each chunk is
    pre-truncated to its own stable top-K — the global ranked top-K can
    contain at most K entries from any one chunk, so the pre-truncation is
    lossless and the output is bit-identical to the dense form (ties resolve
    in row-major candidate order either way).
    """
    t = np.asarray(traj.camera_to_world.translation)
    n = t.shape[0]
    keep_i, keep_j, keep_d = [], [], []
    for r0 in range(0, n, row_chunk):
        r1 = min(r0 + row_chunk, n)
        d = np.linalg.norm(t[r0:r1, None, :] - t[None, :, :], axis=-1)
        ii, jj = np.meshgrid(np.arange(r0, r1), np.arange(n), indexing="ij")
        ok = (jj > ii + min_separation) & (d < max_translation)
        ci, cj = np.nonzero(ok)  # row-major within the chunk
        dv = d[ci, cj]
        if ci.size > max_candidates:
            # Stable top-K, then restored to row-major order so the later
            # global stable sort breaks ties exactly like the dense scan.
            sel = np.sort(np.argsort(dv, kind="stable")[:max_candidates])
            ci, cj, dv = ci[sel], cj[sel], dv[sel]
        keep_i.append(ci + r0)
        keep_j.append(cj)
        keep_d.append(dv)
    cand_i = np.concatenate(keep_i) if keep_i else np.zeros(0, np.int64)
    cand_j = np.concatenate(keep_j) if keep_j else np.zeros(0, np.int64)
    dist = np.concatenate(keep_d) if keep_d else np.zeros(0, np.float64)
    order = np.argsort(dist, kind="stable")[:max_candidates]
    return np.stack(
        [cand_i[order], cand_j[order]], axis=1
    ).astype(np.int64).reshape(-1, 2)


def _edge_residual(twist_i: Array, twist_j: Array, t_i: Transform, t_j: Transform, z_inv: Transform) -> Array:
    """r = log(Z^{-1} (T_i exp(xi_i))^{-1} (T_j exp(xi_j))) — evaluated at
    xi = 0; the twists exist to differentiate through."""
    ti = t_i @ Transform.exp(twist_i)
    tj = t_j @ Transform.exp(twist_j)
    return (z_inv @ (ti.inverse() @ tj)).log()


def _edge_jacobians(nodes: Transform, edges: Array, meas: Transform):
    """Per-edge residuals + 6x6 Jacobian blocks: (res (E,6), j_i, j_j (E,6,6))."""
    t_i = Transform(
        jnp.take(nodes.rotation, edges[:, 0], axis=0),
        jnp.take(nodes.translation, edges[:, 0], axis=0),
    )
    t_j = Transform(
        jnp.take(nodes.rotation, edges[:, 1], axis=0),
        jnp.take(nodes.translation, edges[:, 1], axis=0),
    )
    z_inv = meas.inverse()
    zero = jnp.zeros((edges.shape[0], 6), jnp.float32)

    res = jax.vmap(_edge_residual)(zero, zero, t_i, t_j, z_inv)  # (E, 6)
    j_i = jax.vmap(
        lambda a, b, c, d: jax.jacfwd(_edge_residual, argnums=0)(a, jnp.zeros(6), b, c, d)
    )(zero[:, :], t_i, t_j, z_inv)  # (E, 6, 6)
    j_j = jax.vmap(
        lambda a, b, c, d: jax.jacfwd(_edge_residual, argnums=1)(jnp.zeros(6), a, b, c, d)
    )(zero[:, :], t_i, t_j, z_inv)
    return res, j_i, j_j


def _edge_system(nodes: Transform, edges: Array, meas: Transform, weights: Array, n: int):
    """Dense (6n, 6n) H and (6n,) g from a (shard of) edges."""
    res, j_i, j_j = _edge_jacobians(nodes, edges, meas)
    w = weights[:, None, None]
    # Scatter the 6x6 blocks into the dense system with one-hot selectors
    # over node ids — expressed as einsums (contractions), which keeps
    # the whole build shard_map-safe (contributions just add under psum).
    onehot_i = jax.nn.one_hot(edges[:, 0], n, dtype=jnp.float32)  # (E, N)
    onehot_j = jax.nn.one_hot(edges[:, 1], n, dtype=jnp.float32)

    h = jnp.zeros((n, 6, n, 6), jnp.float32)
    g = jnp.zeros((n, 6), jnp.float32)
    for oa, ja in ((onehot_i, j_i), (onehot_j, j_j)):
        g = g + jnp.einsum("ea,edu,ed->au", oa, ja * w, res, precision=MATMUL_PRECISION)
        for ob, jb in ((onehot_i, j_i), (onehot_j, j_j)):
            h = h + jnp.einsum("ea,eb,edu,edw->aubw", oa, ob, ja * w, jb, precision=MATMUL_PRECISION)
    return h.reshape(n * 6, n * 6), g.reshape(n * 6)


def _block_system(nodes, edges, meas, weights, n: int):
    """Block-sparse normal equations from a (shard of) edges.

    Returns (hdiag (N,6,6) additive, hij (E,6,6) shard-local COO off-diagonal
    blocks, g (N,6) additive). Work and memory are O(E) — the dense one-hot
    assembly (the r2 form) was O(E*N^2) and capped N at keyframe counts.
    Gauge: pose 0's blocks are dropped here (its diagonal becomes I), so the
    CG runs on the reduced system directly.
    """
    res, j_i, j_j = _edge_jacobians(nodes, edges, meas)
    ei, ej = edges[:, 0], edges[:, 1]
    # Gauge-fix pose 0 at the residual level: any Jacobian w.r.t. pose 0 is
    # zeroed, which deletes its rows/cols from every product below.
    j_i = jnp.where((ei == 0)[:, None, None], 0.0, j_i)
    j_j = jnp.where((ej == 0)[:, None, None], 0.0, j_j)
    w = weights[:, None, None]

    h_ii = jnp.einsum("edu,edw->euw", j_i * w, j_i, precision=MATMUL_PRECISION)
    h_jj = jnp.einsum("edu,edw->euw", j_j * w, j_j, precision=MATMUL_PRECISION)
    hij = jnp.einsum("edu,edw->euw", j_i * w, j_j, precision=MATMUL_PRECISION)  # (E, 6, 6) block (i, j)
    hdiag = jax.ops.segment_sum(h_ii, ei, num_segments=n) + jax.ops.segment_sum(
        h_jj, ej, num_segments=n
    )
    g = jax.ops.segment_sum(
        jnp.einsum("edu,ed->eu", j_i * w, res, precision=MATMUL_PRECISION), ei, num_segments=n
    ) + jax.ops.segment_sum(
        jnp.einsum("edu,ed->eu", j_j * w, res, precision=MATMUL_PRECISION), ej, num_segments=n
    )
    return hdiag, hij, g


def _finalize_diag(hdiag: Array, damping: float) -> Array:
    """Damping + gauge identity, applied ONCE after any cross-shard psum
    (per-shard application would multiply them by the shard count)."""
    hdiag = hdiag + damping * jnp.eye(6, dtype=jnp.float32)[None]
    return hdiag.at[0].set(jnp.eye(6, dtype=jnp.float32))


def _cg_step_update(nodes, hdiag, hij, g, edges, cg_iters: int):
    """One GN update from the block system via block-Jacobi PCG."""
    n = hdiag.shape[0]
    ei, ej = edges[:, 0], edges[:, 1]
    minv = jnp.linalg.inv(hdiag)  # (N, 6, 6) block-Jacobi preconditioner

    def matvec(v):
        out = jnp.einsum("nuw,nw->nu", hdiag, v, precision=MATMUL_PRECISION)
        vi = jnp.take(v, ei, axis=0)
        vj = jnp.take(v, ej, axis=0)
        out = out + jax.ops.segment_sum(
            jnp.einsum("euw,ew->eu", hij, vj, precision=MATMUL_PRECISION), ei, num_segments=n
        )
        out = out + jax.ops.segment_sum(
            jnp.einsum("ewu,ew->eu", hij, vi, precision=MATMUL_PRECISION), ej, num_segments=n
        )
        return out

    def precond(r):
        return jnp.einsum("nuw,nw->nu", minv, r, precision=MATMUL_PRECISION)

    update = -pcg(matvec, precond, g, cg_iters)
    return nodes @ Transform.exp(update)


def optimize(
    graph: PoseGraph,
    iterations: int = 10,
    damping: float = 1e-6,
    mesh: Mesh | None = None,
    solver: str = "auto",
    cg_iters: int = 64,
) -> Transform:
    """Gauss-Newton over the pose graph; pose 0 gauge-fixed.

    With ``mesh``, edges are sharded over the mesh axis and per-shard normal
    equations combine with ``psum`` — per SURVEY §2.6's distributed plan.
    Returns the refined batched Transform.

    ``solver``: "dense" materializes the (6N, 6N) system and Cholesky-solves
    it (exact, O(E*N^2) assembly — fine for keyframe-scale N); "cg" keeps
    per-edge 6x6 blocks in COO form and runs block-Jacobi preconditioned CG
    (O(E) per matvec — the long-sequence path); "auto" picks CG above 64
    poses. Under a mesh the CG matvec psums shard-local off-diagonal
    products, so the off-diagonal blocks never leave their shard.
    """
    n = len(graph.nodes)
    edges = graph.edges
    meas = graph.measurements
    weights = graph.weights
    if solver == "auto":
        solver = "cg" if n > 64 else "dense"

    if mesh is not None:
        n_dev = mesh.devices.size
        e = edges.shape[0]
        pad = (-e) % n_dev
        if pad:
            # Repeat the last edge with zero weight to make E divisible.
            edges = jnp.concatenate([edges, jnp.tile(edges[-1:], (pad, 1))])
            meas = Transform(
                jnp.concatenate([meas.rotation, jnp.tile(meas.rotation[-1:], (pad, 1, 1))]),
                jnp.concatenate([meas.translation, jnp.tile(meas.translation[-1:], (pad, 1))]),
            )
            weights = jnp.concatenate([weights, jnp.zeros(pad, jnp.float32)])

    def build_system(nodes, edges_s, meas_s, weights_s):
        return _edge_system(nodes, edges_s, meas_s, weights_s, n)

    def step_cg(nodes: Transform) -> Transform:
        if mesh is None:
            hdiag, hij, g = _block_system(nodes, edges, meas, weights, n)
            hdiag = _finalize_diag(hdiag, damping)
            return _cg_step_update(nodes, hdiag, hij, g, edges, cg_iters)

        from jax import shard_map

        axis = mesh.axis_names[0]

        @partial(
            shard_map,
            mesh=mesh,
            in_specs=(P(), P(), P(axis), P(axis), P(axis)),
            out_specs=(P(), P()),
            check_vma=False,
        )
        def sharded(rot, tr, edges_s, meas_s, weights_s):
            nodes_r = Transform(rot, tr)
            meas_t = Transform(meas_s[:, :3, :3], meas_s[:, :3, 3])
            hdiag_s, hij_s, g_s = _block_system(
                nodes_r, edges_s, meas_t, weights_s, n
            )
            hdiag = _finalize_diag(jax.lax.psum(hdiag_s, axis), damping)
            g = jax.lax.psum(g_s, axis)
            minv = jnp.linalg.inv(hdiag)
            ei, ej = edges_s[:, 0], edges_s[:, 1]

            def matvec(v):
                out = jnp.einsum("nuw,nw->nu", hdiag, v, precision=MATMUL_PRECISION)
                vi = jnp.take(v, ei, axis=0)
                vj = jnp.take(v, ej, axis=0)
                local = jax.ops.segment_sum(
                    jnp.einsum("euw,ew->eu", hij_s, vj, precision=MATMUL_PRECISION), ei, num_segments=n
                ) + jax.ops.segment_sum(
                    jnp.einsum("ewu,ew->eu", hij_s, vi, precision=MATMUL_PRECISION), ej, num_segments=n
                )
                return out + jax.lax.psum(local, axis)

            update = -pcg(
                matvec, lambda r: jnp.einsum("nuw,nw->nu", minv, r, precision=MATMUL_PRECISION), g, cg_iters
            )
            out = nodes_r @ Transform.exp(update)
            return out.rotation, out.translation

        meas_mat = jnp.zeros((meas.rotation.shape[0], 4, 4), jnp.float32)
        meas_mat = meas_mat.at[:, :3, :3].set(meas.rotation)
        meas_mat = meas_mat.at[:, :3, 3].set(meas.translation)
        rot, tr = sharded(
            nodes.rotation, nodes.translation, edges, meas_mat, weights
        )
        return Transform(rot, tr)

    def step(nodes: Transform) -> Transform:
        if solver == "cg":
            return step_cg(nodes)
        if mesh is None:
            h, g = build_system(nodes, edges, meas, weights)
        else:
            from jax import shard_map

            axis = mesh.axis_names[0]

            @partial(
                shard_map,
                mesh=mesh,
                in_specs=(P(), P(axis), P(axis), P(axis)),
                out_specs=P(),
                check_vma=False,
            )
            def sharded(nodes_r, edges_s, meas_s, weights_s):
                h_s, g_s = build_system(nodes_r, edges_s, meas_s, weights_s)
                return (
                    jax.lax.psum(h_s, axis),
                    jax.lax.psum(g_s, axis),
                )

            h, g = sharded(nodes, edges, meas, weights)

        # Gauge fix pose 0: zero its rows/cols, identity on the diagonal.
        h = h.at[0:6, :].set(0.0).at[:, 0:6].set(0.0)
        h = h.at[0:6, 0:6].set(jnp.eye(6))
        g = g.at[0:6].set(0.0)
        h = h + damping * jnp.eye(n * 6, dtype=jnp.float32)

        update = -jnp.linalg.solve(h, g).reshape(n, 6)
        return nodes @ Transform.exp(update)

    step = jax.jit(step)  # one compile; the Python loop reuses it
    nodes = graph.nodes
    for _ in range(iterations):
        nodes = step(nodes)
    return nodes


def refine_trajectory(
    traj: Trajectory,
    loop_edges: list[tuple[int, int, Transform, float]] | None = None,
    iterations: int = 10,
    mesh: Mesh | None = None,
) -> Trajectory:
    """Convenience: trajectory -> pose graph (+ loop closures) -> optimize."""
    graph = PoseGraph.from_trajectory(traj)
    for i, j, z, w in loop_edges or []:
        graph = graph.with_edge(i, j, z, w)
    nodes = optimize(graph, iterations=iterations, mesh=mesh)
    return Trajectory(nodes, traj.times)
