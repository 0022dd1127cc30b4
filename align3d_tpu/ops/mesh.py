"""Mesh vertex normals.

Counterpart of the reference ``src/mesh.rs:4-52``: per-face cross-product
normals (normalized unless degenerate), averaged into vertex normals by the
number of incident faces.  Two forms:

* :func:`compute_vertex_normals` — one-shot, fully traced: the reference's
  scatter loop becomes ``jax.ops.segment_sum``;
* :class:`MeshNormals` — cached-topology evaluator: the incidence structure
  is precomputed ONCE on host into a fixed-degree (N, D) gather table, and
  every evaluation is then D gathers + a masked fold — no scatter at all.
  This suits the common case of a static mesh topology with moving
  vertices.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


def face_normals(points: Array, faces: Array) -> Array:
    """(N, 3) points, (F, 3) int faces -> (F, 3) unit face normals.

    Degenerate faces (zero-magnitude cross product) keep their zero normal,
    matching the reference's ``if mag > 0`` guard (mesh.rs:22-25).
    """
    p0 = jnp.take(points, faces[:, 0], axis=0)
    p1 = jnp.take(points, faces[:, 1], axis=0)
    p2 = jnp.take(points, faces[:, 2], axis=0)
    n = jnp.cross(p1 - p0, p2 - p0)
    mag = jnp.linalg.norm(n, axis=-1, keepdims=True)
    return jnp.where(mag > 0.0, n / jnp.where(mag == 0.0, 1.0, mag), n)


def compute_vertex_normals(points: Array, faces: Array) -> Array:
    """(N, 3) points, (F, 3) faces -> (N, 3) vertex normals.

    Sum of incident unit face normals divided by the incident-face count —
    the exact reference average (mesh.rs:30-49), including NOT re-normalizing
    the result and producing NaN for isolated vertices (0/0), which the
    reference's integer division also yields.
    """
    n_vertices = points.shape[0]
    fn = face_normals(points, faces)
    idx = faces.reshape(-1)  # (3F,) — face-major, matching repeat order
    contrib = jnp.repeat(fn, 3, axis=0)  # (3F, 3)
    sums = jax.ops.segment_sum(contrib, idx, num_segments=n_vertices)
    counts = jax.ops.segment_sum(
        jnp.ones_like(idx, dtype=jnp.float32), idx, num_segments=n_vertices
    )
    return sums / counts[:, None]


class MeshNormals:
    """Vertex-normal evaluator with host-precomputed incidence (see module
    docstring). Semantics identical to :func:`compute_vertex_normals` /
    reference mesh.rs:30-49 — mean of incident unit face normals, summed in
    face order, NaN for isolated vertices (0/0). Each evaluation is D
    row-gathers via the (N, D) incidence table; any topology works.
    """

    def __init__(self, faces, n_vertices: int):
        f = np.asarray(faces, dtype=np.int64).reshape(-1)  # corners, face-major
        n_faces = f.size // 3
        corner_face = np.arange(f.size, dtype=np.int64) // 3
        order = np.argsort(f, kind="stable")  # per-vertex groups, face order
        fs = f[order]
        counts = np.bincount(f, minlength=n_vertices)
        degree = int(counts.max()) if counts.size else 1
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(f.size, dtype=np.int64) - starts[fs]
        table = np.full((n_vertices, max(degree, 1)), n_faces, dtype=np.int32)
        table[fs, rank] = corner_face[order]
        self.n_vertices = n_vertices
        self.degree = degree
        self.faces = jnp.asarray(np.asarray(faces, dtype=np.int32).reshape(-1, 3))
        self.table = jnp.asarray(table)  # (N, D), padded with n_faces
        self.counts = jnp.asarray(counts.astype(np.float32))

    def __call__(self, points: Array) -> Array:
        fn = face_normals(points, self.faces)
        fn_pad = jnp.concatenate(
            [fn, jnp.zeros((1, 3), fn.dtype)], axis=0
        )  # padding slot contributes exact zeros
        acc = jnp.take(fn_pad, self.table[:, 0], axis=0)
        for d in range(1, self.table.shape[1]):  # left fold = face order
            acc = acc + jnp.take(fn_pad, self.table[:, d], axis=0)
        return acc / self.counts[:, None]
