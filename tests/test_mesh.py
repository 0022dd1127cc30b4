"""Mesh vertex-normal tests (reference src/mesh.rs behavior)."""

import jax.numpy as jnp
import numpy as np
import pytest

from align3d_tpu.config import ref_data_path
from align3d_tpu.ops.mesh import compute_vertex_normals, face_normals


def test_single_triangle():
    pts = jnp.asarray([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0]])
    faces = jnp.asarray([[0, 1, 2]], dtype=jnp.int32)
    fn = np.asarray(face_normals(pts, faces))
    np.testing.assert_allclose(fn, [[0.0, 0.0, 1.0]], atol=1e-7)
    vn = np.asarray(compute_vertex_normals(pts, faces))
    np.testing.assert_allclose(vn, [[0, 0, 1]] * 3, atol=1e-7)


def test_average_not_renormalized():
    # Two faces meeting at a ridge: the vertex normal is the MEAN of the two
    # unit face normals (not re-normalized), as in mesh.rs:44-49.
    pts = jnp.asarray(
        [
            [0.0, 0.0, 0.0],
            [1.0, 0.0, 0.0],
            [0.5, 1.0, 1.0],
            [0.5, -1.0, 1.0],
        ]
    )
    faces = jnp.asarray([[0, 1, 2], [0, 3, 1]], dtype=jnp.int32)
    fn = np.asarray(face_normals(pts, faces))
    vn = np.asarray(compute_vertex_normals(pts, faces))
    expected_ridge = (fn[0] + fn[1]) / 2.0
    np.testing.assert_allclose(vn[0], expected_ridge, atol=1e-6)
    np.testing.assert_allclose(vn[1], expected_ridge, atol=1e-6)
    np.testing.assert_allclose(vn[2], fn[0], atol=1e-6)
    assert abs(np.linalg.norm(vn[0]) - 1.0) > 1e-3  # mean, not unit


def test_degenerate_face_zero_normal():
    pts = jnp.asarray([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [2.0, 0.0, 0.0]])
    faces = jnp.asarray([[0, 1, 2]], dtype=jnp.int32)
    fn = np.asarray(face_normals(pts, faces))
    np.testing.assert_array_equal(fn, np.zeros((1, 3), np.float32))


def test_teapot_fixture():
    from align3d_tpu.io.off import read_off

    geo = read_off(ref_data_path("teapot.off"))
    vn = np.asarray(
        compute_vertex_normals(
            jnp.asarray(geo.points), jnp.asarray(geo.faces.astype(np.int32))
        )
    )
    assert vn.shape == (geo.points.shape[0], 3)
    assert np.isfinite(vn[np.unique(geo.faces.ravel())]).all()


def test_mesh_normals_cached_matches_oneshot():
    """MeshNormals (precomputed gather table) == segment_sum path, including
    NaN on isolated vertices and shared-ridge averaging."""
    from align3d_tpu.ops.mesh import MeshNormals

    rng = np.random.default_rng(1)
    n, m = 500, 900
    pts = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    faces = jnp.asarray(rng.integers(0, n - 10, (m, 3)).astype(np.int32))
    # vertices n-10..n-1 are isolated -> NaN in both paths
    ref = np.asarray(compute_vertex_normals(pts, faces))
    got = np.asarray(MeshNormals(faces, n)(pts))
    assert np.isnan(ref[-10:]).all() and np.isnan(got[-10:]).all()
    np.testing.assert_allclose(got[:-10], ref[:-10], atol=2e-6)


def test_mesh_normals_cached_teapot():
    from align3d_tpu.io.off import read_off
    from align3d_tpu.ops.mesh import MeshNormals

    geo = read_off(ref_data_path("teapot.off"))
    pts = jnp.asarray(geo.points)
    faces = jnp.asarray(geo.faces.astype(np.int32))
    ref = np.asarray(compute_vertex_normals(pts, faces))
    got = np.asarray(MeshNormals(faces, pts.shape[0])(pts))
    mask = ~np.isnan(ref).any(axis=1)
    np.testing.assert_allclose(got[mask], ref[mask], atol=2e-6)


def test_ply_binary_write_roundtrip(tmp_path):
    """Binary LE writer (beyond reference) round-trips exactly, including the
    vectorized fixed-stride triangle fast path in the reader."""
    import numpy as np

    from align3d_tpu.io.geometry import Geometry
    from align3d_tpu.io.ply import read_ply, write_ply

    rng = np.random.default_rng(0)
    n, m = 5000, 3000
    geom = Geometry(
        points=rng.normal(size=(n, 3)).astype(np.float32),
        normals=rng.normal(size=(n, 3)).astype(np.float32),
        colors=rng.integers(0, 256, (n, 3)).astype(np.uint8),
        faces=rng.integers(0, n, (m, 3)).astype(np.int64),
    )
    path = tmp_path / "cloud.ply"
    write_ply(path, geom, binary=True)
    back = read_ply(path)
    np.testing.assert_array_equal(back.points, geom.points)
    np.testing.assert_array_equal(back.normals, geom.normals)
    np.testing.assert_array_equal(back.colors, geom.colors)
    np.testing.assert_array_equal(back.faces, geom.faces)


def test_off_quad_fan_split_and_arity_rejection(tmp_path):
    """Quads triangulate by fan split (off.rs:78-86); 5-gons are rejected
    with a line-tracked error."""
    import pytest

    from align3d_tpu.io.off import OffError, read_off

    quad = tmp_path / "quad.off"
    quad.write_text(
        "OFF\n4 1 0\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n4 0 1 2 3\n"
    )
    geo = read_off(str(quad))
    np.testing.assert_array_equal(geo.faces, [[0, 1, 2], [0, 2, 3]])

    bad = tmp_path / "penta.off"
    bad.write_text(
        "OFF\n5 1 0\n0 0 0\n1 0 0\n1 1 0\n0 1 0\n0.5 2 0\n5 0 1 2 3 4\n"
    )
    with pytest.raises(OffError, match="arity"):
        read_off(str(bad))


def test_ply_binary_truncated_raises(tmp_path):
    """A truncated binary face block raises PlyError, not a raw numpy error
    (r3 advisor finding)."""
    import numpy as np
    import pytest

    from align3d_tpu.io.geometry import Geometry
    from align3d_tpu.io.ply import PlyError, read_ply, write_ply

    rng = np.random.default_rng(0)
    geom = Geometry(
        points=rng.normal(size=(50, 3)).astype(np.float32),
        faces=rng.integers(0, 50, (30, 3)).astype(np.int64),
    )
    path = tmp_path / "t.ply"
    write_ply(path, geom, binary=True)
    data = path.read_bytes()
    (tmp_path / "trunc.ply").write_bytes(data[:-7])
    with pytest.raises(PlyError):
        read_ply(tmp_path / "trunc.ply")


def test_ply_binary_quads_rejected(tmp_path):
    """Binary non-triangle faces fail the fast path (count bytes != 3 or the
    block-size check) and raise via the slow path's triangle validation."""
    import struct

    import numpy as np
    import pytest

    from align3d_tpu.io.ply import PlyError, read_ply

    header = (
        b"ply\nformat binary_little_endian 1.0\n"
        b"element vertex 4\n"
        b"property float x\nproperty float y\nproperty float z\n"
        b"element face 1\n"
        b"property list uchar int vertex_indices\n"
        b"end_header\n"
    )
    body = b"".join(struct.pack("<3f", *v) for v in
                    [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0)])
    body += struct.pack("<B4i", 4, 0, 1, 2, 3)  # one quad
    path = tmp_path / "quad.ply"
    path.write_bytes(header + body)
    with pytest.raises(PlyError):
        read_ply(path)


def test_ply_ascii_teapot_roundtrip(tmp_path):
    """Read the reference's ASCII teapot.ply; write ASCII; read back equal.

    (Round-3 note: this coverage exposed a header-parse bug — scalar
    property names were read from the wrong token — so read_ply had never
    worked on standard files. Pinned here for good.)"""
    import numpy as np

    from align3d_tpu.io.ply import read_ply, write_ply

    geom = read_ply(ref_data_path("teapot.ply"))
    assert geom.points.shape == (480, 3)
    assert geom.normals is not None and geom.normals.shape == (480, 3)
    assert geom.faces is not None and geom.faces.shape == (880, 3)

    path = tmp_path / "teapot2.ply"
    write_ply(path, geom)
    back = read_ply(path)
    np.testing.assert_allclose(back.points, geom.points, rtol=1e-6)
    np.testing.assert_allclose(back.normals, geom.normals, rtol=1e-6)
    np.testing.assert_array_equal(back.faces, geom.faces)
