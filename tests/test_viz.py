"""Headless visualization tests (reference src/viz behavioral parity)."""

import math

import numpy as np
import pytest

from align3d_tpu.viz import (
    Node,
    OffscreenRenderer,
    Scene,
    Sphere3D,
    VirtualCameraSphericalBuilder,
)


def test_sphere_fit_and_union():
    pts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0]], np.float32)
    s = Sphere3D.from_points(pts)
    assert s.radius > 0
    other = Sphere3D(np.array([10.0, 0, 0], np.float32), 1.0)
    u = s.union(other)
    # Union contains both spheres.
    assert np.linalg.norm(u.center - s.center) + s.radius <= u.radius + 1e-5
    assert np.linalg.norm(u.center - other.center) + other.radius <= u.radius + 1e-5
    # Containment short-circuits (sphere3d.rs:60-66).
    inner = Sphere3D(s.center, s.radius * 0.1)
    assert s.union(inner).radius == s.radius


def test_spherical_fit_distance():
    # The fitted camera keeps the whole sphere inside fov_y
    # (virtual_camera.rs:100-121): distance must exceed radius / sin(fov/2).
    s = Sphere3D(np.zeros(3, np.float32), 2.0)
    b = VirtualCameraSphericalBuilder.fit(s, math.pi / 2.0)
    assert b.distance >= s.radius / math.sin(math.pi / 4.0) - 1e-5
    assert b.near_plane_distance == pytest.approx(b.distance - s.radius)
    cam = b.build()
    # Camera looks at the sphere center.
    to_center = s.center - cam.eye
    to_center /= np.linalg.norm(to_center)
    np.testing.assert_allclose(cam.view, to_center, atol=1e-6)


def test_point_render_coverage_and_depth():
    renderer = OffscreenRenderer(160, 120, background=(0, 0, 0, 255))
    scene = Scene()
    # Two overlapping clouds at different depths: red nearer than blue.
    n = 500
    rng = np.random.default_rng(0)
    xy = rng.uniform(-0.5, 0.5, size=(n, 2)).astype(np.float32)
    near = np.concatenate([xy, np.full((n, 1), 0.0, np.float32)], axis=1)
    far = np.concatenate([xy, np.full((n, 1), 1.0, np.float32)], axis=1)
    scene.add(Node(points=near, colors=np.tile([255, 0, 0], (n, 1))))
    scene.add(Node(points=far, colors=np.tile([0, 0, 255], (n, 1))))

    sphere = scene.bounding_sphere()
    cam = VirtualCameraSphericalBuilder.fit(sphere, math.pi / 2.0)
    cam.aspect_ratio = 160 / 120
    # Default camera orbits in front of -z; put it on the near side so the
    # red cloud occludes the blue one.
    cam.elevation = 0.3
    img = scene.render(renderer, cam.build())

    red = (img.color[..., 0] > 128) & (img.color[..., 2] < 64)
    blue = (img.color[..., 2] > 128) & (img.color[..., 0] < 64)
    assert red.sum() > 50  # nearer cloud visible
    assert red.sum() > blue.sum()  # and mostly occludes the farther one
    assert np.isfinite(img.depth[red]).all()


def test_mesh_render_shades_and_occludes():
    renderer = OffscreenRenderer(128, 96)
    scene = Scene()
    # A quad made of two triangles facing the camera.
    pts = np.array(
        [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32
    )
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    scene.add(Node(points=pts, faces=faces))
    sphere = scene.bounding_sphere()
    cam = VirtualCameraSphericalBuilder.fit(sphere, math.pi / 2.0)
    cam.aspect_ratio = 128 / 96
    img = scene.render(renderer, cam.build())
    covered = img.color[..., 3] == 255
    lit = img.color[..., 0] > 0
    assert covered.sum() > 500
    assert (lit & covered).sum() > 500


def test_visibility_toggle():
    from align3d_tpu.viz.viewers import GeoViewer

    v = GeoViewer(64, 48)
    v.add(np.random.default_rng(0).uniform(-1, 1, (100, 3)).astype(np.float32))
    img1 = v.render_frame()
    drawn = int((img1.color[..., 3] == 255).sum())
    v.toggle_visibility(0)
    with pytest.raises(ValueError):
        v.render_frame()  # empty scene -> empty sphere -> fit raises
    v.toggle_visibility(0)
    img2 = v.render_frame()
    assert int((img2.color[..., 3] == 255).sum()) == drawn


def test_geoviewer_orbit_writes_pngs(tmp_path):
    v = __import__("align3d_tpu.viz.viewers", fromlist=["GeoViewer"]).GeoViewer(64, 48)
    v.add(np.random.default_rng(1).uniform(-1, 1, (200, 3)).astype(np.float32))
    paths = v.run(tmp_path, n_frames=3)
    assert len(paths) == 3
    from PIL import Image

    for p in paths:
        im = Image.open(p)
        assert im.size == (64, 48)


def test_packed_color_u8():
    """Reference golden: ColorU8::new(255, 155, 55) packs to 0xRRGGBB
    (src/viz/geometry/datatypes.rs:92-98)."""
    import numpy as np

    from align3d_tpu.viz.datatypes import pack_color_u8, unpack_color_u8

    packed = pack_color_u8(np.array([255, 155, 55], np.uint8))
    assert (packed >> 16) & 0xFF == 255
    assert (packed >> 8) & 0xFF == 155
    assert packed & 0xFF == 55

    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (64, 3)).astype(np.uint8)
    np.testing.assert_array_equal(unpack_color_u8(pack_color_u8(rgb)), rgb)


def test_manager_bootstrap():
    """Manager picks the most capable backend (manager.rs:60-78 analog) and
    constructs renderers/viewers bound to it."""
    from align3d_tpu.viz.manager import Manager

    m = Manager.default()
    assert m.device.platform in ("gpu", "cpu")
    assert ":" in m.device_name
    r = m.renderer(64, 48)
    assert r.width == 64 and r.height == 48
    gv = m.geo_viewer(64, 48)
    assert gv.renderer.width == 64
