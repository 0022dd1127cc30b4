"""Headless viewers (reference ``src/viz/geoviewer.rs``,
``src/viz/rgbd_dataset_viewer.rs``).

The reference viewers open an interactive Vulkan window; these render the
same scenes headlessly to PNG frames — suitable for CI artifacts, remote
machines and notebooks. Framing uses the reference's
spherical fit so the compositions match.
"""

from __future__ import annotations

import math
import os

import numpy as np

from align3d_tpu.viz.render import OffscreenRenderer
from align3d_tpu.viz.scene import Node, Scene
from align3d_tpu.viz.virtual_camera import VirtualCameraSphericalBuilder


class GeoViewer:
    """Accumulate geometries, render orbit frames (geoviewer.rs:7-67)."""

    def __init__(self, width: int = 640, height: int = 480):
        self.scene = Scene()
        self.renderer = OffscreenRenderer(width, height)

    def add(self, points, colors=None, faces=None, normals=None, transform=None) -> Node:
        node = Node(
            points=np.asarray(points, np.float32).reshape(-1, 3),
            colors=None if colors is None else np.asarray(colors, np.uint8).reshape(-1, 3),
            faces=None if faces is None else np.asarray(faces),
            normals=None if normals is None else np.asarray(normals, np.float32),
        )
        if transform is not None:
            node.transform = np.asarray(transform, np.float32)
        return self.scene.add(node)

    def add_geometry(self, geometry) -> Node:
        """Add an io.Geometry (points/colors/faces/normals)."""
        return self.add(
            geometry.points,
            colors=geometry.colors,
            faces=geometry.faces,
            normals=geometry.normals,
        )

    def toggle_visibility(self, index: int) -> None:
        """Number-key visibility toggles (geoviewer.rs:50-67)."""
        self.scene.nodes[index].visible = not self.scene.nodes[index].visible

    def render_frame(self, azimuth: float = 0.0, elevation: float = 0.0):
        sphere = self.scene.bounding_sphere()
        builder = VirtualCameraSphericalBuilder.fit(sphere, math.pi / 2.0)
        builder.azimuth = azimuth
        builder.elevation = elevation
        builder.aspect_ratio = self.renderer.width / self.renderer.height
        camera = builder.build()
        return self.scene.render(self.renderer, camera)

    def show(self, port: int = 8700) -> None:
        """Interactive window equivalent (geoviewer.rs ``run``): serve the
        scene at http://127.0.0.1:<port>/ with WASD fly, drag orbit and
        number-key visibility toggles."""
        from align3d_tpu.viz.interactive import InteractiveViewer

        InteractiveViewer(
            self.scene, self.renderer.width, self.renderer.height
        ).run(port=port)

    def run(self, out_dir, n_frames: int = 8) -> list[str]:
        """Render an orbit of ``n_frames`` PNGs (the headless "event loop")."""
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for k in range(n_frames):
            img = self.render_frame(azimuth=2.0 * math.pi * k / n_frames)
            path = os.path.join(out_dir, f"frame_{k:03d}.png")
            img.save_png(path)
            paths.append(path)
        return paths


class RgbdDatasetViewer:
    """One posed point cloud per dataset frame (rgbd_dataset_viewer.rs:9-57)."""

    def __init__(self, dataset, width: int = 640, height: int = 480):
        self.dataset = dataset
        self.viewer = GeoViewer(width, height)

    def build_scene(
        self, max_frames: int | None = None, stride: int = 1, trajectory=None
    ) -> Scene:
        """``trajectory`` overrides the dataset's own poses (used by the
        odometry CLI's ``--show`` to render the ESTIMATED trajectory)."""
        from align3d_tpu.range_image import RangeImage

        traj = trajectory if trajectory is not None else self.dataset.trajectory()
        n = len(self.dataset)
        if max_frames is not None:
            n = min(n, max_frames * stride)
        for i in range(0, n, stride):
            frame = self.dataset.get(i)
            ri = RangeImage.from_frame(frame).with_intensity()
            pts = np.asarray(ri.points).reshape(-1, 3)
            mask = np.asarray(ri.mask).reshape(-1)
            colors = np.asarray(ri.colors).reshape(-1, 3)
            transform = np.eye(4, dtype=np.float32)
            if traj is not None and i < len(traj):
                transform = np.asarray(traj[i].to_matrix4(), np.float32)
            self.viewer.add(
                pts[mask], colors=colors[mask], transform=transform
            )
        return self.viewer.scene

    def run(self, out_dir, max_frames: int | None = 8, n_views: int = 4) -> list[str]:
        self.build_scene(max_frames=max_frames)
        return self.viewer.run(out_dir, n_frames=n_views)

    def show(self, max_frames: int | None = 8, port: int = 8700) -> None:
        """Interactive window equivalent (reference
        rgbd_dataset_viewer.rs ``run`` -> Window event loop): serve the
        scene at http://127.0.0.1:<port>/ with WASD/orbit/toggles."""
        from align3d_tpu.viz.interactive import InteractiveViewer

        self.build_scene(max_frames=max_frames)
        InteractiveViewer(
            self.viewer.scene,
            self.viewer.renderer.width,
            self.viewer.renderer.height,
        ).run(port=port)
