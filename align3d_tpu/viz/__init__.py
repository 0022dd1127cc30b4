"""Headless visualization (counterpart of the reference ``src/viz``).

The reference's Vulkan stack (manager/window/swapchain, ~2.6k LoC of
rendering plumbing, SURVEY §2.5) exists to *look at* point clouds, meshes and
trajectories. This package provides the same capabilities headlessly:
host-side software rendering to PNG — no display server, works in CI and on
remote machines — with the reference's camera math (virtual camera,
spherical fit, perspective frustum) reproduced exactly so fit-to-scene
framing matches.

Components:
* :mod:`sphere` — bounding spheres (viz/sphere3d.rs)
* :mod:`virtual_camera` — look-at camera + spherical builder + perspective
  projection (viz/virtual_camera.rs, viz/virtual_projection.rs)
* :mod:`render` — z-buffered point-splat and triangle rasterizer
  (the software analog of vkpointcloud's surfel quads and vkmesh's
  diffuse pipeline)
* :mod:`scene` — node/scene graph (viz/node.rs, viz/scene.rs)
* :mod:`viewers` — GeoViewer / RgbdDatasetViewer equivalents that write
  PNG frames (viz/geoviewer.rs, viz/rgbd_dataset_viewer.rs)
* :mod:`interactive` — the windowed event loop as a localhost web app:
  WASD fly, drag orbit, number-key toggles, quit (viz/window.rs:145-385,
  viz/controllers/virtual_camera_controller.rs:56-98)
* :mod:`manager` — backend bootstrap picking the most capable device
  (viz/manager.rs:22-99 analog)
"""

from align3d_tpu.viz.manager import Manager
from align3d_tpu.viz.render import OffscreenRenderer
from align3d_tpu.viz.scene import Node, Scene
from align3d_tpu.viz.sphere import Sphere3D
from align3d_tpu.viz.virtual_camera import (
    PerspectiveProjection,
    VirtualCamera,
    VirtualCameraSphericalBuilder,
)

__all__ = [
    "Manager",
    "Node",
    "OffscreenRenderer",
    "PerspectiveProjection",
    "Scene",
    "Sphere3D",
    "VirtualCamera",
    "VirtualCameraSphericalBuilder",
]
