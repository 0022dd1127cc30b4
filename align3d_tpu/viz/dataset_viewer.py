"""One-shot dataset preview renders + animated fly-throughs for the CLI
``viewer`` subcommand and the odometry ``--show`` flag.

Functional parity with the reference's interactive ``RgbdDatasetViewer``
(``src/viz/rgbd_dataset_viewer.rs:37-57``): where the reference opens a
winit window and orbits with WASD/mouse
(``src/viz/controllers/virtual_camera_controller.rs:56-98``), these render
the same scene through the same spherical-fit camera math into a PNG or an
animated GIF orbit — the headless equivalent (compute hosts have no
display; the no-interactive-window decision is documented in README).
"""

from __future__ import annotations

import math

import numpy as np

from align3d_tpu.viz.viewers import RgbdDatasetViewer


def trajectory_polyline(trajectory, samples_per_edge: int = 24) -> np.ndarray:
    """Dense (N, 3) points tracing the trajectory's camera centers — an
    overlay the reference's viewer lacks (beyond-parity)."""
    centers = np.asarray(
        [np.asarray(trajectory[i].translation) for i in range(len(trajectory))],
        np.float32,
    )
    if len(centers) < 2:
        return centers.reshape(-1, 3)
    segs = []
    for a, b in zip(centers[:-1], centers[1:]):
        t = np.linspace(0.0, 1.0, samples_per_edge, endpoint=False)[:, None]
        segs.append(a[None] * (1.0 - t) + b[None] * t)
    segs.append(centers[-1:])
    return np.concatenate(segs, axis=0)


def _add_trajectory_overlay(viewer, trajectory) -> None:
    if trajectory is None or len(trajectory) == 0:
        return
    line = trajectory_polyline(trajectory)
    colors = np.broadcast_to(
        np.array([255, 64, 32], np.uint8), (len(line), 3)
    ).copy()
    viewer.viewer.add(line, colors=colors)


def render_dataset_preview(
    fmt: str,
    path: str,
    output: str,
    max_frames: int | None = None,
    width: int = 640,
    height: int = 480,
    trajectory=None,
) -> str:
    """Load a dataset, pose every frame's point cloud by its trajectory
    (``trajectory`` overrides the dataset's own — the odometry ``--show``
    path), overlay the trajectory polyline, and render a single fitted view
    to ``output`` (PNG)."""
    from align3d_tpu.io.datasets import load_dataset

    dataset = load_dataset(fmt, path)
    viewer = RgbdDatasetViewer(dataset, width=width, height=height)
    viewer.build_scene(max_frames=max_frames, stride=1, trajectory=trajectory)
    _add_trajectory_overlay(
        viewer, trajectory if trajectory is not None else dataset.trajectory()
    )
    img = viewer.viewer.render_frame()
    img.save_png(output)
    return output


def render_dataset_flythrough(
    fmt: str,
    path: str,
    output: str,
    max_frames: int | None = None,
    width: int = 480,
    height: int = 360,
    n_views: int = 24,
    trajectory=None,
    ms_per_frame: int = 120,
) -> str:
    """Animated orbit of the reconstructed scene (GIF via PIL) with the
    trajectory polyline overlaid — the headless stand-in for the reference's
    interactive event loop (``window.rs:145-385``): each GIF frame is one
    step of the orbiting camera controller."""
    from PIL import Image

    from align3d_tpu.io.datasets import load_dataset

    dataset = load_dataset(fmt, path)
    viewer = RgbdDatasetViewer(dataset, width=width, height=height)
    viewer.build_scene(max_frames=max_frames, stride=1, trajectory=trajectory)
    _add_trajectory_overlay(
        viewer, trajectory if trajectory is not None else dataset.trajectory()
    )

    frames = []
    for k in range(n_views):
        az = 2.0 * math.pi * k / n_views
        el = 0.35 * math.sin(2.0 * math.pi * k / n_views)
        img = viewer.viewer.render_frame(azimuth=az, elevation=el)
        frames.append(Image.fromarray(np.asarray(img.color)[..., :3]))
    frames[0].save(
        output,
        save_all=True,
        append_images=frames[1:],
        duration=ms_per_frame,
        loop=0,
    )
    return output
