"""Device/render-context bootstrap — the reference ``Manager`` equivalent.

The reference's ``Manager`` (``src/viz/manager.rs:22-99``) owns the Vulkan
instance, picks the best physical device (discrete GPU preferred,
``manager.rs:60-78``), and hands queues to every window/renderer. This
framework has no Vulkan: compute devices are JAX's, and rendering is the
software z-buffer (``viz/render.py``) presented either offscreen (PNG/GIF)
or through the interactive web viewer (``viz/interactive.py``). ``Manager``
plays the same role at those seams: enumerate backends once, pick the best
compute device with the same "discrete first" spirit (gpu > cpu), and
construct renderers/viewers bound to that choice.
"""

from __future__ import annotations

import dataclasses

import jax

_DEVICE_PREFERENCE = ("gpu", "cpu")  # manager.rs:60-78 analog


@dataclasses.dataclass
class Manager:
    """Backend bootstrap; construct once, hand to viewers (manager.rs:22-46).

    ``device`` is the chosen compute device; ``renderer_factory`` builds
    software renderers bound to nothing device-specific (the raster runs on
    host, like the reference's presentation queue living outside compute).
    """

    device: jax.Device

    @classmethod
    def default(cls) -> "Manager":
        """Pick the most capable backend present (manager.rs ``Default``)."""
        devices = jax.devices()
        for kind in _DEVICE_PREFERENCE:
            match = [d for d in devices if d.platform == kind]
            if match:
                return cls(device=match[0])
        return cls(device=devices[0])

    @property
    def device_name(self) -> str:
        return f"{self.device.platform}:{self.device.id}"

    def renderer(self, width: int = 640, height: int = 480):
        from align3d_tpu.viz.render import OffscreenRenderer

        return OffscreenRenderer(width, height)

    def geo_viewer(self, width: int = 640, height: int = 480):
        from align3d_tpu.viz.viewers import GeoViewer

        return GeoViewer(width, height)

    def dataset_viewer(self, dataset, width: int = 640, height: int = 480):
        from align3d_tpu.viz.viewers import RgbdDatasetViewer

        return RgbdDatasetViewer(dataset, width, height)
