"""Dataset protocol + subset wrapper (reference ``src/io/dataset/core.rs``)."""

from __future__ import annotations

from typing import Protocol, Sequence, runtime_checkable

import numpy as np

from align3d_tpu.camera import CameraIntrinsics
from align3d_tpu.image import RgbdFrame
from align3d_tpu.io import png
from align3d_tpu.se3 import Transform
from align3d_tpu.trajectory import Trajectory


class DatasetError(Exception):
    pass


@runtime_checkable
class RgbdDataset(Protocol):
    """Protocol mirroring the reference trait (core.rs:47-53)."""

    def __len__(self) -> int: ...

    def get(self, index: int) -> RgbdFrame: ...

    def trajectory(self) -> Trajectory | None: ...

    def camera(self, index: int) -> tuple[CameraIntrinsics, Transform | None]: ...


class SubsetDataset:
    """Index-remapping wrapper incl. trajectory re-basing (core.rs:55-93)."""

    def __init__(self, dataset: RgbdDataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self) -> int:
        return len(self.indices)

    def get(self, index: int) -> RgbdFrame:
        return self.dataset.get(self.indices[index])

    def trajectory(self) -> Trajectory | None:
        orig = self.dataset.trajectory()
        if orig is None:
            return None
        poses = [orig.camera_to_world[i] for i in self.indices]
        return Trajectory.from_list(poses, np.arange(len(poses), dtype=np.float32))

    def camera(self, index: int):
        return self.dataset.camera(self.indices[index])


def _is_png(path) -> bool:
    return str(path).lower().endswith(".png")


def _open_with_pillow(path):
    """Non-PNG frames (IndoorLidar's JPEG colour) need Pillow, imported only
    here so the PNG path never depends on it."""
    try:
        from PIL import Image
    except ImportError as e:
        raise DatasetError(
            f"decoding {path} needs Pillow, which is not installed"
        ) from e
    return Image.open(path)


def load_rgb(path) -> np.ndarray:
    """Decode a color frame to (H, W, 3) u8: native C++ (libjpeg/libpng)
    when built (align3d_tpu/io/native_loader.py), else the numpy PNG reader,
    else Pillow for other formats."""
    from align3d_tpu.io import native_loader

    if native_loader.available():
        try:
            return native_loader.decode_rgb(str(path))
        except IOError:
            pass  # fall back for exotic formats
    if not _is_png(path):
        return np.asarray(_open_with_pillow(path).convert("RGB"), dtype=np.uint8)
    img = png.read_png(path)
    if img.dtype != np.uint8:
        raise DatasetError(f"expected an 8-bit color PNG, got {img.dtype} in {path}")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=-1)
    if img.shape[-1] == 2:  # gray + alpha
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def load_depth_u16(path) -> np.ndarray:
    from align3d_tpu.io import native_loader

    if _is_png(path) and native_loader.available():
        try:
            return native_loader.decode_depth(str(path))
        except IOError:
            pass
    arr = png.read_png(path) if _is_png(path) else np.asarray(_open_with_pillow(path))
    if arr.ndim != 2:
        raise DatasetError(f"expected a single-channel depth image in {path}")
    if arr.dtype == np.uint16:
        return arr
    if arr.dtype == np.int32:  # PIL mode "I" for 16-bit images
        return arr.astype(np.uint16)
    if arr.dtype == np.uint8:
        return arr.astype(np.uint16)
    raise DatasetError(f"unsupported depth dtype {arr.dtype} for {path}")


class PrefetchingDataset:
    """Wrap a path-exposing dataset with the native decode-ahead pipeline.

    Image decode moves to the C++ worker pool (io/native_loader.py) which
    stays ``prefetch`` frames ahead of the consumer — the host overlaps
    JPEG/PNG decode with device compute during sequential odometry. Frame
    metadata (camera, pose, depth scale) still comes from the wrapped
    dataset.

    Requires the wrapped dataset to implement ``frame_paths()`` and the
    native library to be built (``make -C native``); :func:`maybe_prefetch`
    falls back to the plain dataset otherwise.
    """

    def __init__(self, dataset, n_threads: int = 4, prefetch: int = 8):
        from align3d_tpu.io import native_loader

        colors, depths = dataset.frame_paths()
        self.dataset = dataset
        self.loader = native_loader.PrefetchLoader(
            colors, depths, n_threads=n_threads, prefetch=prefetch
        )

    def __len__(self) -> int:
        return len(self.dataset)

    def get(self, index: int) -> RgbdFrame:
        meta = self.dataset.get_meta(index) if hasattr(self.dataset, "get_meta") else None
        color, depth = self.loader.get(index)
        if meta is None:
            # Reuse the wrapped dataset's frame assembly but swap the images.
            frame = self.dataset.get(index)
            from align3d_tpu.image import RgbdImage

            return RgbdFrame(
                camera=frame.camera,
                image=RgbdImage(color, depth, frame.image.depth_scale),
                camera_to_world=frame.camera_to_world,
            )
        camera, pose, depth_scale = meta
        from align3d_tpu.image import RgbdImage

        return RgbdFrame(
            camera=camera,
            image=RgbdImage(color, depth, depth_scale),
            camera_to_world=pose,
        )

    def trajectory(self):
        return self.dataset.trajectory()

    def camera(self, index: int):
        return self.dataset.camera(index)

    def close(self) -> None:
        self.loader.close()


def maybe_prefetch(dataset, n_threads: int = 4, prefetch: int = 8):
    """Wrap with PrefetchingDataset when the native loader + paths exist."""
    from align3d_tpu.io import native_loader

    if hasattr(dataset, "frame_paths") and native_loader.available():
        try:
            return PrefetchingDataset(dataset, n_threads=n_threads, prefetch=prefetch)
        except Exception:
            return dataset
    return dataset
