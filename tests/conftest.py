"""Test configuration.

Runs the suite on a virtual 8-device CPU mesh so the sharded paths
(`align3d_tpu.parallel`) execute without several accelerators, mirroring the
strategy in SURVEY.md §4.5. Must run before anything imports jax. Tests
that need an NVIDIA GPU carry the ``gpu`` marker and skip here through the
``gpu_device`` fixture.
"""

import os

# Unit tests run on the virtual CPU mesh; `chip_smoke.py` runs the GPU ones.
if not os.environ.get("ALIGN3D_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if not os.environ.get("ALIGN3D_TEST_GPU"):
    jax.config.update("jax_platforms", "cpu")

# Persistent XLA compilation cache: the suite recompiles the same ICP /
# pose-graph programs every run. Opt out with ALIGN3D_NO_COMPILE_CACHE=1
# (e.g. when bisecting compiler bugs).
if not os.environ.get("ALIGN3D_NO_COMPILE_CACHE"):
    from align3d_tpu.config import enable_compile_cache  # noqa: E402

    enable_compile_cache()
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from align3d_tpu import config  # noqa: E402

requires_ref_data = pytest.mark.skipif(
    not config.has_ref_data(),
    reason="reference fixture data not available (set ALIGN3D_REF_DATA)",
)


@pytest.fixture
def gpu_device():
    """The first NVIDIA GPU, or a skip. Tests marked ``gpu`` take it; the
    decision is made here, when the test runs, never at import."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (run through chip_smoke.py)")
    return gpus[0]


@pytest.fixture(scope="session")
def sample1_dataset():
    from align3d_tpu.io.datasets import SlamTbDataset

    if not config.has_ref_data():
        pytest.skip("reference fixture data not available")
    return SlamTbDataset.load(config.ref_data_path("rgbd", "sample1"))


@pytest.fixture(scope="session")
def sample2_dataset():
    from align3d_tpu.io.datasets import SlamTbDataset

    if not config.has_ref_data():
        pytest.skip("reference fixture data not available")
    return SlamTbDataset.load(config.ref_data_path("rgbd", "sample2"))


def _bloei_rgb() -> np.ndarray:
    from PIL import Image

    if not config.has_ref_data():
        pytest.skip("reference fixture data not available")
    img = Image.open(config.ref_data_path("images", "bloei.jpg")).convert("RGB")
    return np.asarray(img, dtype=np.uint8)


def _rust_image_luma(rgb: np.ndarray) -> np.ndarray:
    """Rec.709 integer luma as done by the Rust ``image`` crate (truncating)."""
    r = rgb[..., 0].astype(np.uint64)
    g = rgb[..., 1].astype(np.uint64)
    b = rgb[..., 2].astype(np.uint64)
    return (r * 2126 + g * 7152 + b * 722) // 10000


@pytest.fixture(scope="session")
def bloei_rgb() -> np.ndarray:
    return _bloei_rgb()


@pytest.fixture(scope="session")
def bloei_luma8() -> np.ndarray:
    """bloei.jpg via ``into_luma8`` semantics (reference src/unit_test/images.rs)."""
    return _rust_image_luma(_bloei_rgb()).astype(np.uint8)


@pytest.fixture(scope="session")
def bloei_luma16() -> np.ndarray:
    """bloei.jpg via ``into_luma16`` then ``v /= u16::MAX / 5000`` (= integer /13).

    Mirrors ``src/unit_test/images.rs:28-40``: channels are widened u8->u16
    (x257) before the Rec.709 integer luma, then divided by 13.
    """
    rgb16 = _bloei_rgb().astype(np.uint64) * 257
    luma16 = (rgb16[..., 0] * 2126 + rgb16[..., 1] * 7152 + rgb16[..., 2] * 722) // 10000
    return (luma16 // (np.iinfo(np.uint16).max // 5000)).astype(np.uint16)
