"""ICP behavioral tests with ground truth (reference accuracy bars).

* ImageIcp adjacent-frame alignment: angle error < 0.01 rad
  (reference ``src/icp/image_icp.rs:180-200``);
* point-cloud Icp: angle error < 0.1 rad (``src/icp/pcl_icp.rs:121-136``);
* multiscale smoke (``src/icp/multiscale.rs:81-96``).

The reference test fixtures pre-apply the bilateral depth filter; until the
bilateral op lands these run on raw depth, and the bars still hold.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from align3d_tpu.icp import Icp, IcpParams, ImageIcp, MsIcpParams, MultiscaleAlign
from align3d_tpu.metrics import TransformMetrics
from align3d_tpu.range_image import RangeImage, RangeImageBuilder


def build_range_image(frame):
    return (
        RangeImage.from_frame(frame)
        .with_normals()
        .with_intensity()
        .with_intensity_map()
    )


@pytest.fixture(scope="module")
def sample2_pair(sample2_dataset):
    ri0 = build_range_image(sample2_dataset.get(0))
    ri1 = build_range_image(sample2_dataset.get(1))
    gt = sample2_dataset.trajectory().get_relative_transform(1, 0)
    return ri0, ri1, gt


def test_image_icp_align(sample2_pair):
    ri0, ri1, gt = sample2_pair
    icp = ImageIcp(IcpParams(max_iterations=5), ri0)
    actual = icp.align(ri1)
    angle_diff = abs(float(TransformMetrics.new(actual, gt).angle))
    assert angle_diff < 0.01, angle_diff


def test_image_icp_align_fused_engine(sample2_pair):
    """The fused kernel (interpret mode here) meets the same reference
    accuracy bar on real 640x480 data as the ``xla`` engine, and lands on
    the same pose."""
    ri0, ri1, gt = sample2_pair
    fused = ImageIcp(
        IcpParams(max_iterations=5, engine="fused", interpret=True), ri0
    ).align(ri1)
    angle_diff = abs(float(TransformMetrics.new(fused, gt).angle))
    assert angle_diff < 0.01, angle_diff
    xla = ImageIcp(IcpParams(max_iterations=5), ri0).align(ri1)
    assert abs(float(TransformMetrics.new(fused, xla).angle)) < 1e-4


def test_image_icp_identity_on_same_frame(sample2_pair):
    ri0, _, _ = sample2_pair
    icp = ImageIcp(IcpParams(max_iterations=3), ri0)
    actual = icp.align(ri0)
    assert float(actual.angle()) < 1e-3
    assert float(jnp.linalg.norm(actual.translation)) < 1e-3


def test_multiscale_align(sample1_dataset):
    builder = RangeImageBuilder(with_intensity=True, with_normals=True)
    target = builder.build(sample1_dataset.get(0))
    source = builder.build(sample1_dataset.get(4))
    align = MultiscaleAlign(MsIcpParams.repeat(3, IcpParams()), target)
    result = align.align(source)
    # Smoke: result must be finite and small-ish for adjacent-ish frames.
    assert np.all(np.isfinite(np.asarray(result.rotation)))
    assert float(result.angle()) < 0.5


def test_pcl_icp_align(sample1_dataset):
    ri0 = build_range_image(sample1_dataset.get(0))
    ri1 = build_range_image(sample1_dataset.get(1))
    gt = sample1_dataset.trajectory().get_relative_transform(1, 0)

    n0 = ri0.height * ri0.width
    icp = Icp(
        IcpParams(max_iterations=5),
        target_points=ri0.points.reshape(n0, 3)[np.asarray(ri0.mask).reshape(-1)],
        target_normals=ri0.normals.reshape(n0, 3)[np.asarray(ri0.mask).reshape(-1)],
    )
    mask1 = np.asarray(ri1.mask).reshape(-1)
    actual = icp.align(
        ri1.points.reshape(-1, 3)[mask1],
        ri1.normals.reshape(-1, 3)[mask1],
    )
    angle_diff = abs(float(TransformMetrics.new(actual, gt).angle))
    assert angle_diff < 0.1, angle_diff
