"""align3d_tpu — a dense RGB-D alignment (ICP/odometry) framework in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of the reference
``align3d`` Rust crate (rigid RGB-D/point-cloud alignment via multiscale
point-to-plane + color ICP, preprocessing, datasets, trajectory metrics,
mesh/point-cloud I/O), run on NVIDIA GPUs:

* static shapes + validity masks everywhere (no filtered iterators),
* batch ("frame-pair") axis first: every op is ``vmap``-able,
* the ICP inner loop is a transform/project/gather/reduce step, in XLA or
  as one fused Pallas kernel (:mod:`align3d_tpu.ops.icp_fused`),
* scale-out via ``jax.sharding`` meshes (see :mod:`align3d_tpu.parallel`).

Public API mirrors the reference crate's module groups (se3/camera,
range_image, icp, trajectory, metrics, io) — see SURVEY.md for the layer map.
"""

from align3d_tpu import config as _config  # noqa: F401  (applies dtype policy)

from align3d_tpu.se3 import Transform
from align3d_tpu.camera import CameraIntrinsics, PinholeCamera
from align3d_tpu.pointcloud import PointCloud
from align3d_tpu.range_image import RangeImage, RangeImageBuilder
from align3d_tpu.trajectory import Trajectory, TrajectoryBuilder
from align3d_tpu.metrics import TransformMetrics
from align3d_tpu.icp.params import IcpParams, MsIcpParams
from align3d_tpu.icp.image_icp import ImageIcp
from align3d_tpu.icp.multiscale import MultiscaleAlign
from align3d_tpu.extra_math import angle_between_normals

__version__ = "0.1.0"

__all__ = [
    "Transform",
    "CameraIntrinsics",
    "PinholeCamera",
    "PointCloud",
    "RangeImage",
    "RangeImageBuilder",
    "Trajectory",
    "TrajectoryBuilder",
    "TransformMetrics",
    "IcpParams",
    "MsIcpParams",
    "ImageIcp",
    "MultiscaleAlign",
    "angle_between_normals",
]
