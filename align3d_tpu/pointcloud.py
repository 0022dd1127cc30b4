"""PointCloud container (reference ``src/pointcloud.rs``).

The reference stores SoA arrays of only the VALID points (filtered at
construction, pointcloud.rs:8-38). This version keeps static shapes:
``points`` is (N, 3) with a boolean ``mask`` marking live entries — every op
treats masked-out rows as absent, which keeps conversions jittable and lets
clouds batch along a leading axis.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from align3d_tpu.se3 import Transform

Array = jax.Array


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class PointCloud:
    points: Array  # (N, 3) f32
    mask: Array  # (N,) bool
    normals: Optional[Array] = None  # (N, 3) f32
    colors: Optional[Array] = None  # (N, 3) u8

    def tree_flatten(self):
        return (self.points, self.mask, self.normals, self.colors), None

    @classmethod
    def tree_unflatten(cls, aux: Any, children):
        return cls(*children)

    def __len__(self) -> int:
        return self.points.shape[0]

    def len_valid(self) -> Array:
        return jnp.sum(self.mask.astype(jnp.int32))

    @classmethod
    def from_geometry(cls, geometry) -> "PointCloud":
        """From an io.Geometry (host arrays; all points valid)."""
        pts = jnp.asarray(np.asarray(geometry.points, np.float32))
        return cls(
            points=pts,
            mask=jnp.ones(pts.shape[0], bool),
            normals=None
            if geometry.normals is None
            else jnp.asarray(np.asarray(geometry.normals, np.float32)),
            colors=None
            if geometry.colors is None
            else jnp.asarray(np.asarray(geometry.colors, np.uint8)),
        )

    @classmethod
    def from_range_image(cls, ri) -> "PointCloud":
        """Flatten a RangeImage (reference From<&RangeImage>,
        structure.rs:375-405) keeping static shapes + mask."""
        n = ri.height * ri.width
        return cls(
            points=ri.points.reshape(n, 3),
            mask=ri.mask.reshape(n),
            normals=None if ri.normals is None else ri.normals.reshape(n, 3),
            colors=None if ri.colors is None else ri.colors.reshape(n, 3),
        )

    def transformed(self, transform: Transform) -> "PointCloud":
        """``&Transform * &PointCloud`` (pointcloud.rs:40-56): points map
        through the full transform, normals through the rotation."""
        return dataclasses.replace(
            self,
            points=transform.apply(self.points),
            normals=None
            if self.normals is None
            else transform.apply_normals(self.normals),
        )

    def compacted(self) -> "PointCloud":
        """Host-side: drop masked-out rows (matches the reference's filtered
        storage; NOT jittable — shapes become data-dependent)."""
        m = np.asarray(self.mask)
        return PointCloud(
            points=jnp.asarray(np.asarray(self.points)[m]),
            mask=jnp.ones(int(m.sum()), bool),
            normals=None
            if self.normals is None
            else jnp.asarray(np.asarray(self.normals)[m]),
            colors=None
            if self.colors is None
            else jnp.asarray(np.asarray(self.colors)[m]),
        )

    def to_geometry(self):
        """Host-side: compacted io.Geometry for PLY/OFF export."""
        from align3d_tpu.io.geometry import Geometry

        c = self.compacted()
        return Geometry(
            points=np.asarray(c.points),
            normals=None if c.normals is None else np.asarray(c.normals),
            colors=None if c.colors is None else np.asarray(c.colors),
        )
