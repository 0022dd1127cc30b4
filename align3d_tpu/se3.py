"""SE(3) rigid transforms as batched JAX arrays.

Counterpart of the reference's ``Transform`` wrapper over
``nalgebra::Isometry3`` (reference ``src/transform.rs:18``). Instead of a
quaternion+translation object graph we store a rotation matrix ``(..., 3, 3)``
and translation ``(..., 3)`` — matrix form composes/applies via small matmuls
and batches over arbitrary leading axes, so a whole
trajectory is a single ``Transform`` with a leading frame axis.

The se(3) exponential mirrors the Sophus-derived Taylor fallbacks of the
reference (``src/transform.rs:44-118``) so small-angle updates match.
All functions are pure, jittable and vmappable.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from align3d_tpu.config import MATMUL_PRECISION

Array = jax.Array

# Matches EPSILON in the reference exp implementations (src/transform.rs:45,84).
_EPSILON = 1e-8


def _skew(v: Array) -> Array:
    """Cross-product (skew-symmetric) matrix of ``v``: shape (...,3) -> (...,3,3)."""
    zeros = jnp.zeros_like(v[..., 0])
    return jnp.stack(
        [
            jnp.stack([zeros, -v[..., 2], v[..., 1]], axis=-1),
            jnp.stack([v[..., 2], zeros, -v[..., 0]], axis=-1),
            jnp.stack([-v[..., 1], v[..., 0], zeros], axis=-1),
        ],
        axis=-2,
    )


def quat_to_matrix(quat: Array) -> Array:
    """Quaternion ``(..., 4)`` in (w, x, y, z) order -> rotation matrix ``(..., 3, 3)``.

    Normalizes like ``UnitQuaternion::from_quaternion`` so slightly off-unit
    quaternions (Taylor branches, file input) still yield orthonormal R.
    """
    w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    norm_sq = w * w + x * x + y * y + z * z
    s = 2.0 / jnp.maximum(norm_sq, jnp.finfo(quat.dtype).tiny)
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return jnp.stack(
        [
            jnp.stack([1.0 - (yy + zz), xy - wz, xz + wy], axis=-1),
            jnp.stack([xy + wz, 1.0 - (xx + zz), yz - wx], axis=-1),
            jnp.stack([xz - wy, yz + wx, 1.0 - (xx + yy)], axis=-1),
        ],
        axis=-2,
    )


def matrix_to_quat(rot: Array) -> Array:
    """Rotation matrix ``(..., 3, 3)`` -> quaternion ``(..., 4)`` (w, x, y, z), w >= 0.

    Branchless Shepperd-style extraction: compute all four candidate
    quaternions and select the best-conditioned one with ``where`` — the
    branch-free replacement for the usual trace-sign branching.
    """
    m00, m01, m02 = rot[..., 0, 0], rot[..., 0, 1], rot[..., 0, 2]
    m10, m11, m12 = rot[..., 1, 0], rot[..., 1, 1], rot[..., 1, 2]
    m20, m21, m22 = rot[..., 2, 0], rot[..., 2, 1], rot[..., 2, 2]

    # Four candidates, each numerically stable in a different region.
    def build(t, a, b, c, d):
        s = jnp.sqrt(jnp.maximum(t, 1e-24))
        return jnp.stack([a / s, b / s, c / s, d / s], axis=-1) * 0.5, t

    qw, tw = build(1.0 + m00 + m11 + m22, 1.0 + m00 + m11 + m22, m21 - m12, m02 - m20, m10 - m01)
    qx, tx = build(1.0 + m00 - m11 - m22, m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20)
    qy, ty = build(1.0 - m00 + m11 - m22, m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21)
    qz, tz = build(1.0 - m00 - m11 + m22, m10 - m01, m20 + m02, m12 + m21, 1.0 - m00 - m11 + m22)

    # Pick the candidate with the largest pivot.
    cand = jnp.stack([qw, qx, qy, qz], axis=-2)  # (..., 4, 4)
    pivots = jnp.stack([tw, tx, ty, tz], axis=-1)  # (..., 4)
    idx = jnp.argmax(pivots, axis=-1)
    quat = jnp.take_along_axis(cand, idx[..., None, None].repeat(4, axis=-1), axis=-2)[..., 0, :]
    quat = quat / jnp.linalg.norm(quat, axis=-1, keepdims=True)
    # Canonical sign: w >= 0.
    return jnp.where(quat[..., :1] < 0, -quat, quat)


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class Transform:
    """A (batch of) rigid transform(s): ``x -> rotation @ x + translation``.

    ``rotation``: (..., 3, 3) f32, ``translation``: (..., 3) f32. Leading axes
    broadcast through every op, so a trajectory is simply a Transform with a
    leading frame axis.
    """

    rotation: Array
    translation: Array

    # -- pytree plumbing -------------------------------------------------
    def tree_flatten(self):
        return (self.rotation, self.translation), None

    @classmethod
    def tree_unflatten(cls, aux: Any, children):
        return cls(*children)

    # -- constructors ----------------------------------------------------
    @classmethod
    def identity(cls, batch_shape: tuple = (), dtype=jnp.float32) -> "Transform":
        """Identity transform (reference ``Transform::eye``, src/transform.rs:29)."""
        rot = jnp.broadcast_to(jnp.eye(3, dtype=dtype), batch_shape + (3, 3))
        t = jnp.zeros(batch_shape + (3,), dtype=dtype)
        return cls(rot, t)

    @classmethod
    def from_quat(cls, translation: Array, quat_wxyz: Array) -> "Transform":
        """From translation + (w,x,y,z) quaternion (reference ``Transform::new``)."""
        translation = jnp.asarray(translation, jnp.float32)
        quat_wxyz = jnp.asarray(quat_wxyz, jnp.float32)
        return cls(quat_to_matrix(quat_wxyz), translation)

    @classmethod
    def from_matrix4(cls, matrix: Array) -> "Transform":
        """From a homogeneous (..., 4, 4) matrix (reference src/transform.rs:121).

        The reference re-orthonormalizes via ``Rotation3::from_matrix``; we do
        the same through a quaternion round-trip.
        """
        matrix = jnp.asarray(matrix, jnp.float32)
        rot = quat_to_matrix(matrix_to_quat(matrix[..., :3, :3]))
        return cls(rot, matrix[..., :3, 3])

    @classmethod
    def exp(cls, twist: Array) -> "Transform":
        """se(3) exponential of ``[vx, vy, vz, wx, wy, wz]`` (..., 6).

        Mirrors the Sophus-ported implementation of the reference
        (``src/transform.rs:44-118``) including its Taylor fallbacks:
        quaternion factors switch at ``theta_sq < EPSILON**2`` and the left
        Jacobian at ``theta_sq < EPSILON``.
        """
        twist = jnp.asarray(twist, jnp.float32)
        v, omega = twist[..., :3], twist[..., 3:]
        theta_sq = jnp.sum(omega * omega, axis=-1)

        # --- SO(3) part via quaternion (src/transform.rs:44-71).
        small_q = theta_sq < _EPSILON * _EPSILON
        theta = jnp.sqrt(jnp.where(small_q, 1.0, theta_sq))  # safe sqrt
        theta_po4 = theta_sq * theta_sq
        imag = jnp.where(
            small_q,
            0.5 - (1.0 / 48.0) * theta_sq + (1.0 / 3840.0) * theta_po4,
            jnp.sin(0.5 * theta) / theta,
        )
        real = jnp.where(
            small_q,
            1.0 - (1.0 / 8.0) * theta_sq + (1.0 / 384.0) * theta_po4,
            jnp.cos(0.5 * theta),
        )
        quat = jnp.concatenate([real[..., None], imag[..., None] * omega], axis=-1)
        rot = quat_to_matrix(quat)

        # --- translation via the SO(3) left Jacobian (src/transform.rs:91-105).
        big_omega = _skew(omega)
        big_omega_sq = jnp.matmul(big_omega, big_omega, precision=MATMUL_PRECISION)
        small_j = (theta_sq < _EPSILON)[..., None, None]
        eye = jnp.broadcast_to(jnp.eye(3, dtype=twist.dtype), big_omega.shape)
        safe_theta_sq = jnp.where(theta_sq < _EPSILON, 1.0, theta_sq)[..., None, None]
        safe_theta = jnp.where(theta_sq < _EPSILON, 1.0, theta)[..., None, None]
        v_jac_large = (
            eye
            + (1.0 - jnp.cos(safe_theta)) / safe_theta_sq * big_omega
            + (safe_theta - jnp.sin(safe_theta)) / (safe_theta_sq * safe_theta) * big_omega_sq
        )
        v_jac_small = eye + 0.5 * big_omega
        v_jac = jnp.where(small_j, v_jac_small, v_jac_large)
        translation = jnp.einsum("...ij,...j->...i", v_jac, v, precision=MATMUL_PRECISION)
        return cls(rot, translation)

    def log(self) -> Array:
        """se(3) logarithm: the twist ``[vx, vy, vz, wx, wy, wz]`` with
        ``Transform.exp(T.log()) == T``. Inverse of :meth:`exp`; used by the
        pose-graph residuals (align3d_tpu/parallel/pose_graph.py). Taylor
        fallback for small angles mirrors the exp side."""
        rot = self.rotation
        trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
        cos_theta = jnp.clip((trace - 1.0) * 0.5, -1.0, 1.0)
        # Gradient safety: arccos'(1) is infinite and `where` does not stop
        # NaN gradients from the untaken branch (this function sits under
        # jax.jacfwd in the pose-graph edge Jacobians), so the small-angle
        # branch must never see cos_theta near 1 inside arccos.
        small = cos_theta > 1.0 - 1e-6
        safe_cos = jnp.where(small, 0.0, cos_theta)
        theta = jnp.where(small, 0.0, jnp.arccos(safe_cos))
        # theta^2 to O(theta^4), valid in both branches (used by Taylors).
        one_m_cos = 1.0 - cos_theta
        theta_sq = jnp.where(
            small, 2.0 * one_m_cos * (1.0 + one_m_cos / 6.0), theta * theta
        )
        # so(3) log: omega_hat = theta / (2 sin theta) * (R - R^T)
        sin_theta = jnp.sin(jnp.where(small, 1.0, theta))
        factor = jnp.where(
            small,
            0.5 + theta_sq / 12.0,  # Taylor of theta / (2 sin theta)
            theta / (2.0 * sin_theta),
        )
        skew = rot - jnp.swapaxes(rot, -1, -2)
        omega = factor[..., None] * jnp.stack(
            [skew[..., 2, 1], skew[..., 0, 2], skew[..., 1, 0]], axis=-1
        )
        # v = V^{-1} t with the closed-form left-Jacobian inverse.
        big_omega = _skew(omega)
        big_omega_sq = jnp.matmul(big_omega, big_omega, precision=MATMUL_PRECISION)
        eye = jnp.broadcast_to(jnp.eye(3, dtype=rot.dtype), rot.shape)
        safe_theta = jnp.where(small, 1.0, theta)
        safe_theta_sq = jnp.where(small, 1.0, theta_sq)
        coef = jnp.where(
            small,
            1.0 / 12.0 + theta_sq / 720.0,
            (
                1.0
                - 0.5 * safe_theta * jnp.cos(0.5 * safe_theta) / jnp.sin(0.5 * safe_theta)
            )
            / safe_theta_sq,
        )
        v_inv = eye - 0.5 * big_omega + coef[..., None, None] * big_omega_sq
        v = jnp.einsum("...ij,...j->...i", v_inv, self.translation, precision=MATMUL_PRECISION)
        return jnp.concatenate([v, omega], axis=-1)

    # -- core ops --------------------------------------------------------
    def compose(self, other: "Transform") -> "Transform":
        """``self @ other`` — ``other`` is applied first (src/transform.rs:205-220)."""
        rot = jnp.matmul(self.rotation, other.rotation, precision=MATMUL_PRECISION)
        t = (
            jnp.einsum("...ij,...j->...i", self.rotation, other.translation, precision=MATMUL_PRECISION)
            + self.translation
        )
        return Transform(rot, t)

    def __matmul__(self, other: "Transform") -> "Transform":
        return self.compose(other)

    def inverse(self) -> "Transform":
        rot_t = jnp.swapaxes(self.rotation, -1, -2)
        return Transform(rot_t, -jnp.einsum("...ij,...j->...i", rot_t, self.translation, precision=MATMUL_PRECISION))

    def apply(self, points: Array) -> Array:
        """Transform points ``(..., N, 3)`` or ``(..., 3)`` (src/transform.rs:138)."""
        if points.ndim >= 2 and self.rotation.ndim == 2:
            return (
                jnp.matmul(points, self.rotation.T, precision=MATMUL_PRECISION)
                + self.translation
            )
        return (
            jnp.einsum("...ij,...j->...i", self.rotation, points, precision=MATMUL_PRECISION) + self.translation
        )

    def apply_batch(self, points: Array) -> Array:
        """Batched transform: self (..., 3, 3) applied to points (..., N, 3)."""
        return (
            jnp.einsum("...ij,...nj->...ni", self.rotation, points, precision=MATMUL_PRECISION)
            + self.translation[..., None, :]
        )

    def apply_normals(self, normals: Array) -> Array:
        """Rotate-only transform for normals (src/transform.rs:151)."""
        if normals.ndim >= 2 and self.rotation.ndim == 2:
            return jnp.matmul(normals, self.rotation.T, precision=MATMUL_PRECISION)
        return jnp.einsum("...ij,...j->...i", self.rotation, normals, precision=MATMUL_PRECISION)

    def apply_normals_batch(self, normals: Array) -> Array:
        return jnp.einsum("...ij,...nj->...ni", self.rotation, normals, precision=MATMUL_PRECISION)

    # -- conversions / metrics ------------------------------------------
    def to_matrix4(self) -> Array:
        batch = self.rotation.shape[:-2]
        mat = jnp.zeros(batch + (4, 4), dtype=self.rotation.dtype)
        mat = mat.at[..., :3, :3].set(self.rotation)
        mat = mat.at[..., :3, 3].set(self.translation)
        return mat.at[..., 3, 3].set(1.0)

    def to_quat(self) -> Array:
        """Rotation as a (w,x,y,z) quaternion with w >= 0."""
        return matrix_to_quat(self.rotation)

    def angle(self) -> Array:
        """Rotation angle in radians (nalgebra ``rotation.angle()`` analog)."""
        quat = self.to_quat()
        return 2.0 * jnp.arctan2(
            jnp.linalg.norm(quat[..., 1:], axis=-1), jnp.abs(quat[..., 0])
        )

    @property
    def batch_shape(self) -> tuple:
        return self.rotation.shape[:-2]

    def __getitem__(self, idx) -> "Transform":
        return Transform(self.rotation[idx], self.translation[idx])

    def __len__(self) -> int:
        if not self.batch_shape:
            raise TypeError("scalar Transform has no len()")
        return self.batch_shape[0]

    # NumPy convenience for host-side code (datasets, I/O).
    def numpy_matrix4(self) -> np.ndarray:
        return np.asarray(self.to_matrix4())


def stack(transforms: list[Transform]) -> Transform:
    """Stack scalar transforms into one batched Transform along a new axis 0."""
    return Transform(
        jnp.stack([t.rotation for t in transforms], axis=0),
        jnp.stack([t.translation for t in transforms], axis=0),
    )
