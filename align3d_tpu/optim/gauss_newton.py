"""Gauss-Newton normal-equation utilities.

Counterpart of the reference ``src/optim/gaussnewton.rs``, redesigned for
an accelerator: instead of rank-1 accumulation per residual, whole residual
blocks are reduced at once — ``H = J^T W J`` and ``g = J^T W r`` are two
small contractions, with masking ("skip" gates) folded in as 0/1
weights (mathematically identical since GN sums are linear in the residual
terms).

The 6x6 solve: the reference casts to f64 and Cholesky-solves
(gaussnewton.rs:84-93). To keep the hot loop in f32, :func:`solve_spd` uses
Jacobi preconditioning + one step of iterative refinement in f32, which
recovers f64-grade updates for these systems (validated against numpy f64 in
tests/test_gauss_newton.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from align3d_tpu.config import MATMUL_PRECISION

Array = jax.Array


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class GNSystem:
    """Accumulated normal equations: H (..., D, D), g (..., D) + residual stats."""

    hessian: Array
    gradient: Array
    squared_residual_sum: Array
    count: Array

    def tree_flatten(self):
        return (self.hessian, self.gradient, self.squared_residual_sum, self.count), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def from_residuals(cls, jacobians: Array, residuals: Array, weights: Array) -> "GNSystem":
        """Reduce per-residual blocks: jacobians (..., N, D), residuals (..., N),
        weights (..., N) 0/1 gates (or robust weights).

        The contraction is (D, N) @ (N, D) at full float32 precision.
        """
        jw = jacobians * weights[..., None]
        hessian = jnp.einsum(
            "...nd,...ne->...de",
            jw,
            jacobians,
            preferred_element_type=jnp.float32,
            precision=MATMUL_PRECISION,
        )
        gradient = jnp.einsum(
            "...nd,...n->...d",
            jw,
            residuals,
            preferred_element_type=jnp.float32,
            precision=MATMUL_PRECISION,
        )
        sq = jnp.sum(weights * residuals * residuals, axis=-1)
        count = jnp.sum(weights, axis=-1)
        return cls(hessian, gradient, sq, count)

    def add(self, other: "GNSystem") -> "GNSystem":
        """Merge sub-accumulators (gaussnewton.rs:101-106)."""
        return GNSystem(
            self.hessian + other.hessian,
            self.gradient + other.gradient,
            self.squared_residual_sum + other.squared_residual_sum,
            self.count + other.count,
        )

    def add_weighted(self, other: "GNSystem", w1: Array, w2: Array) -> "GNSystem":
        """Weighted merge (gaussnewton.rs:115-121): hessians scale by w^2,
        gradients by w, residual sums by w, counts add unweighted."""
        return GNSystem(
            self.hessian * (w1 * w1) + other.hessian * (w2 * w2),
            self.gradient * w1 + other.gradient * w2,
            self.squared_residual_sum * w1 + other.squared_residual_sum * w2,
            self.count + other.count,
        )

    def weight(self, w: Array) -> "GNSystem":
        """Scale in place-equivalent (gaussnewton.rs:124-128)."""
        return GNSystem(
            self.hessian * (w * w),
            self.gradient * w,
            self.squared_residual_sum * w,
            self.count,
        )

    def mean_squared_residual(self) -> Array:
        return self.squared_residual_sum / self.count

    def solve(self) -> Array:
        """GN update; zero when no residuals were accumulated.

        The reference returns ``None`` on an empty system
        (gaussnewton.rs:85-87) — our equivalent is a zero update, which
        leaves the transform unchanged.
        """
        update = solve_spd(self.hessian, self.gradient)
        ok = (self.count > 0)[..., None]
        return jnp.where(ok, update, 0.0)


def _cholesky_unrolled(hs: Array, dim: int) -> list:
    """Fully unrolled Cholesky of a small (..., dim, dim) SPD matrix as a
    lower-triangular list-of-lists of (...,) scalars.

    Why not ``jnp.linalg.cholesky``: XLA's generic lowering builds a blocked
    loop with dynamic slices — measured at >100 us per GN iteration between
    Pallas kernel launches and minutes of extra compile time on this
    platform. The unrolled form is pure elementwise math that XLA fuses
    into a single tiny kernel.
    """
    low = [[None] * dim for _ in range(dim)]
    for j in range(dim):
        s = hs[..., j, j]
        for k in range(j):
            s = s - low[j][k] * low[j][k]
        low[j][j] = jnp.sqrt(s)
        inv = 1.0 / low[j][j]
        for i in range(j + 1, dim):
            s2 = hs[..., i, j]
            for k in range(j):
                s2 = s2 - low[i][k] * low[j][k]
            low[i][j] = s2 * inv
    return low


def _cho_solve_unrolled(low: list, b: Array, dim: int) -> Array:
    """Forward + back substitution against :func:`_cholesky_unrolled`."""
    y = []
    for i in range(dim):
        s = b[..., i]
        for k in range(i):
            s = s - low[i][k] * y[k]
        y.append(s / low[i][i])
    x = [None] * dim
    for i in reversed(range(dim)):
        s = y[i]
        for k in range(i + 1, dim):
            s = s - low[k][i] * x[k]
        x[i] = s / low[i][i]
    return jnp.stack(x, axis=-1)


def solve_spd(hessian: Array, gradient: Array) -> Array:
    """Solve ``H x = g`` for small SPD H (..., D, D) in f32.

    Jacobi-preconditioned unrolled Cholesky + one iterative-refinement step:
    the f32 stand-in for the reference's f64 solve. NaN-safe for
    singular H only in the sense that callers mask the result (see
    GNSystem.solve).
    """
    dim = hessian.shape[-1]
    diag = jnp.diagonal(hessian, axis1=-2, axis2=-1)
    scale = jax.lax.rsqrt(jnp.maximum(diag, jnp.finfo(hessian.dtype).tiny))
    hs = hessian * scale[..., :, None] * scale[..., None, :]
    gs = gradient * scale

    low = _cholesky_unrolled(hs, dim)
    y = _cho_solve_unrolled(low, gs, dim)
    # One refinement step in the scaled system.
    r = gs - jnp.einsum("...ij,...j->...i", hs, y, precision=MATMUL_PRECISION)
    dy = _cho_solve_unrolled(low, r, dim)
    return (y + dy) * scale


def huber_weight(residuals: Array, delta: float) -> Array:
    """Huber IRLS weights (reference ``robust_estimator.rs`` — defined but
    never wired into the reference's ICP; exposed here with default-off
    semantics for parity)."""
    abs_r = jnp.abs(residuals)
    return jnp.where(abs_r <= delta, 1.0, delta / jnp.maximum(abs_r, 1e-30))
