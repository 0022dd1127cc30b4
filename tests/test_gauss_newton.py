"""Gauss-Newton accumulation/solve tests.

Golden 6x6 accumulation from reference ``src/optim/gaussnewton.rs:140-167``;
solver validated against numpy f64 Cholesky (the reference's precision).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from align3d_tpu.optim.gauss_newton import GNSystem, solve_spd


def test_accumulation_golden():
    jac = jnp.tile(jnp.asarray([[1.0, 2.0, 3.0, 4.0, 5.0, 6.0]]), (3, 1))
    res = jnp.asarray([1.0, 2.0, 3.0])
    w = jnp.ones(3)
    gn = GNSystem.from_residuals(jac, res, w)

    base = np.asarray([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    np.testing.assert_allclose(gn.hessian, 3.0 * np.outer(base, base), rtol=1e-6)
    np.testing.assert_allclose(gn.gradient, 6.0 * base, rtol=1e-6)
    np.testing.assert_allclose(gn.squared_residual_sum, 14.0, rtol=1e-6)
    assert float(gn.count) == 3.0


def test_masked_matches_filtered():
    rng = np.random.default_rng(0)
    jac = jnp.asarray(rng.normal(size=(100, 6)), jnp.float32)
    res = jnp.asarray(rng.normal(size=100), jnp.float32)
    keep = jnp.asarray(rng.random(100) > 0.5)

    masked = GNSystem.from_residuals(jac, res, keep.astype(jnp.float32))
    filtered = GNSystem.from_residuals(
        jac[keep], res[keep], jnp.ones(int(keep.sum()))
    )
    np.testing.assert_allclose(masked.hessian, filtered.hessian, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(masked.gradient, filtered.gradient, rtol=1e-4, atol=1e-4)
    assert float(masked.count) == float(filtered.count)


def test_add_weighted_semantics():
    rng = np.random.default_rng(1)
    jac = jnp.asarray(rng.normal(size=(50, 6)), jnp.float32)
    res = jnp.asarray(rng.normal(size=50), jnp.float32)
    a = GNSystem.from_residuals(jac, res, jnp.ones(50))
    b = GNSystem.from_residuals(jac * 2, res * 3, jnp.ones(50))
    merged = a.add_weighted(b, 1.0, 0.5)
    np.testing.assert_allclose(
        merged.hessian, np.asarray(a.hessian) + 0.25 * np.asarray(b.hessian), rtol=1e-5
    )
    np.testing.assert_allclose(
        merged.gradient, np.asarray(a.gradient) + 0.5 * np.asarray(b.gradient), rtol=1e-5
    )
    assert float(merged.count) == 100.0


def test_solve_matches_f64_on_illconditioned():
    """Jacobi + refinement in f32 must track the reference's f64 solve on
    realistic ICP Hessians (condition numbers ~1e6 from fx~500 pixels)."""
    rng = np.random.default_rng(2)
    # Build an ICP-like Hessian: J columns with very different scales.
    scales = np.asarray([1.0, 1.0, 1.0, 500.0, 500.0, 700.0])
    jac = rng.normal(size=(5000, 6)) * scales
    h64 = jac.T @ jac
    g64 = jac.T @ rng.normal(size=5000)
    x64 = np.linalg.solve(h64, g64)

    x32 = solve_spd(jnp.asarray(h64, jnp.float32), jnp.asarray(g64, jnp.float32))
    rel_err = np.linalg.norm(np.asarray(x32) - x64) / np.linalg.norm(x64)
    assert rel_err < 1e-4, rel_err


def test_empty_system_solves_to_zero():
    gn = GNSystem.from_residuals(jnp.zeros((10, 6)), jnp.zeros(10), jnp.zeros(10))
    np.testing.assert_array_equal(np.asarray(gn.solve()), np.zeros(6))


@pytest.mark.parametrize("batch", [(), (3,)])
@pytest.mark.parametrize("n", [1000, 76_800])
def test_systems_match_float64(n, batch):
    """H, g and the residual stats at full float32 precision (the package's
    MATMUL_PRECISION) against float64 numpy, on Jacobians with the spread of
    real point-to-plane rows (unit normals and p x n up to a few metres)."""
    rng = np.random.default_rng(n + len(batch))
    jac = rng.normal(size=batch + (n, 6)) * np.asarray([1, 1, 1, 3, 3, 3])
    res = rng.normal(scale=0.01, size=batch + (n,))
    w = (rng.random(batch + (n,)) > 0.3).astype(np.float64)
    got = jax.jit(GNSystem.from_residuals)(
        jnp.asarray(jac, jnp.float32), jnp.asarray(res, jnp.float32), jnp.asarray(w, jnp.float32)
    )
    j32 = jac.astype(np.float32).astype(np.float64)
    r32 = res.astype(np.float32).astype(np.float64)
    jw = j32 * w[..., None]
    h64 = np.einsum("...nd,...ne->...de", jw, j32)
    g64 = np.einsum("...nd,...n->...d", jw, r32)
    scale_h = np.abs(h64).max()
    np.testing.assert_allclose(np.asarray(got.hessian), h64, atol=1e-5 * scale_h)
    np.testing.assert_allclose(
        np.asarray(got.gradient), g64, atol=1e-5 * np.abs(g64).max()
    )
    np.testing.assert_allclose(
        np.asarray(got.squared_residual_sum),
        np.sum(w * r32 * r32, axis=-1),
        rtol=1e-5,
    )
    np.testing.assert_array_equal(np.asarray(got.count), w.sum(axis=-1))
