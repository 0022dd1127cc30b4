"""Fused ICP kernel (Triton route, interpret mode here) vs the ``xla`` engine.

Both engines read the same packed target tables through the same exact
association, so the systems agree up to float32 summation order and the
aligned poses agree to rounding.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from align3d_tpu.camera import CameraIntrinsics
from align3d_tpu.icp.image_icp import (
    align_impl,
    align_impl_fused,
    align_impl_fused_batched,
    engine_impl,
    icp_step,
)
from align3d_tpu.icp.params import IcpParams
from align3d_tpu.ops import icp_fused
from align3d_tpu.ops.target_pack import pack_geometry, pack_intensity_taps
from align3d_tpu.range_image import build_pyramid_impl
from align3d_tpu.se3 import Transform


def _pair(h, w, seed=0):
    rng = np.random.default_rng(seed)
    intr = CameraIntrinsics(
        fx=0.9 * w, fy=0.9 * w, cx=w / 2 - 0.5, cy=h / 2 - 0.5, width=w, height=h
    )
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    tex = rng.uniform(30, 220, size=(h, w + 8, 3)).astype(np.uint8)
    d0 = (2000 + 3 * xs + 2 * ys + rng.integers(0, 5, (h, w))).astype(np.uint16)
    d1 = (2000 + 3 * (xs + 1) + 2 * ys + rng.integers(0, 5, (h, w))).astype(
        np.uint16
    )
    d0[5:9, 10:20] = 0  # invalid patch exercises the valid gate
    target = build_pyramid_impl(
        True, True, 1, 1.0, intr, 0.001, jnp.asarray(tex[:, :w]), jnp.asarray(d0)
    )[0]
    source = build_pyramid_impl(
        True, True, 1, 1.0, intr, 0.001, jnp.asarray(tex[:, 1 : w + 1]), jnp.asarray(d1)
    )[0]
    return intr, target, source


def _flat(target, source):
    n = target.height * target.width
    return (
        source.points.reshape(n, 3),
        source.mask.reshape(n),
        source.intensities.reshape(n),
        target.points.reshape(n, 3),
        target.mask.reshape(n),
        target.normals.reshape(n, 3),
        target.intensity_map,
    )


def _kernel_systems(rot, tr, intr, target, source, params, block=icp_fused.BLOCK):
    n = target.height * target.width
    sp = icp_fused.pack_source(
        source.points.reshape(1, n, 3),
        source.mask.reshape(1, n),
        source.intensities.reshape(1, n),
        block,
    )
    geo = pack_geometry(target.points, target.normals, target.mask)[None]
    taps = pack_intensity_taps(target.intensity_map)[None]
    pt = (
        params.max_distance,
        params.max_normal_angle,
        params.max_color_distance,
        0.0 if params.huber_delta is None else params.huber_delta,
    )
    part = icp_fused.step_partials(
        rot[None], tr[None], sp, geo, taps, intr, target.height, target.width,
        pt, interpret=True, block=block,
    )
    geom, color = icp_fused.systems_from_partials(part)
    return jax.tree.map(lambda a: a[0], (geom, color))


def _xla_systems(rot, tr, intr, target, source, params):
    n = target.height * target.width
    return icp_step(
        Transform(rot, tr),
        source.points.reshape(n, 3),
        source.mask.reshape(n),
        source.intensities.reshape(n),
        pack_geometry(target.points, target.normals, target.mask),
        pack_intensity_taps(target.intensity_map),
        target.height,
        target.width,
        intr,
        params,
    )


def _assert_systems_close(got, ref):
    for g, r in zip(got, ref):
        # Exact for 0/1 gates; Huber weights sum in another order.
        np.testing.assert_allclose(float(g.count), float(r.count), rtol=1e-6)
        hs = np.asarray(r.hessian)
        np.testing.assert_allclose(
            np.asarray(g.hessian), hs, rtol=1e-4, atol=1e-5 * np.abs(hs).max()
        )
        gs = np.asarray(r.gradient)
        np.testing.assert_allclose(
            np.asarray(g.gradient), gs, rtol=1e-4, atol=1e-5 * np.abs(gs).max()
        )
        np.testing.assert_allclose(
            float(g.squared_residual_sum), float(r.squared_residual_sum), rtol=1e-4
        )


def test_pack_target_roundtrip():
    """The source pack is channel-major, padded to whole blocks, and its
    padded tail carries zero validity."""
    h, w = 48, 100
    _, _, source = _pair(h, w)
    n = h * w
    sp = np.asarray(icp_fused.pack_source(
        source.points.reshape(1, n, 3),
        source.mask.reshape(1, n),
        source.intensities.reshape(1, n),
    ))
    nb = icp_fused.num_blocks(n)
    assert sp.shape == (1, icp_fused.SRC_CHANNELS, nb * icp_fused.BLOCK)
    np.testing.assert_array_equal(sp[0, 0:3, :n].T, np.asarray(source.points.reshape(n, 3)))
    np.testing.assert_array_equal(sp[0, 3, :n], np.asarray(source.mask.reshape(n)))
    np.testing.assert_array_equal(
        sp[0, 4, :n], np.asarray(source.intensities.reshape(n), np.float32)
    )
    assert not sp[0, 3, n:].any()


def test_step_matches_xla_counts_and_systems():
    h, w = 48, 100
    intr, target, source = _pair(h, w)
    params = IcpParams()
    rot, tr = jnp.eye(3), jnp.zeros(3)
    _assert_systems_close(
        _kernel_systems(rot, tr, intr, target, source, params),
        _xla_systems(rot, tr, intr, target, source, params),
    )


def test_align_matches_xla_pose():
    h, w = 32, 64
    intr, target, source = _pair(h, w)
    args = (jnp.eye(3), jnp.zeros(3), *_flat(target, source), intr)
    r_x, t_x, res_x = align_impl(*args, IcpParams(max_iterations=3))
    r_p, t_p, res_p = align_impl_fused(
        *args, IcpParams(max_iterations=3, engine="fused", interpret=True)
    )
    # Summation order differs (per-block partials): float32 rounding only.
    np.testing.assert_allclose(np.asarray(r_p), np.asarray(r_x), atol=1e-4)
    np.testing.assert_allclose(np.asarray(t_p), np.asarray(t_x), atol=1e-4)
    np.testing.assert_allclose(float(res_p), float(res_x), rtol=1e-4)


def test_batched_matches_single():
    h, w = 32, 64
    intr, target, source = _pair(h, w)
    params = IcpParams(max_iterations=2, engine="fused", interpret=True)
    flat = _flat(target, source)
    r1, t1, _ = align_impl_fused(jnp.eye(3), jnp.zeros(3), *flat, intr, params)
    rb, tb, _ = align_impl_fused_batched(
        jnp.broadcast_to(jnp.eye(3)[None], (3, 3, 3)),
        jnp.zeros((3, 3)),
        *(jnp.broadcast_to(a[None], (3,) + a.shape) for a in flat),
        intr,
        params,
    )
    # Same kernel per pair; only XLA's vectorisation of the solve differs.
    for b in range(3):
        np.testing.assert_allclose(np.asarray(rb[b]), np.asarray(r1), atol=1e-6)
        np.testing.assert_allclose(np.asarray(tb[b]), np.asarray(t1), atol=1e-6)


def test_huber_step_matches_xla_systems():
    """Non-binary Huber IRLS weights flow through the kernel as through the
    ``xla`` engine (reference robust_estimator.rs:10-28)."""
    h, w = 48, 100
    intr, target, source = _pair(h, w)
    params = IcpParams(huber_delta=0.004)
    rot, tr = jnp.eye(3), jnp.zeros(3)
    got = _kernel_systems(rot, tr, intr, target, source, params)
    plain = _kernel_systems(rot, tr, intr, target, source, IcpParams())
    assert float(got[0].count) < float(plain[0].count) - 1.0  # weights bite
    _assert_systems_close(got, _xla_systems(rot, tr, intr, target, source, params))


def test_huber_align_matches_xla_pose():
    h, w = 32, 64
    intr, target, source = _pair(h, w)
    args = (jnp.eye(3), jnp.zeros(3), *_flat(target, source), intr)
    ref_rot, ref_tr, _ = align_impl(*args, IcpParams(max_iterations=3, huber_delta=0.01))
    got_rot, got_tr, _ = align_impl_fused(
        *args,
        IcpParams(max_iterations=3, huber_delta=0.01, engine="fused", interpret=True),
    )
    d = Transform(got_rot, got_tr) @ Transform(ref_rot, ref_tr).inverse()
    assert float(d.angle()) < 1e-4
    assert float(jnp.linalg.norm(d.translation)) < 1e-4


# Every pyramid level of a 640x480 frame (and odd sizes) leaves a tail that
# is not a whole block; the kernel masks it and the pack pads it.
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize(
    "h,w,block",
    [(480, 640, 512), (240, 320, 512), (120, 160, 512), (30, 37, 256), (17, 23, 64)],
)
def test_tail_blocks_and_padding(h, w, block, batch):
    n = h * w
    nb = icp_fused.num_blocks(n, block)
    assert (nb - 1) * block < n <= nb * block
    rng = np.random.default_rng(h * w + batch)
    sp = icp_fused.pack_source(
        jnp.asarray(rng.normal(size=(batch, n, 3)), jnp.float32),
        jnp.asarray(rng.random((batch, n)) > 0.3),
        jnp.asarray(rng.integers(0, 255, (batch, n)), jnp.uint8),
        block,
    )
    assert sp.shape == (batch, icp_fused.SRC_CHANNELS, nb * block)
    assert not np.asarray(sp[:, 3, n:]).any()
    if n <= 4096:  # the kernel itself, interpreted, on the small shapes
        intr, target, source = _pair(h, w)
        params = IcpParams()
        rot = jnp.asarray(Transform.exp(jnp.asarray([0.002, 0.0, 0.001, 0.0, 0.003, 0.0])).rotation)
        tr = jnp.asarray([0.002, 0.0, 0.001])
        _assert_systems_close(
            _kernel_systems(rot, tr, intr, target, source, params, block=block),
            _xla_systems(rot, tr, intr, target, source, params),
        )


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="unknown ICP engine"):
        engine_impl("pallas_v4")


def test_kernel_refuses_non_gpu_without_interpret():
    h, w = 16, 16
    intr, target, source = _pair(h, w)
    args = (jnp.eye(3), jnp.zeros(3), *_flat(target, source), intr)
    with pytest.raises(RuntimeError, match="interpret=True"):
        align_impl_fused(*args, IcpParams(max_iterations=1, engine="fused"))


@pytest.mark.gpu
@pytest.mark.parametrize("h,w", [(48, 100), (480, 640)])
def test_compiled_kernel_matches_xla(gpu_device, h, w):
    """The kernel as compiled for the card (no interpreter) against the
    ``xla`` engine at full float32 precision."""
    with jax.default_device(gpu_device):
        intr, target, source = _pair(h, w)
        params = IcpParams()
        n = h * w
        sp = icp_fused.pack_source(
            source.points.reshape(1, n, 3),
            source.mask.reshape(1, n),
            source.intensities.reshape(1, n),
        )
        pt = (params.max_distance, params.max_normal_angle, params.max_color_distance, 0.0)
        part = icp_fused.step_partials(
            jnp.eye(3)[None], jnp.zeros((1, 3)), sp,
            pack_geometry(target.points, target.normals, target.mask)[None],
            pack_intensity_taps(target.intensity_map)[None],
            intr, h, w, pt,
        )
        got = jax.tree.map(lambda a: a[0], icp_fused.systems_from_partials(part))
        ref = _xla_systems(jnp.eye(3), jnp.zeros(3), intr, target, source, params)
        # A gate may flip on a last-bit difference (arccos, FMA) and move
        # one pixel's term; the count bounds the flips.
        for g, r in zip(got, ref):
            assert abs(float(g.count) - float(r.count)) <= 1e-4 * float(r.count)
            hs = np.asarray(r.hessian)
            np.testing.assert_allclose(
                np.asarray(g.hessian), hs, rtol=0, atol=2e-3 * np.abs(hs).max()
            )
