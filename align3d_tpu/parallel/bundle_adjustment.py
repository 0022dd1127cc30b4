"""Distributed bundle adjustment with Schur-complement reduction.

SURVEY §7 phase 5 / §2.6: the beyond-reference global-refinement layer —
keyframe poses AND 3D landmarks jointly refined from pixel reprojection
observations, with the landmark block eliminated via the Schur complement
and the observation axis sharded across the device mesh.

Problem: poses ``T_i`` (camera-to-world, SE(3)), landmarks ``X_j`` (world
points), observations ``o = (i, j, uv)``. Gauss-Newton on

    sum_o w_o || project(K, T_i^{-1} X_j) - uv_o ||^2

Every observation touches exactly one pose and one landmark, so the normal
equations have the classic BA structure

    [ Hpp  W  ] [dp]   [gp]        Hpp: (N, 6, 6) block-DIAGONAL
    [ W^T  Hll] [dl] = [gl]        Hll: (M, 3, 3) block-DIAGONAL
                                   W:   (N, 6, M, 3) sparse fill-in

and the landmark block inverts in closed form per 3x3 block. The reduced
(Schur) system over poses only is

    S  = Hpp - W Hll^{-1} W^T          (6N, 6N)
    rhs = gp - W Hll^{-1} gl
    dl  = Hll^{-1} (gl - W^T dp)       (back-substitution)

Structure:

* Per-observation residuals + Jacobians (``jax.jacfwd`` through the exact
  SE(3) right-perturbation — no hand small-angle approximations) are
  embarrassingly parallel over the observation axis: under ``shard_map``
  with observations sharded, each device computes partial ``Hpp`` /
  ``Hll`` / ``W`` / ``gp`` / ``gl`` (all additive) and a single ``psum``
  per quantity reduces them across devices — the same collective shape as
  :mod:`align3d_tpu.parallel.pose_graph`.
* ``Hpp``/``Hll`` accumulate with ``segment_sum`` over the pose/landmark
  id (block-diagonal, no fill-in); ``W`` scatter-adds 6x3 blocks.
* The Schur contraction ``W Hll^{-1} W^T`` is one einsum over the landmark
  axis, computed replicated after the psum (the
  reduced system is tiny: 6N x 6N for keyframe-scale N).
* Gauge: pose 0 fixed (rows/cols zeroed, identity diagonal), Levenberg
  damping on both diagonals.

The reference (otaviog/align3d) has no global refinement at all; this
module and pose_graph.py are the scale-out layer BASELINE.json's north
star asks for.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from align3d_tpu.config import MATMUL_PRECISION
from align3d_tpu.camera import CameraIntrinsics
from align3d_tpu.optim.pcg import pcg
from align3d_tpu.se3 import Transform

Array = jax.Array

OBS_AXIS = "obs"


@dataclasses.dataclass
class BAProblem:
    """Poses (batched Transform, camera-to-world), landmarks (M, 3) world
    points, and observations: ``obs_pose``/``obs_landmark`` (O,) i32 ids,
    ``obs_uv`` (O, 2) pixel measurements, ``weights`` (O,).

    ``obs_z`` (O,) adds per-observation measured camera-frame depth — the
    RGB-D case. Without it (monocular, reprojection-only) the problem has a
    global-SCALE gauge freedom on top of the pose-0 gauge whenever pose 0
    sits at the origin; depth observations pin it. ``depth_weight`` converts
    the metric depth residual into pixel-comparable units.
    """

    poses: Transform
    landmarks: Array
    obs_pose: Array
    obs_landmark: Array
    obs_uv: Array
    weights: Array
    intrinsics: CameraIntrinsics
    obs_z: Array | None = None
    depth_weight: float = 100.0

    @property
    def n_poses(self) -> int:
        return len(self.poses)

    @property
    def n_landmarks(self) -> int:
        return int(self.landmarks.shape[0])


def _obs_residual(
    twist: Array,  # (6,) pose right-perturbation, evaluated at 0
    dx: Array,  # (3,) landmark perturbation, evaluated at 0
    t_cw: Transform,  # camera-to-world pose of the observing frame
    x: Array,  # (3,) landmark
    uvz: Array,  # (3,) measured (u, v, z); z ignored unless with_depth
    intrinsics: CameraIntrinsics,
    with_depth: bool = False,
    depth_weight: float = 100.0,
) -> Array:
    t = t_cw @ Transform.exp(twist)
    p_cam = t.inverse().apply(x + dx)
    z = p_cam[2]
    safe_z = jnp.where(z == 0.0, 1e-12, z)
    u = p_cam[0] * intrinsics.fx / safe_z + intrinsics.cx
    v = p_cam[1] * intrinsics.fy / safe_z + intrinsics.cy
    if with_depth:
        return jnp.stack(
            [u - uvz[0], v - uvz[1], depth_weight * (z - uvz[2])]
        )
    return jnp.stack([u - uvz[0], v - uvz[1]])


def _partials(
    poses: Transform,
    landmarks: Array,
    obs_pose: Array,
    obs_landmark: Array,
    obs_uvz: Array,  # (O, 3); z column ignored unless with_depth
    weights: Array,
    intrinsics: CameraIntrinsics,
    n: int,
    m: int,
    with_depth: bool = False,
    depth_weight: float = 100.0,
):
    """Additive normal-equation pieces from a (shard of) observations.

    Returns (hpp (N,6,6), hll (M,3,3), w_obs (O,6,3) PER-OBSERVATION fill-in
    blocks, gp (N,6), gl (M,3), sq (scalar sum of weighted squared
    residuals), cnt (scalar)). The fill-in stays in per-observation COO form
    — the r2 dense (N, M, 6, 3) scatter was 720 MB at N=100 x M=100k and
    capped problem sizes; consumers either densify (small problems) or run
    Schur products on the COO blocks directly.
    """
    t_cw = Transform(
        jnp.take(poses.rotation, obs_pose, axis=0),
        jnp.take(poses.translation, obs_pose, axis=0),
    )
    x = jnp.take(landmarks, obs_landmark, axis=0)
    zero6 = jnp.zeros((obs_pose.shape[0], 6), jnp.float32)
    zero3 = jnp.zeros((obs_pose.shape[0], 3), jnp.float32)

    rfn = partial(
        _obs_residual,
        intrinsics=intrinsics,
        with_depth=with_depth,
        depth_weight=depth_weight,
    )
    res = jax.vmap(rfn)(zero6, zero3, t_cw, x, obs_uvz)  # (O, D)
    jp = jax.vmap(
        lambda t, xx, uv: jax.jacfwd(rfn, argnums=0)(
            jnp.zeros(6), jnp.zeros(3), t, xx, uv
        )
    )(t_cw, x, obs_uvz)  # (O, D, 6)
    jl = jax.vmap(
        lambda t, xx, uv: jax.jacfwd(rfn, argnums=1)(
            jnp.zeros(6), jnp.zeros(3), t, xx, uv
        )
    )(t_cw, x, obs_uvz)  # (O, D, 3)

    w = weights[:, None, None]
    jpw = jp * w  # weights fold once (reference add_weighted: w^2 on H via
    # both factors below, w on g — here w is a per-obs information weight,
    # applied once to H and once to g: H = J^T w J, g = J^T w r).
    hpp = jax.ops.segment_sum(
        jnp.einsum("odu,odw->ouw", jpw, jp, precision=MATMUL_PRECISION), obs_pose, num_segments=n
    )  # (N, 6, 6)
    hll = jax.ops.segment_sum(
        jnp.einsum("odu,odw->ouw", jl * w, jl, precision=MATMUL_PRECISION), obs_landmark, num_segments=m
    )  # (M, 3, 3)
    w_obs = jnp.einsum("odu,odw->ouw", jpw, jl, precision=MATMUL_PRECISION)  # (O, 6, 3)
    gp = jax.ops.segment_sum(
        jnp.einsum("odu,od->ou", jpw, res, precision=MATMUL_PRECISION), obs_pose, num_segments=n
    )
    gl = jax.ops.segment_sum(
        jnp.einsum("odu,od->ou", jl * w, res, precision=MATMUL_PRECISION), obs_landmark, num_segments=m
    )
    sq = jnp.sum(weights * jnp.sum(res * res, axis=-1))
    cnt = jnp.sum(weights > 0.0)
    return hpp, hll, w_obs, gp, gl, sq, cnt


def _densify_w(w_obs, obs_pose, obs_landmark, n, m):
    """COO fill-in -> dense (N, M, 6, 3) for the small-problem direct path."""
    return jnp.zeros((n, m, 6, 3), jnp.float32).at[obs_pose, obs_landmark].add(
        w_obs
    )


def _schur_solve_coo(
    hpp: Array,  # (N, 6, 6)
    hll: Array,  # (M, 3, 3)
    w_obs: Array,  # (O, 6, 3) per-observation fill-in blocks
    obs_pose: Array,  # (O,)
    obs_landmark: Array,  # (O,)
    gp: Array,  # (N, 6)
    gl: Array,  # (M, 3)
    damping: float,
    cg_iters: int,
    psum_axis: str | None = None,
) -> tuple[Array, Array]:
    """Schur-reduced solve with the fill-in kept in COO form.

    Every product with W / W^T is two segment ops over the observation axis
    — O(O) work and memory, never the dense (N, M) structure. The reduced
    pose system is solved with block-Jacobi PCG (matvec: S v = (Hpp + λ) v
    - W Hll^{-1} W^T v). With ``psum_axis`` (inside shard_map, observations
    sharded), the per-landmark and per-pose partial sums are psummed so
    every device sees the global matvec.
    """
    n, m = hpp.shape[0], hll.shape[0]
    eye3 = jnp.eye(3, dtype=jnp.float32)
    hll_inv = jnp.linalg.inv(hll + damping * eye3)

    # Gauge fix pose 0 before elimination (same as the dense path).
    zero_mask = (obs_pose == 0)[:, None, None]
    w_obs = jnp.where(zero_mask, 0.0, w_obs)
    gp = gp.at[0].set(0.0)
    hpp = hpp.at[0].set(jnp.eye(6))

    def psum(x):
        return jax.lax.psum(x, psum_axis) if psum_axis is not None else x

    def wt_v(v):  # W^T v: (N, 6) -> (M, 3), global
        tv = jax.ops.segment_sum(
            jnp.einsum("ouw,ou->ow", w_obs, jnp.take(v, obs_pose, axis=0), precision=MATMUL_PRECISION),
            obs_landmark,
            num_segments=m,
        )
        return psum(tv)

    def w_z(z):  # W z: (M, 3) -> (N, 6), global
        wv = jax.ops.segment_sum(
            jnp.einsum("ouw,ow->ou", w_obs, jnp.take(z, obs_landmark, axis=0), precision=MATMUL_PRECISION),
            obs_pose,
            num_segments=n,
        )
        return psum(wv)

    y_l = jnp.einsum("Lwx,Lx->Lw", hll_inv, gl, precision=MATMUL_PRECISION)  # Hll^{-1} gl
    rhs = gp - w_z(y_l)

    hpp_damped = hpp + damping * jnp.eye(6, dtype=jnp.float32)[None]
    minv = jnp.linalg.inv(hpp_damped)

    def matvec(v):
        z = jnp.einsum("Lwx,Lx->Lw", hll_inv, wt_v(v), precision=MATMUL_PRECISION)
        return jnp.einsum("nuw,nw->nu", hpp_damped, v, precision=MATMUL_PRECISION) - w_z(z)

    def precond(r):
        return jnp.einsum("nuw,nw->nu", minv, r, precision=MATMUL_PRECISION)

    dp = -pcg(matvec, precond, rhs, cg_iters)
    wt_dp = wt_v(dp)
    dl = -jnp.einsum("Lwx,Lx->Lw", hll_inv, gl + wt_dp, precision=MATMUL_PRECISION)
    return dp, dl


def _schur_solve(
    hpp: Array,  # (N, 6, 6)
    hll: Array,  # (M, 3, 3)
    w_blk: Array,  # (N, M, 6, 3)
    gp: Array,  # (N, 6)
    gl: Array,  # (M, 3)
    damping: float,
) -> tuple[Array, Array]:
    """Reduced-system solve: returns (dp (N, 6), dl (M, 3)) minimizing the
    damped GN quadratic (update = -H^{-1} g, gauge pose 0 fixed)."""
    n, m = hpp.shape[0], hll.shape[0]
    eye3 = jnp.eye(3, dtype=jnp.float32)
    hll_inv = jnp.linalg.inv(hll + damping * eye3)  # (M, 3, 3)

    # Gauge fix pose 0 BEFORE the elimination: its coupling to landmarks
    # must not flow through the Schur reduction, or the (near-singular)
    # global-gauge direction survives into the reduced system.
    w_blk = w_blk.at[0].set(0.0)
    gp = gp.at[0].set(0.0)
    hpp = hpp.at[0].set(jnp.eye(6))

    # Y[n, u, L, x] = sum_w W[n, u, L, w] Hll^{-1}[L, w, x]
    y = jnp.einsum("nLuw,Lwx->nLux", w_blk, hll_inv, precision=MATMUL_PRECISION)
    # S = Hpp (block diag) - Y W^T  (dense 6N x 6N)
    s = -jnp.einsum("nLux,mLvx->numv", y, w_blk, precision=MATMUL_PRECISION)
    s = s.at[jnp.arange(n), :, jnp.arange(n), :].add(hpp)
    rhs = gp - jnp.einsum("nLux,Lx->nu", y, gl, precision=MATMUL_PRECISION)

    s = s.reshape(n * 6, n * 6)
    rhs = rhs.reshape(n * 6)
    s = s + damping * jnp.eye(n * 6, dtype=jnp.float32)

    dp = -jnp.linalg.solve(s, rhs).reshape(n, 6)
    # Back-substitute landmarks: dl = -Hll^{-1} (gl + W^T dp)  [signs: the
    # full-system update is -H^{-1} g].
    wt_dp = jnp.einsum("nLuw,nu->Lw", w_blk, dp, precision=MATMUL_PRECISION)
    dl = -jnp.einsum("Lwx,Lx->Lw", hll_inv, gl, precision=MATMUL_PRECISION) - jnp.einsum(
        "Lwx,Lx->Lw", hll_inv, wt_dp, precision=MATMUL_PRECISION)
    return dp, dl


def optimize(
    problem: BAProblem,
    iterations: int = 10,
    damping: float = 1e-4,
    mesh: Mesh | None = None,
    solver: str = "auto",
    cg_iters: int = 64,
) -> tuple[Transform, Array]:
    """Gauss-Newton BA; returns (refined poses, refined landmarks).

    With ``mesh``, observations shard over the first mesh axis; per-shard
    partials reduce with one ``psum`` each, and the tiny Schur system is
    solved replicated — SURVEY §2.6's distributed plan.

    ``solver``: "dense" materializes the (N, M, 6, 3) fill-in and the exact
    dense Schur complement (small problems); "coo" keeps per-observation
    blocks and solves the reduced pose system with PCG — O(O) memory, the
    path for pod-scale N x M; "auto" switches on problem size.
    """
    n, m = problem.n_poses, problem.n_landmarks
    if solver == "auto":
        solver = "dense" if n * m <= 1_000_000 else "coo"
    obs_pose = problem.obs_pose
    obs_landmark = problem.obs_landmark
    with_depth = problem.obs_z is not None
    if with_depth:
        obs_uvz = jnp.concatenate(
            [problem.obs_uv, problem.obs_z[:, None]], axis=1
        )
    else:
        obs_uvz = jnp.concatenate(
            [problem.obs_uv, jnp.zeros_like(problem.obs_uv[:, :1])], axis=1
        )
    weights = problem.weights
    intr = problem.intrinsics

    if mesh is not None:
        n_dev = mesh.devices.size
        o = obs_pose.shape[0]
        pad = (-o) % n_dev
        if pad:
            obs_pose = jnp.concatenate([obs_pose, jnp.zeros(pad, jnp.int32)])
            obs_landmark = jnp.concatenate(
                [obs_landmark, jnp.zeros(pad, jnp.int32)]
            )
            obs_uvz = jnp.concatenate(
                [obs_uvz, jnp.ones((pad, 3), jnp.float32)]
            )
            weights = jnp.concatenate([weights, jnp.zeros(pad, jnp.float32)])

    def build(poses, landmarks, op, ol, uv, w):
        return _partials(
            poses, landmarks, op, ol, uv, w, intr, n, m,
            with_depth=with_depth, depth_weight=problem.depth_weight,
        )

    def step(poses: Transform, landmarks: Array):
        if mesh is None:
            hpp, hll, w_obs, gp, gl, _, _ = build(
                poses, landmarks, obs_pose, obs_landmark, obs_uvz, weights
            )
            if solver == "dense":
                w_blk = _densify_w(w_obs, obs_pose, obs_landmark, n, m)
                dp, dl = _schur_solve(hpp, hll, w_blk, gp, gl, damping)
            else:
                dp, dl = _schur_solve_coo(
                    hpp, hll, w_obs, obs_pose, obs_landmark, gp, gl,
                    damping, cg_iters,
                )
            return poses @ Transform.exp(dp), landmarks + dl

        axis = mesh.axis_names[0]

        if solver == "dense":

            @partial(
                jax.shard_map,
                mesh=mesh,
                in_specs=(P(), P(), P(axis), P(axis), P(axis), P(axis)),
                out_specs=P(),
                check_vma=False,
            )
            def sharded(poses_r, lm_r, op_s, ol_s, uv_s, w_s):
                hpp, hll, w_obs, gp, gl, _, _ = build(
                    poses_r, lm_r, op_s, ol_s, uv_s, w_s
                )
                w_blk = _densify_w(w_obs, op_s, ol_s, n, m)
                return tuple(
                    jax.lax.psum(p, axis) for p in (hpp, hll, w_blk, gp, gl)
                )

            hpp, hll, w_blk, gp, gl = sharded(
                poses, landmarks, obs_pose, obs_landmark, obs_uvz, weights
            )
            dp, dl = _schur_solve(hpp, hll, w_blk, gp, gl, damping)
        else:

            @partial(
                jax.shard_map,
                mesh=mesh,
                in_specs=(P(), P(), P(), P(axis), P(axis), P(axis), P(axis)),
                out_specs=(P(), P()),
                check_vma=False,
            )
            def sharded_coo(rot, tr, lm_r, op_s, ol_s, uv_s, w_s):
                poses_r = Transform(rot, tr)
                hpp_s, hll_s, w_obs_s, gp_s, gl_s, _, _ = build(
                    poses_r, lm_r, op_s, ol_s, uv_s, w_s
                )
                hpp = jax.lax.psum(hpp_s, axis)
                hll = jax.lax.psum(hll_s, axis)
                gp = jax.lax.psum(gp_s, axis)
                gl = jax.lax.psum(gl_s, axis)
                return _schur_solve_coo(
                    hpp, hll, w_obs_s, op_s, ol_s, gp, gl,
                    damping, cg_iters, psum_axis=axis,
                )

            dp, dl = sharded_coo(
                poses.rotation, poses.translation, landmarks,
                obs_pose, obs_landmark, obs_uvz, weights,
            )
        return poses @ Transform.exp(dp), landmarks + dl

    step = jax.jit(step)
    poses, landmarks = problem.poses, problem.landmarks
    for _ in range(iterations):
        poses, landmarks = step(poses, landmarks)
    return poses, landmarks


def mean_reprojection_error(problem: BAProblem) -> Array:
    """Weighted RMS pixel reprojection error of the current estimate
    (uv residual only — depth residuals are excluded so the number stays in
    pixel units regardless of ``depth_weight``)."""
    obs_uvz = jnp.concatenate(
        [problem.obs_uv, jnp.zeros_like(problem.obs_uv[:, :1])], axis=1
    )
    *_, sq, cnt = _partials(
        problem.poses,
        problem.landmarks,
        problem.obs_pose,
        problem.obs_landmark,
        obs_uvz,
        problem.weights,
        problem.intrinsics,
        problem.n_poses,
        problem.n_landmarks,
        with_depth=False,
    )
    return jnp.sqrt(sq / jnp.maximum(cnt, 1))
