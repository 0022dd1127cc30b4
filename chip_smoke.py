"""Smoke test of align3d on NVIDIA GPUs, through the entry points users call.

    python chip_smoke.py          phases (a)-(d) on one card
    python chip_smoke.py --multi  phase (e) only: the sharded paths over every
                                  card of the host, each against one card

Phases:

(a) live odometry: ``align3d_tpu.cli odometry slamtb`` on both fixtures
    (640x480 RGB-D, bilateral filter on, 3-level pyramid, 20/20/30 GN
    iterations), checked against the fixtures' ground truth, and the first
    relative poses against the same pipeline on the CPU in this process;
(b) offline batch: ``parallel.batch.odometry_step`` on 64 real pairs with
    the bilateral filter through ``filter_static_buckets``, pose for pose
    against the sequential per-pair align on the card;
(c) bilateral filter: filtered depth on the card against the CPU;
(d) fused ICP kernel: its GN systems at every pyramid level and its aligned
    poses at batch 1 and 64 against the ``xla`` engine, and the tests marked
    ``gpu``;
(e) (``--multi``) DP odometry, sequence-parallel odometry, the sharded pose
    graph and the sharded bundle adjustment over a 1-D mesh of all cards,
    each against its single-card result.

Every comparison prints what it compared, its tolerance and precision, and
the worst value seen. The script exits non-zero, without the result line,
if the first device is not a GPU or any phase fails. Its last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(HERE, "tests", "data", "rgbd")
T0 = time.perf_counter()

# Accuracy bars of tests/test_odometry_accuracy.py (mean trajectory error
# over the first 10 frames).
ATE_FRAMES = 10
ATE_ANGLE_DEG = 0.5
ATE_TRANSLATION = 0.01


def say(*args):
    print(f"[{time.perf_counter() - T0:7.1f}s]", *args, flush=True)


def result_line(devices) -> str:
    dev = devices[0]
    return json.dumps(
        {
            "ok": True,
            "device": {
                "platform": dev.platform,
                "kind": dev.device_kind,
                "count": len(devices),
            },
        }
    )


class Check:
    """Collects comparisons of one phase; any failure fails the phase."""

    def __init__(self, phase: str):
        self.phase = phase
        self.failures: list[str] = []

    def bound(self, what: str, value: float, limit: float, how: str):
        ok = bool(value <= limit) and math.isfinite(value)
        say(
            f"  ({self.phase}) {what}: {value:.3e} <= {limit:.1e} "
            f"[{how}] {'ok' if ok else 'FAIL'}"
        )
        if not ok:
            self.failures.append(what)

    def done(self):
        if self.failures:
            raise AssertionError(f"phase {self.phase} failed: {self.failures}")


def _pose_gaps(a, b):
    """Max rotation angle (rad) and translation (m) between two batched
    Transforms."""
    import numpy as np

    from align3d_tpu.se3 import Transform

    def host(t):  # both sides on one device, whatever their sharding
        return Transform(np.asarray(t.rotation), np.asarray(t.translation))

    d = host(a).inverse() @ host(b)
    return (
        float(np.max(np.asarray(d.angle()))),
        float(np.max(np.linalg.norm(np.asarray(d.translation), axis=-1))),
    )


def _relative_bound(chk, label, start, ref, got):
    """Sharded ``got`` against single-card ``ref``, each within 1% of the
    correction the solver applied to ``start`` (floor 1e-4): truncated CG
    amplifies the psum's other summation order, so the bound scales with
    the work the solver did."""
    moved_angle, moved_trans = _pose_gaps(start, ref)
    angle, trans = _pose_gaps(got, ref)
    for what, value, moved in (
        ("angle (rad)", angle, moved_angle),
        ("translation (m)", trans, moved_trans),
    ):
        chk.bound(
            f"{label} vs one card, {what}",
            value,
            max(0.01 * moved, 1e-4),
            f"1% of the largest correction ({moved:.3e}); float32, HIGHEST",
        )


def _relative(traj_rot, traj_trans):
    """Relative poses P_{i-1}^-1 P_i of a trajectory."""
    from align3d_tpu.se3 import Transform

    poses = Transform(traj_rot, traj_trans)
    return poses[:-1].inverse() @ poses[1:]


# ---------------------------------------------------------------------------
# (a) live odometry
# ---------------------------------------------------------------------------


def phase_live(jax):
    import numpy as np

    from align3d_tpu import cli
    from align3d_tpu.icp.params import MsIcpParams
    from align3d_tpu.io.datasets import SlamTbDataset, SubsetDataset
    from align3d_tpu.metrics import TransformMetrics
    from align3d_tpu.odometry import run_odometry
    from align3d_tpu.ops.bilateral import BilateralFilter
    from align3d_tpu.range_image import RangeImageBuilder
    from align3d_tpu.trajectory import Trajectory

    chk = Check("a")
    n_cmp = 5
    for sample in ("sample1", "sample2"):
        path = os.path.join(FIXTURES, sample)
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "trajectory.txt")
            t0 = time.perf_counter()
            rc = cli.main(
                ["odometry", "slamtb", path, "--quiet", "--save-trajectory", out]
            )
            say(f"  (a) cli odometry {sample}: exit {rc}, {time.perf_counter() - t0:.1f}s")
            if rc != 0:
                raise AssertionError(f"cli odometry {sample} exited {rc}")
            with open(out) as f:
                traj = Trajectory.from_tum(f.read())
        ds = SlamTbDataset.load(path)
        gt = ds.trajectory().slice(0, ATE_FRAMES).first_frame_at_origin()
        ate = TransformMetrics.mean_trajectory_error(traj.slice(0, ATE_FRAMES), gt)
        chk.bound(
            f"{sample} mean trajectory angle error, first {ATE_FRAMES} frames (deg)",
            math.degrees(float(ate.angle)),
            ATE_ANGLE_DEG,
            "ground truth; bound of tests/test_odometry_accuracy.py",
        )
        chk.bound(
            f"{sample} mean trajectory translation error, first {ATE_FRAMES} frames",
            float(ate.translation),
            ATE_TRANSLATION,
            "ground truth; bound of tests/test_odometry_accuracy.py",
        )
        # The same pipeline on the CPU backend of this process.
        with jax.default_device(jax.devices("cpu")[0]):
            cpu = run_odometry(
                SubsetDataset(ds, range(n_cmp + 1)),
                range_builder=RangeImageBuilder(bilateral_filter=BilateralFilter()),
                icp_params=MsIcpParams.default(),
            ).trajectory
        gpu_rel = _relative(
            np.asarray(traj.camera_to_world.rotation[: n_cmp + 1]),
            np.asarray(traj.camera_to_world.translation[: n_cmp + 1]),
        )
        cpu_rel = _relative(
            np.asarray(cpu.camera_to_world.rotation),
            np.asarray(cpu.camera_to_world.translation),
        )
        angle, trans = _pose_gaps(gpu_rel, cpu_rel)
        why = (
            "float32 both sides, matmuls at HIGHEST; differences are summation "
            "order and libm; limit is about 1/10 of the accuracy bars"
        )
        chk.bound(f"{sample} first {n_cmp} relative poses GPU vs CPU, angle (rad)", angle, 1e-3, why)
        chk.bound(f"{sample} first {n_cmp} relative poses GPU vs CPU, translation (m)", trans, 1e-3, why)
    chk.done()


# ---------------------------------------------------------------------------
# (b) offline batch
# ---------------------------------------------------------------------------


def phase_offline(jax):
    import jax.numpy as jnp
    import numpy as np

    from align3d_tpu.icp.multiscale import MultiscaleAlign
    from align3d_tpu.icp.params import MsIcpParams
    from align3d_tpu.ops.bilateral import BilateralFilter
    from align3d_tpu.parallel.batch import odometry_step
    from align3d_tpu.range_image import build_pyramid_impl
    from align3d_tpu.se3 import stack
    from benches.bench_odometry import bucket_plan, mixed_frames

    chk = Check("b")
    colors, depths, intr, scale = mixed_frames()  # 65 frames, 64 pairs
    filt = BilateralFilter()
    plan = bucket_plan(depths, filt)
    say("  (b) gd buckets: " + ", ".join(f"{g}x{len(i)}" for g, i, _ in plan))
    colors = jnp.asarray(colors)
    cmin = jnp.min(jnp.where(depths > 0, depths, np.uint16(65535)), axis=(1, 2))
    t0 = time.perf_counter()
    filtered = jax.block_until_ready(
        filt.filter_static_buckets(jnp.asarray(depths), jnp.asarray(cmin), plan)
    )
    say(f"  (b) filter_static_buckets, 65 frames: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    params = MsIcpParams.default()
    traj = odometry_step(intr, scale, colors, filtered, params)
    batch_rel = _relative(
        np.asarray(traj.camera_to_world.rotation),
        np.asarray(traj.camera_to_world.translation),
    )
    say(f"  (b) odometry_step, 64 pairs: {time.perf_counter() - t0:.1f}s")
    say(f"  (b) peak device memory: {jax.devices()[0].memory_stats().get('peak_bytes_in_use', 0) / 2**30:.1f} GiB")

    pyramid = jax.jit(
        lambda c, d: build_pyramid_impl(True, True, 3, 1.0, intr, scale, c, d)
    )
    pyrs = [pyramid(colors[i], filtered[i]) for i in range(colors.shape[0])]
    seq = stack(
        [
            MultiscaleAlign(params, pyrs[i - 1]).align(pyrs[i])
            for i in range(1, len(pyrs))
        ]
    )
    # Pairs that straddle the two fixtures join unrelated frames; they are
    # held to finiteness only.
    same_scene = np.asarray([frames_same_fixture(i) for i in range(64)])
    angle, trans = _pose_gaps(batch_rel[same_scene], seq[same_scene])
    why = (
        "same card and engine, float32, matmuls at HIGHEST; batched and "
        "per-pair programs fuse and reduce in other orders, which the GN "
        "fixed point amplifies on weakly conditioned pairs; limit is about "
        "1/10 of the accuracy bars"
    )
    chk.bound(f"{int(same_scene.sum())} pairs batch vs sequential, angle (rad)", angle, 1e-3, why)
    chk.bound(f"{int(same_scene.sum())} pairs batch vs sequential, translation (m)", trans, 1e-3, why)
    finite = np.isfinite(np.asarray(batch_rel.translation)).all()
    chk.bound("non-finite relative poses", 0.0 if finite else 1.0, 0.0, "all 64 pairs")
    chk.done()


def frames_same_fixture(pair: int) -> bool:
    """Whether pair ``pair`` of ``mixed_frames`` joins frames of one fixture
    (31 sample1, 15 sample2, 14 sample2 reversed, 5 sample1): the frames
    after index 30 and index 59 start another fixture."""
    return pair + 1 not in (31, 60)


# ---------------------------------------------------------------------------
# (c) bilateral filter
# ---------------------------------------------------------------------------


def phase_bilateral(jax):
    import jax.numpy as jnp
    import numpy as np

    from align3d_tpu.io.datasets import SlamTbDataset
    from align3d_tpu.ops.bilateral import BilateralFilter

    chk = Check("c")
    filt = BilateralFilter()
    for sample in ("sample1", "sample2"):
        ds = SlamTbDataset.load(os.path.join(FIXTURES, sample))
        for i in (0, len(ds) - 1):
            depth = np.asarray(ds.get(i).image.depth)
            gpu = np.asarray(filt.filter(jnp.asarray(depth)))
            with jax.default_device(jax.devices("cpu")[0]):
                cpu = np.asarray(filt.filter(jnp.asarray(depth)))
            diff = np.abs(gpu.astype(np.int64) - cpu.astype(np.int64))
            gd = int((int(depth.max()) - int(depth[depth > 0].min())) / filt.sigma_color) + 5
            why = "u16 output; a truncating cast of float32 sums that differ in the last bits"
            chk.bound(f"{sample} frame {i} (gd~{gd}) max |GPU - CPU| (depth units)", float(diff.max()), 1.0, why)
            chk.bound(f"{sample} frame {i} share of pixels that differ", float((diff > 0).mean()), 1e-3, why)
    chk.done()


# ---------------------------------------------------------------------------
# (d) fused ICP kernel
# ---------------------------------------------------------------------------


def phase_kernel(jax):
    import jax.numpy as jnp
    import numpy as np
    import pytest

    from align3d_tpu.icp.image_icp import icp_step
    from align3d_tpu.icp.params import MsIcpParams
    from align3d_tpu.ops import icp_fused
    from align3d_tpu.ops.target_pack import pack_geometry, pack_intensity_taps
    from align3d_tpu.se3 import Transform
    from bench import align_fn, real_pyramid_pairs

    chk = Check("d")
    targets, sources = real_pyramid_pairs(64)
    params = MsIcpParams.default()[0]
    pt = (params.max_distance, params.max_normal_angle, params.max_color_distance, 0.0)
    pose = Transform.exp(jnp.asarray([0.004, -0.002, 0.003, 0.002, -0.003, 0.001]))
    for batch in (1, 64):
        for lvl, (t, s) in enumerate(zip(targets, sources)):
            t = jax.tree.map(lambda a: a[:batch], t)
            s = jax.tree.map(lambda a: a[:batch], s)
            h, w = t.points.shape[1:3]
            n = h * w
            geo = jax.vmap(pack_geometry)(t.points, t.normals, t.mask)
            taps = jax.vmap(pack_intensity_taps)(t.intensity_map)
            rot = jnp.broadcast_to(pose.rotation, (batch, 3, 3))
            tr = jnp.broadcast_to(pose.translation, (batch, 3))
            sp, sm, si = s.points.reshape(batch, n, 3), s.mask.reshape(batch, n), s.intensities.reshape(batch, n)
            ref = jax.jit(
                jax.vmap(
                    lambda r, tt, a, b, c, g, k: icp_step(
                        Transform(r, tt), a, b, c, g, k, h, w, t.intrinsics, params
                    )
                )
            )(rot, tr, sp, sm, si, geo, taps)
            got = jax.jit(
                lambda r, tt, p, g, k: icp_fused.systems_from_partials(
                    icp_fused.step_partials(r, tt, p, g, k, t.intrinsics, h, w, pt)
                )
            )(rot, tr, icp_fused.pack_source(sp, sm, si), geo, taps)
            for label, g, r in (("geometric", got[0], ref[0]), ("color", got[1], ref[1])):
                scale_h = jnp.max(jnp.abs(r.hessian), axis=(-2, -1))
                scale_g = jnp.max(jnp.abs(r.gradient), axis=-1)
                eh = float(jnp.max(jnp.max(jnp.abs(g.hessian - r.hessian), axis=(-2, -1)) / scale_h))
                eg = float(jnp.max(jnp.max(jnp.abs(g.gradient - r.gradient), axis=-1) / scale_g))
                ec = float(jnp.max(jnp.abs(g.count - r.count) / jnp.maximum(r.count, 1.0)))
                why = (
                    "float32, reference at HIGHEST; summation order differs, and a "
                    "gate that flips on a last-bit difference moves one pixel's "
                    "term (the count check bounds flips at 1e-4 of the pixels)"
                )
                tag = f"L{lvl} {w}x{h} b{batch} {label}"
                chk.bound(f"{tag} 6x6 H, max error / max |H|", eh, 2e-3, why)
                chk.bound(f"{tag} g, max error / max |g|", eg, 2e-3, why)
                chk.bound(f"{tag} gate count, relative", ec, 1e-4, "arccos and FMA rounding differ")
    for batch in (1, 64):
        t = [jax.tree.map(lambda a: a[:batch], ri) for ri in targets]
        s = [jax.tree.map(lambda a: a[:batch], ri) for ri in sources]
        xla = Transform(*align_fn(MsIcpParams.default())(t, s))
        fused = Transform(
            *align_fn(MsIcpParams.default().customize(lambda i, p: p.replace(engine="fused")))(t, s)
        )
        angle, trans = _pose_gaps(xla, fused)
        why = "20/20/30 multiscale align, float32, reference at HIGHEST"
        chk.bound(f"b{batch} aligned poses fused vs xla, angle (rad)", angle, 1e-4, why)
        chk.bound(f"b{batch} aligned poses fused vs xla, translation (m)", trans, 1e-4, why)
    del targets, sources

    os.environ["ALIGN3D_TEST_GPU"] = "1"
    rc = pytest.main(
        ["-q", "-m", "gpu", "-p", "no:cacheprovider", os.path.join(HERE, "tests", "test_icp_fused.py")]
    )
    say(f"  (d) pytest -m gpu: exit {int(rc)}")
    if rc != 0:
        chk.failures.append("tests marked gpu")
    chk.done()


# ---------------------------------------------------------------------------
# (e) several cards
# ---------------------------------------------------------------------------


def phase_multi(jax):
    import jax.numpy as jnp
    import numpy as np

    from align3d_tpu.icp.params import MsIcpParams
    from align3d_tpu.parallel import bundle_adjustment as ba
    from align3d_tpu.parallel import pose_graph as pg
    from align3d_tpu.parallel.batch import make_mesh, odometry_step
    from align3d_tpu.parallel.sequence import odometry_sequence_parallel
    from benches.bench_odometry import real_frames

    chk = Check("e")
    n_dev = len(jax.devices())
    mesh = make_mesh()
    one = make_mesh(1)
    say(f"  (e) mesh: 1-D over {n_dev} devices, axis {mesh.axis_names[0]!r}")
    colors, depths, intr, scale = real_frames()
    n = 4 * n_dev  # frames; the frame axis divides over the cards
    colors, depths = jnp.asarray(colors[:n]), jnp.asarray(depths[:n])
    params = MsIcpParams.default()
    why = "same program split across cards, float32, matmuls at HIGHEST"

    single = odometry_step(intr, scale, colors, depths, params, mesh=one)
    sharded = odometry_step(intr, scale, colors, depths, params, mesh=mesh)
    seq = odometry_sequence_parallel(intr, scale, colors, depths, mesh, params)
    for label, traj in (("DP odometry_step", sharded), ("sequence-parallel odometry", seq)):
        angle, trans = _pose_gaps(traj.camera_to_world, single.camera_to_world)
        chk.bound(f"{label} {n} frames vs one card, angle (rad)", angle, 1e-4, why)
        chk.bound(f"{label} {n} frames vs one card, translation (m)", trans, 1e-4, why)

    # Pose graph: a 500-pose noisy loop with closures, edges sharded.
    from align3d_tpu.se3 import Transform, stack
    from align3d_tpu.trajectory import Trajectory

    rng = np.random.default_rng(11)
    npose = 500
    step = Transform.exp(jnp.asarray([0.1, 0, 0, 0, 0, 2 * np.pi / npose], jnp.float32))
    gt = [Transform.identity()]
    for _ in range(npose - 1):
        gt.append(gt[-1] @ step)
    est = [gt[0]]
    for k in range(npose - 1):
        noise = Transform.exp(jnp.asarray(rng.normal(0, 0.01, 6), jnp.float32))
        est.append(est[-1] @ ((gt[k].inverse() @ gt[k + 1]) @ noise))
    graph = pg.PoseGraph.from_trajectory(
        Trajectory(stack(est), jnp.arange(npose, dtype=jnp.float32))
    )
    for j in (npose // 2, npose - 1):
        graph = graph.with_edge(0, j, gt[0].inverse() @ gt[j], 10.0)
    ref = pg.optimize(graph, iterations=4, solver="cg", cg_iters=256)
    got = pg.optimize(graph, iterations=4, solver="cg", cg_iters=256, mesh=mesh)
    _relative_bound(chk, f"pose graph {npose} poses", graph.nodes, ref, got)

    # Bundle adjustment: 100 poses x 5k landmarks x 20k observations.
    from align3d_tpu.camera import CameraIntrinsics

    cam = CameraIntrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)
    npb, m, o = 100, 5_000, 20_000
    lm_gt = jnp.asarray(rng.uniform([-4, -4, 2.0], [4, 4, 8.0], (m, 3)), jnp.float32)
    poses_gt = stack(gt[:npb])
    obs_pose = jnp.asarray(rng.integers(0, npb, o), jnp.int32)
    obs_lm = jnp.asarray(rng.integers(0, m, o), jnp.int32)
    t_cw = Transform(
        jnp.take(poses_gt.rotation, obs_pose, axis=0),
        jnp.take(poses_gt.translation, obs_pose, axis=0),
    )
    p_cam = t_cw.inverse().apply(jnp.take(lm_gt, obs_lm, axis=0))
    z = p_cam[:, 2]
    problem = ba.BAProblem(
        poses=poses_gt,
        landmarks=lm_gt + jnp.asarray(rng.normal(0, 0.05, (m, 3)), jnp.float32),
        obs_pose=obs_pose,
        obs_landmark=obs_lm,
        obs_uv=jnp.stack(
            [p_cam[:, 0] * cam.fx / z + cam.cx, p_cam[:, 1] * cam.fy / z + cam.cy], axis=1
        ),
        weights=jnp.ones(o, jnp.float32),
        intrinsics=cam,
        obs_z=z,
    )
    ref_p, ref_l = ba.optimize(problem, iterations=3, solver="coo", cg_iters=32)
    got_p, got_l = ba.optimize(problem, iterations=3, solver="coo", cg_iters=32, mesh=mesh)
    _relative_bound(chk, f"bundle adjustment {npb} poses x {m} landmarks", poses_gt, ref_p, got_p)
    moved = float(jnp.max(jnp.linalg.norm(ref_l - problem.landmarks, axis=-1)))
    lm_err = float(jnp.max(jnp.linalg.norm(got_l - ref_l, axis=-1)))
    chk.bound(
        f"bundle adjustment {m} landmarks vs one card (m)",
        lm_err,
        max(0.01 * moved, 1e-4),
        f"1% of the largest landmark correction ({moved:.3e} m)",
    )
    chk.done()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--multi",
        action="store_true",
        help="run only the sharded paths over every card, against one card",
    )
    args = parser.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(
            f"no GPU: JAX's first device is on {devices[0].platform!r}",
            file=sys.stderr,
        )
        return 1
    sys.path.insert(0, HERE)
    from align3d_tpu.config import enable_compile_cache
    from benches._harness import gpu_name_and_power_limit

    say(f"card: {gpu_name_and_power_limit()}")
    say(
        f"device: platform={devices[0].platform} kind={devices[0].device_kind} "
        f"count={len(devices)} jax={jax.__version__} "
        f"compile_cache={enable_compile_cache()}"
    )
    if args.multi:
        if len(devices) < 2:
            print("--multi needs more than one GPU", file=sys.stderr)
            return 1
        phases = [("e", "several cards", phase_multi)]
    else:
        phases = [
            ("a", "live odometry", phase_live),
            ("b", "offline batch", phase_offline),
            ("c", "bilateral filter", phase_bilateral),
            ("d", "fused ICP kernel", phase_kernel),
        ]
    failed = []
    for key, name, fn in phases:
        say(f"phase ({key}) {name}")
        t0 = time.perf_counter()
        try:
            fn(jax)
        except Exception:
            traceback.print_exc(file=sys.stdout)
            failed.append(key)
            say(f"phase ({key}) FAILED after {time.perf_counter() - t0:.1f}s")
        else:
            say(f"phase ({key}) passed in {time.perf_counter() - t0:.1f}s")
        jax.clear_caches()
    if failed:
        say(f"failed phases: {', '.join(failed)}")
        return 1
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
