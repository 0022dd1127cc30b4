"""2-process multi-host launch: sharded odometry + pose-graph across processes.

Drives the BASELINE north-star scale-out path (≥80% scaling efficiency at 2
hosts) on one machine: two CPU processes x 4 virtual devices join through
``jax.distributed.initialize`` (Gloo collectives over localhost — the CPU
stand-in for DCN), build ONE global 8-device mesh, and run

  1. DP odometry: the batched multiscale-ICP pipeline with the pair axis
     sharded across the global mesh (collective-free until the pose scan);
  2. pose-graph optimization with the edge axis sharded across the mesh
     (one psum per GN iteration);

then process 0 checks both against the single-process result computed
locally. Exit code 0 = parity held on both paths.

Usage:
    python tools/run_multiprocess.py            # driver: spawns 2 workers
    python tools/run_multiprocess.py --worker N # internal

This is the multi-host entry the reference never had (SURVEY §2.6: its only
parallelism is rayon threads, src/icp/image_icp.rs:96); across real hosts
the same code joins them over the network — only the coordinator address
changes.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

COORD = "localhost:29431"
NPROC = 2
LOCAL_DEVICES = 4
H, W = 120, 160
NFRAMES = 9  # 8 pairs -> 4 per process


def make_problem(nframes=NFRAMES):
    import numpy as np

    NFRAMES_ = nframes
    rng = np.random.default_rng(7)
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    tex = rng.uniform(30, 220, size=(H, W + NFRAMES_ + 1, 3)).astype(np.uint8)
    colors = np.stack([tex[:, i : i + W] for i in range(NFRAMES_)])
    depths = np.stack(
        [
            (2000 + 4 * (xs + i) + 2 * ys + rng.integers(0, 8, size=(H, W))).astype(
                np.uint16
            )
            for i in range(NFRAMES_)
        ]
    )
    return colors, depths


def single_process_reference(colors, depths):
    """Ground truth: same pipeline, no mesh, one device."""
    import jax.numpy as jnp

    from align3d_tpu.camera import CameraIntrinsics
    from align3d_tpu.icp.params import MsIcpParams
    from align3d_tpu.parallel import batch as pbatch

    intr = CameraIntrinsics(
        fx=130.0, fy=130.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5, width=W, height=H
    )
    traj = pbatch.odometry_step(
        intr, 0.001, jnp.asarray(colors), jnp.asarray(depths),
        params=MsIcpParams.default(), pyramid_levels=3,
    )
    return traj


def worker(pid: int) -> int:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={LOCAL_DEVICES}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

    from align3d_tpu.parallel import multihost

    multihost.initialize(COORD, NPROC, pid)
    assert jax.device_count() == NPROC * LOCAL_DEVICES, jax.devices()
    assert jax.process_count() == NPROC

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from align3d_tpu.camera import CameraIntrinsics
    from align3d_tpu.icp.params import MsIcpParams
    from align3d_tpu.parallel import batch as pbatch
    from align3d_tpu.parallel import pose_graph as pg
    from align3d_tpu.se3 import Transform
    from align3d_tpu.trajectory import Trajectory

    mesh = multihost.global_mesh()
    colors, depths = make_problem()
    intr = CameraIntrinsics(
        fx=130.0, fy=130.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5, width=W, height=H
    )

    # --- 1. DP odometry, frame-pair axis sharded across BOTH processes ----
    # Every process feeds its HALF of the pair batch; the slight trick is
    # that pairs overlap frames, so each process loads its pair-slice of
    # frames (source i+1, target i) — here each holds frames [lo, hi+1].
    npairs = NFRAMES - 1
    per = npairs // NPROC
    lo = pid * per
    src_local = {"c": colors[lo + 1 : lo + per + 1], "d": depths[lo + 1 : lo + per + 1]}
    tgt_local = {"c": colors[lo : lo + per], "d": depths[lo : lo + per]}

    src_c = multihost.host_local_batch(mesh, src_local["c"])
    src_d = multihost.host_local_batch(mesh, src_local["d"])
    tgt_c = multihost.host_local_batch(mesh, tgt_local["c"])
    tgt_d = multihost.host_local_batch(mesh, tgt_local["d"])

    params = MsIcpParams.default()

    def pair_step(sc, sd, tc, td):
        src_pyr = pbatch.build_pyramids_batched(intr, 0.001, sc, sd)
        tgt_pyr = pbatch.build_pyramids_batched(intr, 0.001, tc, td)
        rel = pbatch.multiscale_align_batched(tgt_pyr, src_pyr, params)
        return rel.rotation, rel.translation

    sharded = NamedSharding(mesh, P(pbatch.BATCH_AXIS))
    replicated = NamedSharding(mesh, P())
    stepf = jax.jit(
        pair_step,
        in_shardings=(sharded,) * 4,
        out_shardings=(replicated, replicated),
    )
    t0 = time.perf_counter()
    rot, trans = jax.block_until_ready(stepf(src_c, src_d, tgt_c, tgt_d))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rot, trans = jax.block_until_ready(stepf(src_c, src_d, tgt_c, tgt_d))
    run_s = time.perf_counter() - t0

    from align3d_tpu.trajectory import accumulate_scan

    traj = accumulate_scan(Transform(rot, trans))

    # --- 2. pose-graph refinement, edges sharded across the global mesh ---
    noisy = Trajectory(
        Transform(
            traj.camera_to_world.rotation,
            traj.camera_to_world.translation
            + 0.01 * np.sin(np.arange(NFRAMES))[:, None] * np.ones(3),
        ),
        traj.times,
    )
    graph = pg.PoseGraph.from_trajectory(noisy)
    refined = pg.optimize(graph, iterations=5, mesh=mesh)

    if pid == 0:
        ref = single_process_reference(colors, depths)
        a = np.asarray(ref.camera_to_world.translation)
        b = np.asarray(traj.camera_to_world.translation)
        odo_err = float(np.abs(a - b).max())
        ref_pg = pg.optimize(graph, iterations=5, mesh=None)
        pg_err = float(
            np.abs(
                np.asarray(ref_pg.translation) - np.asarray(refined.translation)
            ).max()
        )
        print(
            f"[multihost] procs={jax.process_count()} global_devices="
            f"{jax.device_count()} odo_parity={odo_err:.2e} "
            f"pg_parity={pg_err:.2e} compile={compile_s:.1f}s run={run_s:.3f}s",
            flush=True,
        )
        ok = odo_err < 1e-4 and pg_err < 1e-4
        print("[multihost] PARITY OK" if ok else "[multihost] PARITY FAIL", flush=True)
        return 0 if ok else 1
    return 0


FAULT_EXIT = 17
CKPT = os.path.join(tempfile.gettempdir(), "align3d_mh_ckpt.json")


def worker_fault(pid: int, phase: int) -> int:
    """Failure-recovery drill (SURVEY §5: multi-host failure handling =
    clean abort + restart from checkpointed poses).

    Phase 1: both processes run DP odometry over the FIRST half of the
    pairs; process 0 checkpoints the composed partial trajectory; process 1
    then aborts (simulated host loss). Phase 2 (fresh processes — a real
    restart): resume from the checkpoint, run the second half, and process
    0 checks the stitched trajectory against the uninterrupted
    single-process result.
    """
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={LOCAL_DEVICES}"
    ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")

    from align3d_tpu.parallel import multihost

    multihost.initialize(COORD, NPROC, pid)

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from align3d_tpu import checkpoint
    from align3d_tpu.camera import CameraIntrinsics
    from align3d_tpu.icp.params import MsIcpParams
    from align3d_tpu.parallel import batch as pbatch
    from align3d_tpu.se3 import Transform
    from align3d_tpu.trajectory import Trajectory, accumulate_scan

    mesh = multihost.global_mesh()
    # 17 frames -> 16 pairs: each HALF (8 pairs) fills the 8-device mesh.
    colors, depths = make_problem(nframes=17)
    intr = CameraIntrinsics(
        fx=130.0, fy=130.0, cx=W / 2 - 0.5, cy=H / 2 - 0.5, width=W, height=H
    )
    params = MsIcpParams.default()
    npairs = 16
    half = npairs // 2

    def run_chunk(lo_pair: int, count: int):
        per = count // NPROC
        base = lo_pair + pid * per
        src_c = multihost.host_local_batch(mesh, colors[base + 1 : base + per + 1])
        src_d = multihost.host_local_batch(mesh, depths[base + 1 : base + per + 1])
        tgt_c = multihost.host_local_batch(mesh, colors[base : base + per])
        tgt_d = multihost.host_local_batch(mesh, depths[base : base + per])

        def pair_step(sc, sd, tc, td):
            src_pyr = pbatch.build_pyramids_batched(intr, 0.001, sc, sd)
            tgt_pyr = pbatch.build_pyramids_batched(intr, 0.001, tc, td)
            rel = pbatch.multiscale_align_batched(tgt_pyr, src_pyr, params)
            return rel.rotation, rel.translation

        sharded = NamedSharding(mesh, P(pbatch.BATCH_AXIS))
        repl = NamedSharding(mesh, P())
        f = jax.jit(
            pair_step, in_shardings=(sharded,) * 4, out_shardings=(repl, repl)
        )
        rot, trans = jax.block_until_ready(f(src_c, src_d, tgt_c, tgt_d))
        return accumulate_scan(Transform(rot, trans))

    if phase == 1:
        traj = run_chunk(0, half)
        if pid == 0:
            checkpoint.save_odometry(CKPT, traj, next_frame=half + 1)
            print(f"[fault] phase1 checkpointed at frame {half + 1}", flush=True)
        if pid == 1:
            os._exit(FAULT_EXIT)  # simulated host loss (clean abort)
        return 0

    # phase 2: restart from the checkpoint
    prev, next_frame = checkpoint.load_odometry(CKPT)
    traj2 = run_chunk(next_frame - 1, npairs - (next_frame - 1))
    # Stitch: chunk-2 poses are relative to the checkpointed last pose.
    last = prev.camera_to_world[len(prev) - 1]
    stitched_rot = jnp.concatenate(
        [
            prev.camera_to_world.rotation,
            (last @ traj2.camera_to_world).rotation[1:],
        ]
    )
    stitched_tr = jnp.concatenate(
        [
            prev.camera_to_world.translation,
            (last @ traj2.camera_to_world).translation[1:],
        ]
    )
    if pid == 0:
        ref = single_process_reference(colors, depths)
        err = float(
            np.abs(
                np.asarray(ref.camera_to_world.translation)
                - np.asarray(stitched_tr)
            ).max()
        )
        print(f"[fault] resume parity vs uninterrupted: {err:.2e}", flush=True)
        # Chunked composition reassociates the SE(3) products, so f32
        # round-off differs slightly from the one-scan reference.
        ok = err < 5e-4
        print("[fault] RESUME OK" if ok else "[fault] RESUME FAIL", flush=True)
        return 0 if ok else 1
    return 0


def _launch(args_extra, capture_pid0=True, expect_rc1=0):
    procs = []
    for pid in range(NPROC):
        procs.append(
            subprocess.Popen(
                [sys.executable, __file__, "--worker", str(pid)] + args_extra,
                env=dict(os.environ),
                stdout=subprocess.PIPE if pid == 0 else subprocess.DEVNULL,
                stderr=subprocess.STDOUT if pid == 0 else subprocess.DEVNULL,
                text=True,
            )
        )
    out, _ = procs[0].communicate(timeout=900)
    rc1 = procs[1].wait(timeout=120)
    sys.stdout.write(out)
    return procs[0].returncode, rc1


def main() -> int:
    if "--worker" in sys.argv:
        pid = int(sys.argv[sys.argv.index("--worker") + 1])
        if "--fault-phase" in sys.argv:
            return worker_fault(
                pid, int(sys.argv[sys.argv.index("--fault-phase") + 1])
            )
        return worker(pid)
    if "--fault" in sys.argv:
        rc0, rc1 = _launch(["--fault-phase", "1"])
        if rc1 != FAULT_EXIT:
            print(f"[fault] expected worker 1 abort, got {rc1}")
            return 1
        print("[fault] worker 1 lost; restarting from checkpoint", flush=True)
        rc0, rc1 = _launch(["--fault-phase", "2"])
        return rc0 or rc1
    procs = []
    for pid in range(NPROC):
        env = dict(os.environ)
        procs.append(
            subprocess.Popen(
                [sys.executable, __file__, "--worker", str(pid)],
                env=env,
                stdout=subprocess.PIPE if pid == 0 else subprocess.DEVNULL,
                stderr=subprocess.STDOUT if pid == 0 else subprocess.DEVNULL,
                text=True,
            )
        )
    out, _ = procs[0].communicate(timeout=900)
    procs[1].wait(timeout=60)
    sys.stdout.write(out)
    return procs[0].returncode


if __name__ == "__main__":
    sys.exit(main())
