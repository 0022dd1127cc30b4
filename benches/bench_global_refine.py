"""Global-refinement scalability: 500-pose pose-graph GN and 500x50k BA.

A 500-pose / 50k-landmark synthetic problem on one card. Dense algebra
could not represent either (the BA fill-in alone would be 1.8 TB); the
COO/PCG paths run them outright.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from benches._harness import emit, log, require_gpu, time_call  # noqa: E402


def main() -> int:
    jax = require_gpu()
    import jax.numpy as jnp
    import numpy as np

    from align3d_tpu.camera import CameraIntrinsics
    from align3d_tpu.parallel import bundle_adjustment as ba
    from align3d_tpu.parallel import pose_graph as pg
    from align3d_tpu.se3 import Transform, stack
    from align3d_tpu.trajectory import Trajectory

    rng = np.random.default_rng(11)

    # --- pose graph: 500-pose noisy loop with 2 closures ------------------
    n = 500
    gt = [Transform.identity()]
    for _ in range(n - 1):
        gt.append(
            gt[-1]
            @ Transform.exp(
                jnp.asarray([0.1, 0, 0, 0, 0, 2 * np.pi / n], jnp.float32)
            )
        )
    est = [gt[0]]
    for k in range(n - 1):
        rel = gt[k].inverse() @ gt[k + 1]
        noise = Transform.exp(jnp.asarray(rng.normal(0, 0.01, 6), jnp.float32))
        est.append(est[-1] @ (rel @ noise))
    traj = Trajectory(stack(est), jnp.arange(n, dtype=jnp.float32))
    graph = pg.PoseGraph.from_trajectory(traj)
    for j in (n // 2, n - 1):
        graph = graph.with_edge(0, j, gt[0].inverse() @ gt[j], 10.0)

    pg_stats = time_call(
        lambda: pg.optimize(graph, iterations=4, solver="cg", cg_iters=768),
        windows=3,
        warmup=0,
    )
    log(
        f"pose-graph 500 poses, 4 GN x 768 CG: {pg_stats['median_ms']:.1f} ms "
        f"(first call {pg_stats['first_call_s']:.1f}s)"
    )
    emit("pose_graph_500_4gn_ms", pg_stats)

    # --- BA: 500 poses x 50k landmarks x 200k observations ----------------
    intr = CameraIntrinsics(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)
    m, o = 50_000, 200_000
    landmarks_gt = jnp.asarray(
        rng.uniform([-4, -4, 2.0], [4, 4, 8.0], (m, 3)), jnp.float32
    )
    poses_gt = stack(gt)
    obs_pose = jnp.asarray(rng.integers(0, n, o), jnp.int32)
    obs_landmark = jnp.asarray(rng.integers(0, m, o), jnp.int32)
    t_cw = Transform(
        jnp.take(poses_gt.rotation, obs_pose, axis=0),
        jnp.take(poses_gt.translation, obs_pose, axis=0),
    )
    p_cam = t_cw.inverse().apply(jnp.take(landmarks_gt, obs_landmark, axis=0))
    z = p_cam[:, 2]
    problem = ba.BAProblem(
        poses=poses_gt,
        landmarks=landmarks_gt
        + jnp.asarray(rng.normal(0, 0.05, (m, 3)), jnp.float32),
        obs_pose=obs_pose,
        obs_landmark=obs_landmark,
        obs_uv=jnp.stack(
            [
                p_cam[:, 0] * intr.fx / z + intr.cx,
                p_cam[:, 1] * intr.fy / z + intr.cy,
            ],
            axis=1,
        ),
        weights=jnp.ones(o, jnp.float32),
        intrinsics=intr,
        obs_z=z,
    )
    ba_stats = time_call(
        lambda: ba.optimize(problem, iterations=3, solver="coo", cg_iters=32),
        windows=3,
        warmup=0,
    )
    poses_r, lm_r = ba.optimize(problem, iterations=3, solver="coo", cg_iters=32)
    err = float(
        ba.mean_reprojection_error(
            ba.BAProblem(
                poses_r, lm_r, obs_pose, obs_landmark, problem.obs_uv,
                problem.weights, intr, obs_z=problem.obs_z,
            )
        )
    )
    log(
        f"BA 500 poses x 50k landmarks x 200k obs, 3 GN x 32 CG: "
        f"{ba_stats['median_ms']:.1f} ms (first call "
        f"{ba_stats['first_call_s']:.1f}s), final rms {err:.4f} px"
    )
    emit("ba_500x50k_3gn_ms", ba_stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
