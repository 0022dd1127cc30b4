"""Unordered point-cloud ICP align (reference benches/bench_icp.rs —
no published number; we publish ours)."""

import sys

sys.path.insert(0, ".")
from benches._harness import emit, log, require_gpu, step_ms  # noqa: E402


def main() -> int:
    require_gpu()
    import jax.numpy as jnp
    import numpy as np

    from align3d_tpu.icp.params import IcpParams
    from align3d_tpu.icp.pcl_icp import Icp
    from align3d_tpu.pointcloud import PointCloud
    from align3d_tpu.se3 import Transform

    rng = np.random.default_rng(0)
    n = 100_000
    # Curved surface with analytic normals — a constant-normal plane leaves
    # the point-to-plane 6x6 system rank-deficient (singular solve -> NaN).
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    pts[:, 2] = 0.3 * np.sin(2.0 * pts[:, 0]) * np.cos(2.0 * pts[:, 1])
    dzdx = 0.6 * np.cos(2.0 * pts[:, 0]) * np.cos(2.0 * pts[:, 1])
    dzdy = -0.6 * np.sin(2.0 * pts[:, 0]) * np.sin(2.0 * pts[:, 1])
    normals = np.stack([-dzdx, -dzdy, np.ones(n, np.float32)], axis=1)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    normals = normals.astype(np.float32)
    target = PointCloud(
        jnp.asarray(pts), jnp.ones(n, bool), normals=jnp.asarray(normals)
    )
    delta = Transform.exp(jnp.asarray([0.01, -0.005, 0.008, 0.004, -0.006, 0.01]))
    source = target.transformed(delta)

    params = IcpParams(max_iterations=10)
    icp = Icp(params, target.points, target.normals)
    import time

    t0 = time.perf_counter()
    result = icp.align(source.points, source.normals)
    log(f"first align (compile): {time.perf_counter() - t0:.1f}s; "
        f"angle err {float((result.inverse() @ delta.inverse()).angle()):.5f}")

    # Aligns chain through the loop carry inside one jitted loop.
    from align3d_tpu.icp.pcl_icp import _align_jit

    src_mask = jnp.ones(n, bool)

    def step(_, carry):
        rot, trans, acc = carry
        br, bt, bres = _align_jit(
            rot,
            trans + 1e-12 * acc,
            source.points,
            source.normals,
            src_mask,
            icp.grid,
            icp.target_points,
            icp.target_normals,
            params,
            icp.max_per_cell,
        )
        return (rot, trans, acc + bres + jnp.sum(bt))

    stats = step_ms(step, (jnp.eye(3), jnp.zeros(3), jnp.float32(0)), steps=5)
    log(f"pcl icp align 100k, 10 iters: {stats['median_ms']:.2f} ms/align")
    emit("pcl_icp_100k_10iter_ms", stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
