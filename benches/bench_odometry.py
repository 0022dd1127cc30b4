"""End-to-end offline odometry throughput: batched pyramid preprocessing +
3-level multiscale ICP (reference defaults: 20/20/30 iterations) + parallel
pose scan, ms per frame, with the bilateral filter off and on.

The series are 65 real fixture frames (64 adjacent pairs per step): sample1
forward, backward and wrapped; and a mixed series of sample1 and sample2,
whose grid depths differ by ~6x and run through per-frame depth buckets.

Run from the repository root: ``python benches/bench_odometry.py [xla|fused]``.
"""

import sys

sys.path.insert(0, ".")
from benches._harness import emit, log, require_gpu, time_call  # noqa: E402


def real_frames():
    """65 real sample1 frames (forward + palindrome + wrap = 64 adjacent
    pairs, every one a distinct real RGB-D pair) -> (colors (65,H,W,3) u8,
    depths (65,H,W) u16, intrinsics, depth_scale)."""
    import numpy as np

    from align3d_tpu import config
    from align3d_tpu.io.datasets.slamtb import SlamTbDataset

    ds = SlamTbDataset.load(config.ref_data_path("rgbd", "sample1"))
    base = [ds.get(i) for i in range(len(ds))]  # 31 frames
    frames = base + base[-2::-1]  # palindrome: 31 + 30 = 61
    frames = frames + base[: 65 - len(frames)]  # wrap to 65 = 64 pairs
    colors = np.stack([np.asarray(f.image.color) for f in frames])
    depths = np.stack([np.asarray(f.image.depth) for f in frames])
    return colors, depths, frames[0].camera, float(frames[0].image.depth_scale)


def mixed_frames():
    """65 frames MIXING sample1 (raw depth span ~3,800, grid depth ~68-131)
    with sample2 (span ~22,500, grid depth ~745) — the heterogeneous-scale
    series a union-span static grid axis cannot batch (gd~1074 = a 20 GB
    intermediate at batch 65). The bilateral stage runs per-frame-sized gd
    BUCKETS (plan_depth_buckets), i.e. the reference's per-frame sizing,
    grid.rs:51-54, restored at batch granularity."""
    import numpy as np

    from align3d_tpu import config
    from align3d_tpu.io.datasets.slamtb import SlamTbDataset

    ds1 = SlamTbDataset.load(config.ref_data_path("rgbd", "sample1"))
    ds2 = SlamTbDataset.load(config.ref_data_path("rgbd", "sample2"))
    f1 = [ds1.get(i) for i in range(len(ds1))]  # 31
    f2 = [ds2.get(i) for i in range(len(ds2))]  # 15
    frames = f1 + f2 + f2[-2::-1]  # 31 + 15 + 14 = 60
    frames = frames + f1[: 65 - len(frames)]  # 65 = 64 pairs
    colors = np.stack([np.asarray(f.image.color) for f in frames])
    depths = np.stack([np.asarray(f.image.depth) for f in frames])
    return colors, depths, frames[0].camera, float(frames[0].image.depth_scale)


def bucket_plan(depths_np, filt):
    """Host-side per-frame-sized gd bucket plan (grid.rs:51-54 at batch
    granularity) from a numpy depth series."""
    import numpy as np

    from align3d_tpu.ops.bilateral import plan_depth_buckets

    nz = np.where(depths_np > 0, depths_np, np.uint16(65535))
    cmin = nz.reshape(len(depths_np), -1).min(axis=1)
    cmax = depths_np.reshape(len(depths_np), -1).max(axis=1)
    return plan_depth_buckets(cmin, cmax, filt.sigma_color, quantum=16)


def run_series(label, colors, depths, intr, depth_scale, params):
    """Time the e2e pipeline over one frame series, bilateral off and on."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from align3d_tpu.ops.bilateral import BilateralFilter
    from align3d_tpu.parallel import batch as pbatch
    from align3d_tpu.trajectory import accumulate_scan

    depths_np = np.asarray(depths)
    colors = jnp.asarray(colors)
    depths = jnp.asarray(depths)
    b = colors.shape[0] - 1

    # Bilateral variant: the reference-README pipeline (README.md:44-113
    # enables the filter). The grid's range axis uses per-frame-sized gd
    # buckets — the reference's per-frame sizing (grid.rs:51-54) at batch
    # granularity.
    filt = BilateralFilter()
    plan = bucket_plan(depths_np, filt)
    log(f"[{label}] gd buckets: " + ", ".join(f"{g}x{len(idx)}" for g, idx, _ in plan))

    @jax.jit
    def odometry(colors_in, depths_in):
        pyr = pbatch.build_pyramids_batched(
            intr, depth_scale, colors_in, depths_in, pyramid_levels=3
        )
        src = [jax.tree.map(lambda a: a[1:], ri) for ri in pyr]
        tgt = [jax.tree.map(lambda a: a[:-1], ri) for ri in pyr]
        traj = accumulate_scan(pbatch.multiscale_align_batched(tgt, src, params))
        return traj.camera_to_world.rotation, traj.camera_to_world.translation

    def with_bilateral(colors_in, depths_in):
        cmin = jnp.min(
            jnp.where(depths_in > 0, depths_in, jnp.uint16(65535)), axis=(1, 2)
        )
        return odometry(colors_in, filt.filter_static_buckets(depths_in, cmin, plan))

    results = {}
    for name, fn in (("bilateral off", odometry), ("bilateral on", with_bilateral)):
        stats = time_call(fn, colors, depths, windows=5)
        for k in ("median_ms", "min_ms", "max_ms"):
            stats[k] /= b
        log(f"[{label}] {name}: {stats['median_ms']:.3f} ms/frame")
        results[name] = stats
    return results


def main() -> int:
    jax = require_gpu()
    from align3d_tpu.icp.params import MsIcpParams

    engine = sys.argv[1] if len(sys.argv) > 1 else "xla"
    params = MsIcpParams.default().customize(lambda i, p: p.replace(engine=engine))
    log(f"engine: {engine}; 3-level pyramid, iters 20/20/30")
    for label, frames in (("sample1 64 pairs", real_frames), ("mixed 64 pairs", mixed_frames)):
        rc, rd, rintr, rscale = frames()
        res = run_series(label, rc, rd, rintr, rscale, params)
        for name, stats in res.items():
            emit(
                "odometry_e2e_640x480_ms_per_frame",
                stats,
                series=label,
                bilateral=name == "bilateral on",
                engine=engine,
            )
        jax.clear_caches()
    return 0


if __name__ == "__main__":
    sys.exit(main())
