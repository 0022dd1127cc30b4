"""Voxel-hash NN: 500k database vs 500k queries (reference bench_kdtree:
[101.48, 101.75, 102.04] ms on i7-11800H, README.md:131; its kd-tree descent
is approximate, as is the voxel grid — SURVEY.md §2.3)."""

import sys

sys.path.insert(0, ".")
from benches._harness import emit, log, require_gpu, step_ms  # noqa: E402

BASELINE_MS = 101.75
N = 500_000


def main() -> int:
    require_gpu()
    import jax.numpy as jnp
    import numpy as np

    from align3d_tpu.ops.voxel_hash import VoxelHashGrid, nearest

    rng = np.random.default_rng(0)
    db = jnp.asarray(rng.uniform(0, 1, (N, 3)), jnp.float32)
    queries = jnp.asarray(rng.uniform(0, 1, (N, 3)), jnp.float32)
    # Grid build outside the timed loop — the reference's "R3dTree search"
    # bench builds the tree outside b.iter too (benches/bench_kdtree.rs).
    grid = VoxelHashGrid.build(db, cell_size=0.02)

    def step(_, carry):
        q, acc = carry
        _, sq = nearest(grid, q)
        s = jnp.sum(jnp.where(jnp.isfinite(sq[:128]), sq[:128], 0.0))
        return (q + (s * 0.0), acc + s)

    stats = step_ms(step, (queries, jnp.float32(0)), steps=10)
    log(f"voxel-hash NN 500k x 500k: {stats['median_ms']:.3f} ms")
    emit("nn_500k_x_500k_ms", stats, reference_cpu_ms=BASELINE_MS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
