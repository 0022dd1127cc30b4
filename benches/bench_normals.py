"""Range-image normal estimation, 640x480 (reference bench_compute_normals:
[1.1587, 1.1778, 1.2005] ms on i7-11800H, README.md:132)."""

import sys

sys.path.insert(0, ".")
from benches._harness import emit, log, require_gpu, step_ms  # noqa: E402

BASELINE_MS = 1.1778


def main() -> int:
    require_gpu()
    import jax.numpy as jnp
    import numpy as np

    from align3d_tpu.ops.normals import compute_normals

    rng = np.random.default_rng(0)
    h, w = 480, 640
    pts = jnp.asarray(rng.uniform(-1, 1, (h, w, 3)), jnp.float32)
    mask = jnp.asarray(rng.random((h, w)) > 0.1)

    def step(_, carry):
        p, acc = carry
        n = compute_normals(p, mask)
        return (p + 1e-12 * n[0, 0, 0], acc + jnp.sum(n[0, 0]))

    stats = step_ms(step, (pts, jnp.float32(0)), steps=500)
    log(f"compute_normals 640x480: {stats['median_ms']:.4f} ms")
    emit("compute_normals_640x480_ms", stats, reference_cpu_ms=BASELINE_MS)
    return 0


if __name__ == "__main__":
    sys.exit(main())
