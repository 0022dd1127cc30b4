"""Mesh vertex normals (reference benches/bench_mesh.rs — no published
number; we publish ours on a 200k-face synthetic mesh)."""

import sys

sys.path.insert(0, ".")
from benches._harness import emit, log, require_gpu, step_ms  # noqa: E402


def main() -> int:
    require_gpu()
    import jax.numpy as jnp
    import numpy as np

    from align3d_tpu.ops.mesh import MeshNormals, compute_vertex_normals

    rng = np.random.default_rng(0)
    side = 320  # (side+1)^2 vertices, 2*side^2 = 204800 faces
    ys, xs = np.meshgrid(np.arange(side + 1), np.arange(side + 1), indexing="ij")
    zs = np.sin(xs * 0.1) * np.cos(ys * 0.1)
    pts = np.stack([xs, ys, zs], axis=-1).reshape(-1, 3).astype(np.float32)
    vid = lambda r, c: r * (side + 1) + c
    faces = []
    for r in range(side):
        base = r * (side + 1)
        a = np.arange(side)
        faces.append(np.stack([base + a, base + a + 1, base + side + 1 + a], axis=1))
        faces.append(
            np.stack([base + a + 1, base + side + 2 + a, base + side + 1 + a], axis=1)
        )
    faces = np.concatenate(faces).astype(np.int32)
    log(f"mesh: {pts.shape[0]} vertices, {faces.shape[0]} faces")
    pts_j = jnp.asarray(pts)
    faces_j = jnp.asarray(faces)

    evaluator = MeshNormals(faces, pts.shape[0])
    log(f"cached topology: max vertex degree {evaluator.degree}")

    def step_cached(_, carry):
        p, acc = carry
        vn = evaluator(p)
        return (p + 1e-12 * vn[0, 0], acc + jnp.sum(vn[0]))

    stats = step_ms(step_cached, (pts_j, jnp.float32(0)), steps=200)
    log(
        f"mesh normals (gather table) {faces.shape[0]} faces: "
        f"{stats['median_ms']:.3f} ms"
    )

    def step(_, carry):
        p, acc = carry
        vn = compute_vertex_normals(p, faces_j)
        return (p + 1e-12 * vn[0, 0], acc + jnp.sum(vn[0]))

    scatter = step_ms(step, (pts_j, jnp.float32(0)), steps=50)
    log(
        f"mesh normals (one-shot segment_sum) {faces.shape[0]} faces: "
        f"{scatter['median_ms']:.3f} ms"
    )
    emit("mesh_normals_200k_faces_ms", stats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
