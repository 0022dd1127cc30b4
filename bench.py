"""Headline benchmark: multiscale projective ICP on one NVIDIA GPU.

Aligns distinct real RGB-D pairs from the in-repo fixtures (sample1 and
sample2, adjacent pairs forward and then reversed) with the reference's
multiscale schedule: a 3-level pyramid and 20/20/30 Gauss-Newton iterations
fine to coarse (``MsIcpParams.default``). Pyramids are built once, outside
the timed windows. Each engine (``xla``, ``fused``) is timed at batch 1 and
at batch 64; every window is one call that ends in ``block_until_ready``.

Run from the repository root: ``python bench.py``. It refuses any platform
but ``gpu``. Earlier lines give the card (name and power limit), the device
and each measurement as a JSON line; the last line is the headline, ms per
aligned pair at batch 64 on the ``xla`` engine.
"""

import sys

from benches._harness import emit, log, require_gpu, time_call

BATCH = 64


def real_pyramid_pairs(n_pairs: int, levels: int = 3):
    """(target, source) lists of batched RangeImages, fine to coarse, for
    ``n_pairs`` distinct adjacent fixture pairs (forward, then reversed)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from align3d_tpu import config
    from align3d_tpu.io.datasets.slamtb import SlamTbDataset
    from align3d_tpu.parallel.batch import build_pyramids_batched

    pyramids = []
    for name in ("sample1", "sample2"):
        ds = SlamTbDataset.load(config.ref_data_path("rgbd", name))
        frames = [ds.get(i) for i in range(len(ds))]
        pyramids.append(
            build_pyramids_batched(
                frames[0].camera,
                float(frames[0].image.depth_scale),
                jnp.asarray(np.stack([f.image.color for f in frames])),
                jnp.asarray(np.stack([f.image.depth for f in frames])),
                pyramid_levels=levels,
            )
        )
    # Both fixtures share one camera, so their pyramids concatenate.
    pyr = [
        jax.tree.map(lambda *xs: jnp.concatenate(xs), *lvl) for lvl in zip(*pyramids)
    ]
    starts = np.cumsum([0] + [p[0].points.shape[0] for p in pyramids])
    fwd = [
        (i, i + 1) for s, e in zip(starts[:-1], starts[1:]) for i in range(s, e - 1)
    ]
    pairs = (fwd + [(b, a) for a, b in fwd])[:n_pairs]
    if len(pairs) < n_pairs:
        raise RuntimeError(f"only {len(pairs)} distinct pairs available")
    tgt_idx = np.asarray([t for t, _ in pairs])
    src_idx = np.asarray([s for _, s in pairs])
    targets = [jax.tree.map(lambda a: a[tgt_idx], ri) for ri in pyr]
    sources = [jax.tree.map(lambda a: a[src_idx], ri) for ri in pyr]
    return targets, sources


def align_fn(params):
    import jax

    from align3d_tpu.parallel.batch import multiscale_align_batched

    @jax.jit
    def run(targets, sources):
        t = multiscale_align_batched(targets, sources, params)
        return t.rotation, t.translation

    return run


def main() -> int:
    jax = require_gpu()
    import numpy as np

    from align3d_tpu.icp.params import MsIcpParams

    targets, sources = jax.block_until_ready(real_pyramid_pairs(BATCH))
    log("3-level pyramid, 20/20/30 iterations, real fixture pairs")
    headline = None
    poses = {}
    for batch in (1, BATCH):
        t = [jax.tree.map(lambda a: a[:batch], ri) for ri in targets]
        s = [jax.tree.map(lambda a: a[:batch], ri) for ri in sources]
        for engine in ("xla", "fused"):
            params = MsIcpParams.default().customize(
                lambda i, p: p.replace(engine=engine)
            )
            fn = align_fn(params)
            stats = time_call(fn, t, s, windows=10)
            poses[engine, batch] = fn(t, s)
            stats_pair = dict(stats)
            for k in ("median_ms", "min_ms", "max_ms"):
                stats_pair[k] = stats[k] / batch
            log(
                f"engine={engine} batch={batch}: {stats['median_ms']:.3f} ms per call "
                f"(median of {stats['n']}, first call {stats['first_call_s']:.1f} s)"
            )
            emit(
                f"multiscale_align_ms_per_pair_{engine}_b{batch}",
                stats_pair,
                engine=engine,
                batch=batch,
            )
            if engine == "xla" and batch == BATCH:
                headline = stats_pair
        rx, tx = poses["xla", batch]
        rf, tf = poses["fused", batch]
        log(
            f"batch={batch}: fused vs xla max |dR| "
            f"{float(np.abs(np.asarray(rf) - np.asarray(rx)).max()):.3e}, max |dt| "
            f"{float(np.abs(np.asarray(tf) - np.asarray(tx)).max()):.3e}"
        )
    emit("multiscale_align_ms_per_pair", headline, engine="xla", batch=BATCH)
    return 0


if __name__ == "__main__":
    sys.exit(main())
