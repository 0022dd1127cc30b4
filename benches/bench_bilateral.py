"""Bilateral-grid depth filter on real 640x480 depth, stage by stage.

Times splat, blur, normalize and slice (and the whole filter) at the grid
depth of each fixture — sample1 (raw depth span ~2,300, gd ~80-144) and
sample2 (span ~22,500, gd ~750) — at batch 1 and batch 64. A batch runs in
chunks of ``5184 // gd`` frames, the chunking ``filter_static_buckets``
uses to bound its live buffers, so a batch-64 time is the sum over its
chunks. Frames repeat cyclically to fill a batch.

Run from the repository root: ``python benches/bench_bilateral.py``.
"""

import sys

sys.path.insert(0, ".")
from benches._harness import emit, log, require_gpu, time_call  # noqa: E402


def stage_fns(filt, grid_shape):
    import jax

    from align3d_tpu.ops.bilateral import _blur, _normalize, _slice, _splat

    ss, sc = filt.sigma_space, filt.sigma_color
    gd = grid_shape[2]
    splat = jax.jit(
        jax.vmap(lambda d, cm: _splat(d, cm, grid_shape, ss, sc))
    )
    blur = jax.jit(jax.vmap(lambda g: _blur(g, gd)))
    normalize = jax.jit(jax.vmap(_normalize))
    slice_ = jax.jit(jax.vmap(lambda g, d, cm: _slice(g, d, cm, ss, sc)))
    return splat, blur, normalize, slice_


def bench_fixture(name: str, batches=(1, 64)):
    import jax.numpy as jnp
    import numpy as np

    from align3d_tpu import config
    from align3d_tpu.io.datasets.slamtb import SlamTbDataset
    from align3d_tpu.ops.bilateral import BilateralFilter

    filt = BilateralFilter()
    ds = SlamTbDataset.load(config.ref_data_path("rgbd", name))
    depths_all = np.stack([ds.get(i).image.depth for i in range(len(ds))])
    nz = np.where(depths_all > 0, depths_all, np.uint16(65535))
    cmin_all = nz.reshape(len(ds), -1).min(axis=1)
    gd = int((int(depths_all.max()) - int(cmin_all.min())) / filt.sigma_color) + 1 + 4
    gh = int((480 - 1) / filt.sigma_space) + 1 + 4
    gw = int((640 - 1) / filt.sigma_space) + 1 + 4
    splat, blur, normalize, slice_ = stage_fns(filt, (gh, gw, gd))
    for batch in batches:
        chunk = min(batch, max(1, 5184 // gd))
        n_chunks = -(-batch // chunk)
        idx = np.arange(chunk) % len(ds)
        depths = jnp.asarray(depths_all[idx])
        cmin = jnp.asarray(cmin_all[idx])
        grids = splat(depths, cmin)
        blurred = blur(grids)
        normed = normalize(blurred)
        stages = {
            "splat": (splat, depths, cmin),
            "blur": (blur, grids),
            "normalize": (normalize, blurred),
            "slice": (slice_, normed, depths, cmin),
            "filter": (
                lambda d, c: filt.filter_static_batched(d, c, gd),
                depths,
                cmin,
            ),
        }
        for stage, (fn, *args) in stages.items():
            stats = time_call(fn, *args, windows=10)
            for k in ("median_ms", "min_ms", "max_ms"):
                stats[k] *= n_chunks
            log(
                f"{name} gd={gd} batch={batch} ({n_chunks} x {chunk}) {stage}: "
                f"{stats['median_ms']:.3f} ms"
            )
            emit(
                f"bilateral_{stage}_ms",
                stats,
                fixture=name,
                grid_depth=gd,
                batch=batch,
                chunk=chunk,
            )
        del grids, blurred, normed


def main() -> int:
    require_gpu()
    for name in ("sample1", "sample2"):
        bench_fixture(name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
