"""Bilateral-grid depth filter (Chen/Paris/Durand real-time bilateral grid).

Counterpart of the reference ``src/bilateral/`` (grid.rs + edge_aware_filter.rs,
which cite the same paper). The decomposition exploits one structural fact:
the SPATIAL grid<->image coordinate maps depend only on pixel position — they
are compile-time constants — and only the range (z) coordinate is
data-dependent. So there are no runtime scatters anywhere:

* **splat** — per grid cell, its contributing pixel window is a static
  numpy table; the data-dependent z lands via a fused one-hot
  compare-accumulate over the window taps;
* **blur** — each axis's two masked 1-2-1/4 passes collapse into one
  precomputed banded matrix applied as a contraction
  (edge_aware_filter.rs:57-115 interior-only write semantics are inside the
  matrix + a mask);
* **normalize + slice** — trilinear sampling with static spatial corner
  planes shared across each image-row group (grid.rs:90-162 semantics); the
  data-dependent z lookup is a one-hot weighted reduction that XLA fuses.

Internally the grid is channel-major (2, gh, gw, gd) so the range axis is the
minor (contiguous) dimension of every stage; ``BilateralGrid.data`` exposes
the reference's trailing-2 layout.

The grid's depth extent is data-dependent in the reference
(``(max - min)/sigma_color``, grid.rs:51-54); for stable jit caching the
depth axis can be padded up to a multiple (``pad_depth_to``) — padded
channels stay empty and are never sampled, so results are unchanged.

Like the reference, slicing evaluates EVERY pixel (including zero-depth
holes), so the filter also fills holes near valid data — this grows the
valid-pixel mask downstream, matching reference behavior.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from align3d_tpu.config import MATMUL_PRECISION

Array = jax.Array

_SPACE_PAD = 2
_COLOR_PAD = 2


def _splat_window(n_src: int, n_dst: int, inv_ss: float, pad: int):
    """Static inverse of the splat coordinate map.

    Each source index lands at dst = trunc(src*inv_ss + 0.5) + pad
    (grid.rs:59-66); inverting it gives, per dst cell, its <= ceil(sigma)
    contributing source indices — a compile-time (n_dst, width) table with a
    0/1 weight for unused slots.
    """
    import numpy as np

    dst = (np.arange(n_src, dtype=np.float32) * np.float32(inv_ss) + 0.5).astype(
        np.int32
    ) + pad
    groups: list[list[int]] = [[] for _ in range(n_dst)]
    for s, d in enumerate(dst):
        if 0 <= d < n_dst:
            groups[d].append(s)
    width = max((len(v) for v in groups), default=1) or 1
    idx = np.zeros((n_dst, width), np.int32)
    wt = np.zeros((n_dst, width), np.float32)
    for d, v in enumerate(groups):
        for t, s in enumerate(v):
            idx[d, t] = s
            wt[d, t] = 1.0
    return idx, wt


@partial(jax.jit, static_argnames=("grid_shape", "sigma_space", "sigma_color"))
def _splat(
    image: Array,
    color_min: Array,
    grid_shape: tuple[int, int, int],
    sigma_space: float,
    sigma_color: float,
) -> Array:
    """Depth values+counts into the grid (grid.rs:59-77).

    The reference's per-pixel scatter becomes a GATHER — the spatial splat
    coordinates depend only on the pixel position, so each grid cell's
    contributing pixel window is a numpy constant (:func:`_splat_window`);
    only the range (z) coordinate is data-dependent and resolves as a
    one-hot compare-accumulate over the window taps.
    """
    import numpy as np

    gh, gw, gd = grid_shape
    h, w = image.shape
    inv_ss = 1.0 / sigma_space
    inv_sc = 1.0 / sigma_color

    ridx, rwt = _splat_window(h, gh, inv_ss, _SPACE_PAD)
    cidx, cwt = _splat_window(w, gw, inv_ss, _SPACE_PAD)

    vals = image.astype(jnp.float32)
    valid = (image > 0).astype(jnp.float32)
    chan = ((vals - color_min.astype(jnp.float32)) * inv_sc + 0.5).astype(
        jnp.int32
    ) + _COLOR_PAD

    # Static window gathers: (gh, A, gw, B) tap tensors (A=B=ceil(sigma)).
    def window(x):
        return x[ridx][:, :, cidx]

    zed = window(chan)
    val_t = window(vals)
    w_t = window(valid) * jnp.asarray(
        rwt[:, :, None, None] * cwt[None, None, :, :], jnp.float32
    )
    a_taps, b_taps = zed.shape[1], zed.shape[3]

    kk = jax.lax.broadcasted_iota(jnp.int32, (gh, gw, gd), 2)
    acc_v = jnp.zeros((gh, gw, gd), jnp.float32)
    acc_c = jnp.zeros((gh, gw, gd), jnp.float32)
    for a in range(a_taps):
        for b in range(b_taps):
            oh = (kk == zed[:, a, :, b, None]).astype(jnp.float32)
            acc_c = acc_c + oh * w_t[:, a, :, b, None]
            acc_v = acc_v + oh * (w_t[:, a, :, b] * val_t[:, a, :, b])[..., None]
    # Channel-major stack: (2, gh, gw, gd) keeps gd the minor axis.
    return jnp.stack([acc_v, acc_c], axis=0)


def _tridiag_121(n: int) -> "np.ndarray":
    """The one-pass 1-2-1/4 blur stencil as an (n, n) matrix."""
    import numpy as np

    t = np.zeros((n, n), np.float32)
    idx = np.arange(n)
    t[idx, idx] = 0.5
    t[idx[1:], idx[:-1]] = 0.25
    t[idx[:-1], idx[1:]] = 0.25
    return t


def _blur_matrix(n: int, mask: "np.ndarray") -> "np.ndarray":
    """The one-axis double-pass blur as a single (n, n) matrix.

    One reference pass is out = mask * (T x) with T tridiagonal 1-2-1/4 and
    ``mask`` the interior indicator along this axis (edge_aware_filter.rs:
    57-115 writes interior cells only); two passes collapse to
    A = M T M T — a banded compile-time constant, so each axis costs ONE
    contraction instead of two shift passes.
    """
    import numpy as np

    m = np.diag(mask.astype(np.float32))
    return m @ _tridiag_121(n) @ m @ _tridiag_121(n)


@jax.jit
def _blur(grid: Array, depth_limit: Array) -> Array:
    """3-axis x 2-pass 1-2-1/4 blur with reference interior-only writes.

    Channel-major (2, gh, gw, gd) layout. Each axis's two masked passes are
    one precomputed banded matrix (:func:`_blur_matrix`) applied as a
    contraction;
    the off-axis components of the interior mask are diagonal in the other
    axes, so they commute through and are applied once after each
    contraction — algebraically identical to the reference's 6-pass
    pointer walk.

    ``depth_limit`` is the frame's TRUE grid depth (the reference's
    data-dependent sizing, grid.rs:51-54) as a traced scalar; the depth
    axis's interior exclusion sits at ``depth_limit - 1``, not at the
    (possibly padded) static ``gd``, so a padded or bucketed depth axis is
    bitwise-identical to a per-frame-sized grid. The depth-axis matrix
    M T M T is built traced — one (gd, gd) matmul, ~gd^3 FLOPs, negligible
    next to the grid contractions it feeds.
    """
    import numpy as np

    gh, gw, gd = grid.shape[1:]
    m_h = (np.arange(gh) > 0) & (np.arange(gh) < gh - 1)
    m_w = (np.arange(gw) > 0) & (np.arange(gw) < gw - 1)
    m_d = (
        jnp.arange(gd) < jnp.asarray(depth_limit, jnp.int32) - 1
    ).astype(grid.dtype)

    # Each axis's interior mask rides INSIDE its matrix: A_x' = A_x M_x
    # (zeroed columns). Multiplying a term by an exact 0/1 inside the
    # contraction is bitwise-identical to masking the input, the cross-axis
    # mask components commute past the other axes' matrices and collapse by
    # idempotence, and the input-side mask is harmless because the splat
    # coordinate map never reaches the border cells it zeroes — so no
    # full-grid `* interior` pass is needed.
    a_h = jnp.asarray(_blur_matrix(gh, m_h) * m_h[None, :].astype(np.float32))
    a_w = jnp.asarray(_blur_matrix(gw, m_w) * m_w[None, :].astype(np.float32))
    t_d = jnp.asarray(_tridiag_121(gd))
    a_d = (
        m_d[:, None]
        * jnp.matmul(t_d, m_d[:, None] * t_d, precision=MATMUL_PRECISION)
        * m_d[None, :]
    )

    out = grid
    for spec, mat in (
        ("ah,chwd->cawd", a_h),
        ("bw,chwd->chbd", a_w),
        ("kd,chwd->chwk", a_d),
    ):
        out = jnp.einsum(
            spec, mat, out,
            preferred_element_type=jnp.float32,
            precision=MATMUL_PRECISION,
        )
    return out


@jax.jit
def _normalize(grid: Array) -> Array:
    """value /= count, count -> 1 where count > 0 (grid.rs:90-104)."""
    val, cnt = grid[0], grid[1]
    has = cnt > 0
    val = jnp.where(has, val / jnp.where(has, cnt, 1.0), val)
    cnt = jnp.where(has, 1.0, cnt)
    return jnp.stack([val, cnt], axis=0)


@partial(jax.jit, static_argnames=("sigma_space", "sigma_color"))
def _slice(
    grid: Array,
    image: Array,
    color_min: Array,
    sigma_space: float,
    sigma_color: float,
) -> Array:
    """Per-pixel trilinear sample of the value channel (grid.rs:106-162).

    The spatial (y, x) corner indices depend ONLY on the pixel coordinate —
    they are numpy constants, so the 4 spatial corner planes are static
    gathers (compiled copies, not runtime gathers). Only the range (z)
    coordinate is data-dependent; it resolves as a weighted reduction over
    the z axis, which XLA fuses — no per-pixel random gathers at all.
    """
    import numpy as np

    gh, gw, gd = grid.shape[1:]
    h, w = image.shape
    inv_ss = 1.0 / sigma_space
    inv_sc = 1.0 / sigma_color

    def np_axis_indices(coord, n):
        i0 = np.clip(coord.astype(np.int32), 0, n - 1)
        i1 = np.clip((coord + 1.0).astype(np.int32), 0, n - 1)
        alpha = (coord - i0).astype(np.float32)
        return i0, i1, alpha

    rowf = np.arange(h, dtype=np.float32) * np.float32(inv_ss) + _SPACE_PAD
    colf = np.arange(w, dtype=np.float32) * np.float32(inv_ss) + _SPACE_PAD
    y0, y1, ya = np_axis_indices(rowf, gh)  # (h,) numpy constants
    x0, x1, xa = np_axis_indices(colf, gw)  # (w,)

    chan = (
        image.astype(jnp.float32) - color_min.astype(jnp.float32)
    ) * inv_sc + _COLOR_PAD
    z0 = jnp.clip(chan.astype(jnp.int32), 0, gd - 1)
    z1 = jnp.clip((chan + 1.0).astype(jnp.int32), 0, gd - 1)
    za = chan - z0.astype(jnp.float32)

    # Group image rows by their (static) y0 grid row: each group shares its
    # two grid-row planes, so the (h, w, gd) per-pixel corner-plane copies of
    # the naive form shrink to (G, w, gd) built once per group. The x
    # corners fold into the plane via static column gathers; only the z
    # reduction touches per-pixel data and its one-hot weights fuse into
    # the reduce.
    uniq = np.unique(y0)
    slot_of = {int(g): i for i, g in enumerate(uniq)}
    n_groups = len(uniq)
    width = int(np.max(np.bincount([slot_of[int(g)] for g in y0])))
    row_of = np.zeros((n_groups, width), np.int32)
    used = np.zeros((n_groups, width), bool)
    fill = [0] * n_groups
    for r, g in enumerate(y0):
        s = slot_of[int(g)]
        row_of[s, fill[s]] = r
        used[s, fill[s]] = True
        fill[s] += 1
    y1_g = np.clip(uniq + 1, 0, gh - 1)

    val = grid[0]
    wxa = jnp.asarray(xa, jnp.float32)

    def xplane(rows_idx):
        p = val[rows_idx]  # (n_groups, gw, gd) static gather
        return p[:, x0] * (1.0 - wxa)[None, :, None] + p[:, x1] * wxa[None, :, None]

    p0 = xplane(uniq)  # (G, w, gd)
    p1 = xplane(y1_g)

    # Per-pixel tensors in group layout (G, width, w).
    z0g = z0[row_of]
    z1g = z1[row_of]
    zag = za[row_of]
    kk = jnp.arange(gd, dtype=jnp.int32)
    # ONE (G, width, w, gd) multiply+reduce with every 4-D operand generated
    # inline: the z one-hot AND the y-corner mix both live only inside the
    # reduce fusion (einsum/dot_general would materialize ~200 MB operands;
    # using the one-hot twice in separate reduces would too).
    wya = jnp.asarray(ya[row_of], jnp.float32)  # (G, width)
    wz = jnp.where(kk == z0g[..., None], (1.0 - zag)[..., None], 0.0) + jnp.where(
        kk == z1g[..., None], zag[..., None], 0.0
    )
    pmix = (
        p0[:, None] * (1.0 - wya)[..., None, None]
        + p1[:, None] * wya[..., None, None]
    )  # (G, width, w, gd), fused
    out_g = jnp.sum(wz * pmix, axis=-1)  # (G, width, w)

    # Un-group: static scatter of (G*width) slots back to image rows.
    inv = np.zeros(h, np.int32)
    for s in range(n_groups):
        for t in range(width):
            if used[s, t]:
                inv[row_of[s, t]] = s * width + t
    return out_g.reshape(n_groups * width, w)[inv]


def plan_depth_buckets(
    color_min,
    color_max,
    sigma_color: float,
    quantum: int = 16,
) -> list[tuple[int, "np.ndarray", "np.ndarray"]]:
    """Host-side grid-depth bucket plan for a heterogeneous-span frame batch.

    ``color_min``/``color_max`` are per-frame HOST values (the nonzero
    minimum and the maximum, as :meth:`BilateralGrid.from_image` uses).
    Each frame's true grid depth is the reference's per-frame sizing
    (``int((max-min)/sigma_color) + 1 + 2*pad``, grid.rs:51-54, computed
    here in f64 exactly as ``from_image`` does so the traced
    ``depth_limit`` matches it bitwise); frames are grouped by that depth
    rounded up to ``quantum`` so each bucket compiles once.

    Returns ``[(static_grid_depth, frame_indices, true_depth_limits), ...]``
    sorted by depth — feed to :meth:`BilateralFilter.filter_static_buckets`.
    """
    import numpy as np

    cmin = np.asarray(color_min, np.float64).reshape(-1)
    cmax = np.asarray(color_max, np.float64).reshape(-1)
    true_gd = np.array(
        [
            int((hi - lo) / sigma_color) + 1 + 2 * _COLOR_PAD
            for lo, hi in zip(cmin, cmax)
        ],
        np.int32,
    )
    bucket_gd = -(-true_gd // quantum) * quantum
    plan = []
    for g in np.unique(bucket_gd):
        idx = np.nonzero(bucket_gd == g)[0].astype(np.int32)
        plan.append((int(g), idx, true_gd[idx]))
    return plan


@dataclasses.dataclass
class BilateralGrid:
    """Built grid + metadata (mirrors reference ``BilateralGrid``).

    Storage is channel-MAJOR (2, gh, gw, gd) so the range axis is the minor
    dimension of every stage; :attr:`data` exposes the reference's
    (gh, gw, gd, 2) layout.
    """

    data_cm: Array  # (2, gh, gw, gd) f32 — [value, count]
    sigma_space: float
    sigma_color: float
    color_min: Array  # scalar, original dtype
    # True (reference-sized, grid.rs:51-54) grid depth as a traced scalar;
    # positions the blur's top-of-range interior exclusion so a padded or
    # bucketed static depth axis stays bitwise-identical to a per-frame-sized
    # grid. None means "the static axis IS the true depth".
    depth_limit: Array | None = None

    @property
    def data(self) -> Array:
        """Reference-layout (gh, gw, gd, 2) view (grid.rs `Array4`)."""
        return jnp.moveaxis(self.data_cm, 0, -1)

    @classmethod
    def from_image(
        cls,
        image: Array,
        sigma_space: float,
        sigma_color: float,
        pad_depth_to: int = 1,
    ) -> "BilateralGrid":
        image = jnp.asarray(image)
        h, w = image.shape
        gh = int((h - 1) / sigma_space) + 1 + 2 * _SPACE_PAD
        gw = int((w - 1) / sigma_space) + 1 + 2 * _COLOR_PAD
        color_min = jnp.min(image)
        color_max = jnp.max(image)
        diff = float(color_max) - float(color_min)  # host sync, sizes the grid
        true_gd = int(diff / sigma_color) + 1 + 2 * _COLOR_PAD
        gd = true_gd
        if pad_depth_to > 1:
            gd = -(-gd // pad_depth_to) * pad_depth_to
        data = _splat(image, color_min, (gh, gw, gd), sigma_space, sigma_color)
        return cls(
            data, sigma_space, sigma_color, color_min,
            depth_limit=jnp.int32(true_gd),
        )

    @classmethod
    def from_image_static(
        cls,
        image: Array,
        color_min: Array,
        grid_depth: int,
        sigma_space: float,
        sigma_color: float,
        depth_limit: Array | None = None,
    ) -> "BilateralGrid":
        """Jit-safe grid build with a CALLER-FIXED depth-axis size.

        The reference sizes the range axis from the image's min/max depth
        (grid.rs:51-54) — a data-dependent shape, which :meth:`from_image`
        reproduces with a host sync. Under ``jit`` shapes must be static
        (SURVEY §7 hard part 2), so here the caller supplies ``grid_depth``
        (≥ (max−min)/σc + 1 + 2·pad; values above the true range only waste
        memory) and a traced ``color_min``. For bitwise parity with the
        reference's per-frame sizing also pass ``depth_limit`` — the frame's
        TRUE grid depth as a traced scalar (``_blur`` positions its
        top-of-range interior exclusion there); without it the exclusion
        sits at the padded top, which can differ at max-depth pixels.
        """
        image = jnp.asarray(image)
        h, w = image.shape
        gh = int((h - 1) / sigma_space) + 1 + 2 * _SPACE_PAD
        gw = int((w - 1) / sigma_space) + 1 + 2 * _COLOR_PAD
        data = _splat(
            image, color_min, (gh, gw, int(grid_depth)), sigma_space, sigma_color
        )
        return cls(data, sigma_space, sigma_color, color_min, depth_limit)

    @property
    def dim(self) -> tuple[int, int, int, int]:
        c, gh, gw, gd = self.data_cm.shape
        return (gh, gw, gd, c)

    def convolve(self) -> "BilateralGrid":
        limit = self.depth_limit
        if limit is None:
            limit = jnp.int32(self.data_cm.shape[3])
        return dataclasses.replace(self, data_cm=_blur(self.data_cm, limit))

    def normalize(self) -> "BilateralGrid":
        return dataclasses.replace(self, data_cm=_normalize(self.data_cm))

    def slice(self, image: Array) -> Array:
        """Sample back to image space; returns the image's dtype (truncating
        cast, like the reference's ``num::cast``)."""
        image = jnp.asarray(image)
        value = _slice(
            self.data_cm, image, self.color_min, self.sigma_space, self.sigma_color
        )
        return value.astype(image.dtype)


@dataclasses.dataclass(frozen=True)
class BilateralFilter:
    """Depth filter front-end (reference edge_aware_filter.rs:12-56 defaults)."""

    sigma_space: float = 4.50000000225
    sigma_color: float = 29.9999880000072
    # jit-cache friendliness: depth-axis quantum for the data-dependent grid.
    pad_depth_to: int = 16

    def filter(self, image: Array) -> Array:
        grid = BilateralGrid.from_image(
            image, self.sigma_space, self.sigma_color, self.pad_depth_to
        )
        return grid.convolve().normalize().slice(image)

    def filter_static(
        self,
        image: Array,
        color_min: Array,
        grid_depth: int,
        depth_limit: Array | None = None,
    ) -> Array:
        """Jit-safe :meth:`filter` with caller-fixed grid depth (see
        :meth:`BilateralGrid.from_image_static`)."""
        grid = BilateralGrid.from_image_static(
            image, color_min, grid_depth, self.sigma_space, self.sigma_color,
            depth_limit,
        )
        return grid.convolve().normalize().slice(image)

    def filter_static_buckets(
        self,
        images: Array,
        color_min: Array,
        plan: list[tuple[int, "np.ndarray", "np.ndarray"]],
    ) -> Array:
        """Batch frames with HETEROGENEOUS depth spans.

        The grid's depth axis is a static shape under ``jit``, but the
        reference sizes it per frame (grid.rs:51-54) — so one static axis sized for
        the union span explodes on mixed-scale series (sample1+sample2 would
        need gd~1074: a 20 GB intermediate at batch 65). Instead the caller
        plans gd BUCKETS on the host (:func:`plan_depth_buckets`) and this
        runs one :meth:`filter_static_batched` per bucket — static index
        gathers, jit-safe — with each frame's traced ``depth_limit``
        positioning the blur exclusion at its TRUE grid depth, so every
        frame's output is bitwise-identical to its own per-frame-sized
        filter. Per-bucket sub-chunks bound peak grid memory.

        ``images``: (B, H, W); ``color_min``: (B,) traced.
        """
        import numpy as np

        b = images.shape[0]
        order = np.concatenate(
            [np.asarray(idx, np.int64) for _, idx, _ in plan] or [np.zeros(0, np.int64)]
        )
        if not np.array_equal(np.sort(order), np.arange(b)):
            raise ValueError(
                f"the depth-bucket plan must cover each of the {b} frames "
                "exactly once"
            )
        chunks: list[tuple["np.ndarray", Array]] = []
        for grid_depth, idx, limits in plan:
            # Frames per call at this depth: bounds the live splat/blur/slice
            # buffers, which grow linearly with the grid depth.
            step = max(1, 5184 // int(grid_depth))
            for s in range(0, len(idx), step):
                sub = idx[s : s + step]
                out = self.filter_static_batched(
                    images[sub],
                    color_min[sub],
                    grid_depth,
                    jnp.asarray(limits[s : s + step], jnp.int32),
                )
                chunks.append((sub, out))
        inv = np.empty(b, np.int64)
        inv[order] = np.arange(b)
        return jnp.concatenate([out for _, out in chunks], axis=0)[inv]

    def filter_static_batched(
        self,
        images: Array,  # (B, H, W)
        color_min: Array,  # (B,)
        grid_depth: int,
        depth_limit: Array | None = None,  # (B,) or None
    ) -> Array:
        """Batched :meth:`filter_static` at ONE static grid depth: every
        stage vmaps over the frames."""
        if depth_limit is None:
            depth_limit = jnp.full(
                (images.shape[0],), grid_depth, jnp.int32
            )

        def pre(im, cm, dl):
            g = BilateralGrid.from_image_static(
                im, cm, grid_depth, self.sigma_space, self.sigma_color, dl
            )
            return g.convolve().normalize().data_cm

        grids = jax.vmap(pre)(images, color_min, depth_limit)
        out = jax.vmap(
            lambda g, d, cm: _slice(g, d, cm, self.sigma_space, self.sigma_color)
        )(grids, images, color_min)
        return out.astype(images.dtype)

    def scale_down(self, image: Array) -> Array:
        """Filter then stride-2 decimate (edge_aware_filter.rs:137-147)."""
        from align3d_tpu.image import _decimate2

        filtered = self.filter(image)
        h, w = filtered.shape
        return _decimate2(filtered, h // 2, w // 2)
