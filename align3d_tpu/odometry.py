"""Frame-to-frame odometry pipeline.

Counterpart of the reference odometry example (``examples/src/bin/odometry.rs``):
per frame, build the RangeImage pyramid, run multiscale ICP against the
previous frame, and accumulate relative poses into a trajectory.

Two drivers:
* :func:`run_odometry` — the sequential reference flow (per-frame jitted
  compute, host loop);
* :func:`odometry_step` (in :mod:`align3d_tpu.parallel.batch`) —
  the throughput path: all adjacent pairs aligned as one batched
  computation, poses composed with a parallel prefix scan.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from align3d_tpu.icp.multiscale import MultiscaleAlign
from align3d_tpu.icp.params import MsIcpParams
from align3d_tpu.metrics import TransformMetrics
from align3d_tpu.range_image import RangeImageBuilder
from align3d_tpu.se3 import Transform
from align3d_tpu.trajectory import Trajectory, TrajectoryBuilder


@dataclasses.dataclass
class OdometryResult:
    trajectory: Trajectory
    metrics: Optional[TransformMetrics]  # vs dataset GT, if available
    seconds_per_frame: float
    residuals: Optional[list] = None  # per-frame best mean-squared residual


def run_odometry(
    dataset,
    range_builder: RangeImageBuilder | None = None,
    icp_params: MsIcpParams | None = None,
    max_frames: int | None = None,
    progress: Callable[[int, int], None] | None = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 10,
) -> OdometryResult:
    """Sequential frame-to-frame odometry (odometry.rs:28-62 flow).

    ``checkpoint_path`` (beyond the reference, SURVEY §5 failure
    robustness): snapshot the in-progress trajectory every
    ``checkpoint_every`` frames and at the end; if the file already exists
    the run RESUMES from its frame cursor — an aborted run re-invoked with
    the same arguments continues where it stopped and produces the same
    trajectory as an uninterrupted one (``tests/test_checkpoint.py``).
    ``residuals`` then covers only the resumed-portion frames.
    """
    import os

    range_builder = range_builder or RangeImageBuilder()
    icp_params = icp_params or MsIcpParams.default()

    if checkpoint_every < 1:
        raise ValueError(
            f"checkpoint_every must be >= 1, got {checkpoint_every}"
        )

    n = len(dataset)
    if max_frames is not None:
        n = min(n, max_frames)

    # Lightweight run identity: dataset identity/length + engine config.
    # Stored in the checkpoint so a resume with a different dataset or ICP
    # configuration errors instead of splicing two unrelated runs. Wrappers
    # (SubsetDataset, PrefetchingDataset) are unwrapped so a resume with a
    # different max_frames — a supported flow — keeps the same identity.
    base = dataset
    while not hasattr(base, "base_dir") and hasattr(base, "dataset"):
        base = base.dataset
    fingerprint = (
        f"{getattr(base, 'base_dir', type(base).__name__)}"
        f"|len={len(base)}|{icp_params!r}"
    )

    start_frame = 1
    traj_builder = TrajectoryBuilder.with_start(Transform.identity(), 0.0)
    if checkpoint_path and os.path.exists(checkpoint_path):
        from align3d_tpu import checkpoint as ckpt

        saved, next_frame = ckpt.load_odometry(
            checkpoint_path, fingerprint=fingerprint
        )
        if next_frame > 1:
            # A checkpoint past the requested length truncates to it (the
            # metrics compare pose-for-pose against gt[:n]).
            saved = saved.slice(0, min(len(saved), n))
            traj_builder = TrajectoryBuilder.from_trajectory(saved)
            start_frame = min(next_frame, n)

    last_pyramid = range_builder.build(dataset.get(start_frame - 1))

    residuals: list = []
    start = time.perf_counter()
    for i in range(start_frame, n):
        current = range_builder.build(dataset.get(i))
        align = MultiscaleAlign(icp_params, last_pyramid)
        transform = align.align(current)
        residuals.append(align.last_residual)
        traj_builder.accumulate(transform, float(i))
        last_pyramid = current
        if checkpoint_path and (i % checkpoint_every == 0 or i == n - 1):
            from align3d_tpu import checkpoint as ckpt

            ckpt.save_odometry(
                checkpoint_path,
                traj_builder.build(),
                i + 1,
                fingerprint=fingerprint,
            )
        if progress is not None:
            progress(i, n - 1)
    elapsed = time.perf_counter() - start

    pred = traj_builder.build()
    metrics = None
    gt = dataset.trajectory()
    if gt is not None:
        gt = gt.slice(0, n).first_frame_at_origin()
        metrics = TransformMetrics.mean_trajectory_error(pred, gt)
    return OdometryResult(
        trajectory=pred,
        metrics=metrics,
        seconds_per_frame=elapsed / max(n - start_frame, 1),
        residuals=residuals,
    )


def refine_with_loop_closures(
    dataset,
    result: OdometryResult,
    range_builder: RangeImageBuilder | None = None,
    icp_params: MsIcpParams | None = None,
    min_separation: int = 10,
    max_translation: float = 0.5,
    max_candidates: int = 16,
    closure_weight: float = 5.0,
    iterations: int = 10,
    mesh=None,
) -> OdometryResult:
    """Global trajectory refinement (beyond the reference, SURVEY phase 5).

    Propose loop-closure candidates from the odometry trajectory (pose
    distance heuristic), measure each candidate's relative pose with
    multiscale ICP seeded from the odometry estimate, and optimize the pose
    graph (odometry chain + closure edges) with distributed Gauss-Newton
    (:mod:`align3d_tpu.parallel.pose_graph`).
    """
    from align3d_tpu.parallel import pose_graph as pg

    range_builder = range_builder or RangeImageBuilder()
    icp_params = icp_params or MsIcpParams.default()
    traj = result.trajectory

    candidates = pg.propose_loop_closures(
        traj,
        min_separation=min_separation,
        max_translation=max_translation,
        max_candidates=max_candidates,
    )
    edges = []
    for i, j in candidates:
        target = range_builder.build(dataset.get(int(i)))
        source = range_builder.build(dataset.get(int(j)))
        align = MultiscaleAlign(icp_params, target)
        initial = traj.get_relative_transform(int(j), int(i))
        z = align.align(source, initial_transform=initial)
        edges.append((int(i), int(j), z, closure_weight))

    refined = pg.refine_trajectory(
        traj, loop_edges=edges, iterations=iterations, mesh=mesh
    )
    metrics = None
    gt = dataset.trajectory()
    if gt is not None:
        gt = gt.slice(0, len(refined)).first_frame_at_origin()
        metrics = TransformMetrics.mean_trajectory_error(refined, gt)
    return OdometryResult(
        trajectory=refined,
        metrics=metrics,
        seconds_per_frame=result.seconds_per_frame,
    )
