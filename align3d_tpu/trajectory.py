"""Camera trajectories.

Counterpart of the reference ``src/trajectory.rs``. A trajectory is a single
batched :class:`~align3d_tpu.se3.Transform` (leading frame axis) plus a
timestamp vector — so every operation (relative transforms, re-basing,
metrics) is a batched array op instead of a Vec loop.

Odometry accumulation supports two modes:
* incremental ``TrajectoryBuilder.accumulate`` matching the reference's
  left-fold ``last = now_to_previous * last`` (src/trajectory.rs:164-168);
* :func:`accumulate_scan`, a parallel prefix over SE(3) composition via
  ``lax.associative_scan`` — the parallel way to turn N relative poses into
  N absolute poses in O(log N) depth (SURVEY.md §5 long-context analog).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from align3d_tpu.config import MATMUL_PRECISION
from align3d_tpu.se3 import Transform

Array = jax.Array


@dataclasses.dataclass
class Trajectory:
    """Pose list: ``camera_to_world`` batched Transform + ``times`` (N,)."""

    camera_to_world: Transform
    times: Array

    def __len__(self) -> int:
        return int(self.times.shape[0])

    def __getitem__(self, idx: int) -> Transform:
        return self.camera_to_world[idx]

    @classmethod
    def empty(cls) -> "Trajectory":
        return cls(
            Transform(jnp.zeros((0, 3, 3)), jnp.zeros((0, 3))), jnp.zeros((0,))
        )

    @classmethod
    def from_list(cls, poses: list[Transform], times=None) -> "Trajectory":
        from align3d_tpu import se3

        if times is None:
            times = jnp.arange(len(poses), dtype=jnp.float32)
        return cls(se3.stack(poses), jnp.asarray(times, jnp.float32))

    def get_relative_transform(self, from_index: int, dest_index: int) -> Transform:
        """``dest^-1 @ from`` (reference src/trajectory.rs:47-53)."""
        return self.camera_to_world[dest_index].inverse() @ self.camera_to_world[from_index]

    def first_frame_at_origin(self) -> "Trajectory":
        """Re-base so pose 0 is identity (src/trajectory.rs:64-78)."""
        if len(self) == 0:
            return self
        first_inv = self.camera_to_world[0].inverse()
        rebased = Transform(
            jnp.einsum("ij,njk->nik", first_inv.rotation, self.camera_to_world.rotation, precision=MATMUL_PRECISION),
            jnp.einsum("ij,nj->ni", first_inv.rotation, self.camera_to_world.translation, precision=MATMUL_PRECISION)
            + first_inv.translation,
        )
        return Trajectory(rebased, self.times)

    def slice(self, start: int, end: int) -> "Trajectory":
        return Trajectory(self.camera_to_world[start:end], self.times[start:end])

    def last(self) -> tuple[Transform, float] | None:
        if len(self) == 0:
            return None
        return self.camera_to_world[-1], float(self.times[-1])

    # -- serialization ---------------------------------------------------
    def to_tum(self) -> str:
        """TUM trajectory format: ``t tx ty tz qx qy qz qw`` per line.

        The reference has no trajectory serialization (SURVEY.md §5
        checkpoint/resume gap); we add the de-facto standard format so
        external tools (evo, TUM scripts) can evaluate our output.
        """
        quats = np.asarray(self.camera_to_world.to_quat())  # (N, 4) wxyz
        trans = np.asarray(self.camera_to_world.translation)
        times = np.asarray(self.times)
        lines = []
        for i in range(len(self)):
            w, x, y, z = quats[i]
            tx, ty, tz = trans[i]
            lines.append(
                f"{times[i]:.6f} {tx:.7f} {ty:.7f} {tz:.7f} {x:.7f} {y:.7f} {z:.7f} {w:.7f}"
            )
        return "\n".join(lines) + "\n"

    @classmethod
    def from_tum(cls, text: str) -> "Trajectory":
        times, poses = [], []
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(tok) for tok in line.split()]
            t, tx, ty, tz, qx, qy, qz, qw = vals[:8]
            times.append(t)
            poses.append(
                Transform.from_quat(
                    jnp.asarray([tx, ty, tz]), jnp.asarray([qw, qx, qy, qz])
                )
            )
        return cls.from_list(poses, jnp.asarray(times, jnp.float32))


class TrajectoryBuilder:
    """Odometry accumulator (reference src/trajectory.rs:131-184).

    Matches the reference's composition order exactly:
    ``last = now_to_previous * last`` — a *left* multiplication fold.
    """

    def __init__(self, start: Transform | None = None, start_time: float = 0.0):
        self._poses: list[Transform] = []
        self._times: list[float] = []
        if start is not None:
            self._poses.append(start)
            self._times.append(start_time)
            self._last = start
        else:
            self._last = Transform.identity()
        self._last_time = start_time

    @classmethod
    def with_start(cls, start: Transform, start_time: float) -> "TrajectoryBuilder":
        return cls(start=start, start_time=start_time)

    @classmethod
    def from_trajectory(cls, traj: "Trajectory") -> "TrajectoryBuilder":
        """Resume accumulation from an existing trajectory (checkpoint
        restore): the fold continues from its last pose."""
        b = cls()
        times = [float(t) for t in traj.times]
        for k in range(len(traj)):
            b._poses.append(traj.camera_to_world[k])
            b._times.append(times[k])
        if b._poses:
            b._last = b._poses[-1]
            b._last_time = b._times[-1]
        return b

    def accumulate(self, now_to_previous: Transform, timestamp: float | None = None):
        self._last = now_to_previous @ self._last
        self._last_time = timestamp if timestamp is not None else self._last_time + 1.0
        self._poses.append(self._last)
        self._times.append(self._last_time)

    def current_camera_to_world(self) -> Transform | None:
        return self._poses[-1] if self._poses else None

    def build(self) -> Trajectory:
        if not self._poses:
            return Trajectory.empty()
        return Trajectory.from_list(self._poses, jnp.asarray(self._times, jnp.float32))


def accumulate_scan(
    relative: Transform, start: Transform | None = None, times: Array | None = None
) -> Trajectory:
    """Parallel-prefix odometry accumulation.

    Given relative poses ``T_i`` (batched Transform, frame axis N) produces
    absolute poses ``P_i = T_i @ T_{i-1} @ ... @ T_1 @ start`` — the same
    left-fold as :meth:`TrajectoryBuilder.accumulate` but computed with
    ``lax.associative_scan`` (log-depth). The returned
    trajectory includes the start pose, so it has N+1 entries.
    """
    n = relative.rotation.shape[0]
    start = start if start is not None else Transform.identity()

    def combine(a, b):
        # b is "later": result = b @ a (matrix product order).
        rot = jnp.einsum("...ij,...jk->...ik", b[0], a[0], precision=MATMUL_PRECISION)
        t = jnp.einsum("...ij,...j->...i", b[0], a[1], precision=MATMUL_PRECISION) + b[1]
        return rot, t

    rots, trans = jax.lax.associative_scan(
        combine, (relative.rotation, relative.translation), axis=0
    )
    # Apply to the start pose: P_i = scan_i @ start.
    abs_rot = jnp.einsum("nij,jk->nik", rots, start.rotation, precision=MATMUL_PRECISION)
    abs_t = jnp.einsum("nij,j->ni", rots, start.translation, precision=MATMUL_PRECISION) + trans
    all_rot = jnp.concatenate([start.rotation[None], abs_rot], axis=0)
    all_t = jnp.concatenate([start.translation[None], abs_t], axis=0)
    if times is None:
        times = jnp.arange(n + 1, dtype=jnp.float32)
    return Trajectory(Transform(all_rot, all_t), times)
