"""ICP parameter sets (reference ``src/icp/icp_params.rs``).

Frozen dataclasses — hashable, so they are static under ``jit`` and each
parameter set compiles once. Defaults replicate the reference exactly (these
numbers are reproducibility-critical: they produced the published ATE).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterator


@dataclasses.dataclass(frozen=True)
class IcpParams:
    """Per-level knobs (icp_params.rs:8-43)."""

    max_iterations: int = 15
    weight: float = 1.0
    color_weight: float = 0.1
    max_point_to_plane_distance: float = 0.1
    max_distance: float = 0.5
    max_normal_angle: float = math.radians(18.0)
    max_color_distance: float = 0.25
    # Huber robust weighting — present-but-unwired in the reference
    # (robust_estimator.rs); default off for parity.
    huber_delta: float | None = None
    # Compute engine: "xla" = packed XLA gathers and contractions (runs on
    # every backend; the reference the tests hold the kernel to); "fused" =
    # the fused Pallas kernel (align3d_tpu/ops/icp_fused.py), which compiles
    # only for an NVIDIA GPU. Both associate exactly.
    engine: str = "xla"
    # "fused" engine only: run the kernel in the Pallas interpreter. Tests
    # set it to exercise the kernel on the CPU; nothing else should.
    interpret: bool = False

    def replace(self, **kw) -> "IcpParams":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class MsIcpParams:
    """Per-pyramid-level parameter list, fine -> coarse (icp_params.rs:59-134)."""

    pyramid: tuple[IcpParams, ...]

    @classmethod
    def repeat(cls, levels: int, params: IcpParams) -> "MsIcpParams":
        return cls(tuple(params for _ in range(levels)))

    def customize(self, fn: Callable[[int, IcpParams], IcpParams]) -> "MsIcpParams":
        return MsIcpParams(tuple(fn(i, p) for i, p in enumerate(self.pyramid)))

    @classmethod
    def default(cls) -> "MsIcpParams":
        """3 levels; weight 1.0, color_weight 1.0, max_normal_angle pi/10,
        max_color_distance 2.75, max_distance 0.5; iterations 20/20/30
        fine -> coarse (icp_params.rs:112-134)."""
        base = IcpParams(
            weight=1.0,
            color_weight=1.0,
            max_normal_angle=math.pi / 10.0,
            max_color_distance=2.75,
            max_distance=0.5,
        )
        iters = {0: 20, 1: 20, 2: 30}
        return cls.repeat(3, base).customize(
            lambda i, p: p.replace(max_iterations=iters.get(i, p.max_iterations))
        )

    def __len__(self) -> int:
        return len(self.pyramid)

    def __getitem__(self, i: int) -> IcpParams:
        return self.pyramid[i]

    def __iter__(self) -> Iterator[IcpParams]:
        return iter(self.pyramid)
