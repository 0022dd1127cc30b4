"""Profiling utilities (SURVEY §5: the reference profiles with criterion +
pprof flamegraphs; the equivalents here are ``jax.profiler`` traces plus
lightweight wall-clock stage timers)."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Iterator

import jax


class StageTimer:
    """Accumulate wall-clock per named pipeline stage.

    >>> timer = StageTimer()
    >>> with timer.stage("preprocess", force=pyr):
    ...     pyr = builder.build(frame)
    >>> timer.report()

    Dispatch is asynchronous: pass the stage's result as ``force`` so the
    stage waits for the device (``block_until_ready``) before it is timed.
    """

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, force=None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if force is not None:
                jax.block_until_ready(force)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            total = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name}: {total * 1000:.1f} ms total, {n} calls, "
                         f"{total / n * 1000:.2f} ms/call")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """``jax.profiler`` trace context — the flamegraph analog. View with
    TensorBoard or Perfetto (the trace directory holds .trace.json.gz)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
