"""Shared timing harness for the benchmarks.

Every benchmark runs on an NVIDIA GPU and refuses any other platform: a
time taken on the CPU backend says nothing about the card. Each timed
window is one call of a compiled function that ends in
``block_until_ready``; the first calls (compile and warm-up) are reported
apart from the windows. Results are medians with their sample count.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def gpu_name_and_power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            timeout=30,
            check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.strip().splitlines()[0] if out.strip() else "nvidia-smi printed nothing"


def require_gpu():
    """Turn on the compile cache and return ``jax`` once the first device is
    a GPU; exit with status 2 otherwise. Prints the device on stdout."""
    import jax

    from align3d_tpu.config import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"refusing to time on platform {dev.platform!r}: an NVIDIA GPU is required")
        sys.exit(2)
    cache = enable_compile_cache()
    print(f"card: {gpu_name_and_power_limit()}", flush=True)
    print(
        f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())} compile_cache={cache}",
        flush=True,
    )
    return jax


def time_call(fn, *args, windows: int = 10, warmup: int = 2) -> dict:
    """Median wall time of ``fn(*args)`` over ``windows`` calls, each ending
    in ``block_until_ready``. The first call (compile) and the warm-up calls
    are timed apart."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(windows):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        samples.append((time.perf_counter() - t0) * 1000.0)
    return {
        "median_ms": statistics.median(samples),
        "min_ms": min(samples),
        "max_ms": max(samples),
        "n": len(samples),
        "first_call_s": first,
    }


def step_ms(step_fn, init_carry, steps: int = 10, windows: int = 5) -> dict:
    """``step_fn(k, carry) -> carry`` chained ``steps`` times inside one
    jitted loop (the carry keeps every step live); returns :func:`time_call`
    of the loop with the times divided by ``steps``."""
    import jax

    @functools.partial(jax.jit, static_argnames=("reps",))
    def run(carry, reps):
        return jax.lax.fori_loop(0, reps, step_fn, carry)

    stats = time_call(functools.partial(run, reps=steps), init_carry, windows=windows)
    for k in ("median_ms", "min_ms", "max_ms"):
        stats[k] /= steps
    return stats


def emit(metric: str, stats: dict, unit: str = "ms", **extra):
    import jax

    dev = jax.devices()[0]
    print(
        json.dumps(
            {
                "metric": metric,
                "value": stats["median_ms"],
                "unit": unit,
                "n": stats["n"],
                "min": stats["min_ms"],
                "max": stats["max_ms"],
                "device": {
                    "platform": dev.platform,
                    "kind": dev.device_kind,
                    "count": len(jax.devices()),
                },
                **extra,
            }
        ),
        flush=True,
    )
