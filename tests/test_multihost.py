"""Multi-process (multi-host) runtime tests.

Launches ``tools/run_multiprocess.py`` — two CPU processes x 4 virtual
devices joined via ``jax.distributed.initialize`` into ONE 8-device global
mesh — and asserts the sharded DP-odometry and pose-graph results match the
single-process reference. This is the CI stand-in for a 2-host run; the
communication path it exercises (global mesh spanning processes,
cross-process collectives) is what the network carries between real hosts.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_two_process_parity():
    env = dict(os.environ)
    # The worker processes configure their own platform/devices.
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "run_multiprocess.py")],
        env=env,
        capture_output=True,
        text=True,
        timeout=840,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PARITY OK" in proc.stdout, proc.stdout


def test_initialize_noop_single_process():
    """initialize() without a coordinator is a no-op (single-process path)."""
    from align3d_tpu.parallel import multihost

    multihost.initialize(None, None, None)  # must not raise or reconfigure
    mesh = multihost.global_mesh()
    assert mesh.devices.size >= 1

    import numpy as np

    arr = multihost.host_local_batch(mesh, np.zeros((mesh.devices.size, 3)))
    assert arr.shape == (mesh.devices.size, 3)


@pytest.mark.slow
def test_fault_abort_resume():
    """Failure-recovery drill: worker 1 aborts after the first half; fresh
    processes resume from the checkpoint and the stitched trajectory matches
    the uninterrupted single-process run (SURVEY §5 failure handling)."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [
            sys.executable,
            os.path.join(REPO, "tools", "run_multiprocess.py"),
            "--fault",
        ],
        env=env,
        capture_output=True,
        text=True,
        timeout=840,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "RESUME OK" in proc.stdout, proc.stdout
