"""chip_smoke.py's contract where there is no GPU: it refuses, prints no
result line, and its result line has the agreed format."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SCRIPT = os.path.join(_REPO, "chip_smoke.py")


def _run(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "chip_smoke.py"), *args],
        cwd=cwd,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )


@pytest.mark.parametrize("args", [(), ("--multi",)], ids=["one-card", "multi"])
def test_refuses_without_gpu(args):
    out = _run(_REPO, *args)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_refuses_outside_the_repository(tmp_path):
    shutil.copy(_SCRIPT, tmp_path / "chip_smoke.py")
    out = _run(str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_format(count):
    sys.path.insert(0, _REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(_REPO)
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    line = chip_smoke.result_line([dev] * count)
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count},
    }
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        f'"kind": "NVIDIA H100 80GB HBM3", "count": {count}}}}}'
    )


@pytest.mark.parametrize(
    "pair,same", [(0, True), (29, True), (30, False), (45, True), (59, False), (63, True)]
)
def test_offline_pairs_that_join_two_fixtures(pair, same):
    """Phase (b) holds the two pairs that join sample1 and sample2 frames to
    finiteness only; every other pair of the 65-frame series is compared."""
    sys.path.insert(0, _REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(_REPO)
    assert chip_smoke.frames_same_fixture(pair) is same
