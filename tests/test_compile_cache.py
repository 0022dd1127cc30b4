"""Placement of JAX's persistent compilation cache (config.enable_compile_cache)."""

import os
import subprocess
import sys

import pytest

from align3d_tpu import config

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code, env_dir=None, **extra_env):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", **extra_env)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = str(env_dir)
    out = subprocess.run(
        [sys.executable, "-c", code],
        env=env,
        cwd=_REPO,
        capture_output=True,
        text=True,
        timeout=120,
        check=True,
    )
    return out.stdout.split()


_PRINT_DIRS = (
    "import jax\n"
    "from align3d_tpu import config\n"
    "print(config.enable_compile_cache())\n"
    "print(jax.config.jax_compilation_cache_dir)\n"
)


@pytest.mark.parametrize("env_set", [True, False], ids=["env-set", "env-unset"])
def test_cache_directory(tmp_path, env_set):
    """With JAX_COMPILATION_CACHE_DIR set the cache is there; unset, it is
    the fixed directory at the checkout root."""
    expected = str(tmp_path / "cache") if env_set else config.COMPILE_CACHE_DIR
    got = _run(_PRINT_DIRS, tmp_path / "cache" if env_set else None)
    assert got == [expected, expected]
    assert os.path.dirname(config.COMPILE_CACHE_DIR) == _REPO


def test_compiled_programs_land_in_env_dir(tmp_path):
    cache = tmp_path / "cache"
    code = (
        "import jax, jax.numpy as jnp\n"
        "from align3d_tpu import config\n"
        "config.enable_compile_cache()\n"
        "jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(8)).block_until_ready()\n"
    )
    _run(
        code,
        cache,
        JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
        JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0",
    )
    assert cache.is_dir() and any(cache.iterdir())
