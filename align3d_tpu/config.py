"""Global numeric/runtime configuration.

The reference implementation accumulates Gauss-Newton systems in f32 and
Cholesky-solves the 6x6 system in f64 (`src/optim/gaussnewton.rs:84-93`).
Instead of enabling global x64 (which would risk silent f64 leakage into hot
paths) we keep everything f32 and solve the tiny 6x6 system with Jacobi
preconditioning + one step of iterative refinement
(:func:`align3d_tpu.optim.gauss_newton.solve_spd`), which recovers the
accuracy the reference gets from f64 for these well-scaled systems.

Every float32 contraction in the package passes ``precision=MATMUL_PRECISION``
(full float32). On an NVIDIA GPU a contraction that names no precision may
run in TF32, which keeps about three decimal digits: enough to move the GN
systems, the SE(3) compositions and the filtered depth by more than the
tolerances the CPU and GPU results are held to. The contractions are small
and bandwidth-bound, so full precision costs little. The constant is passed
at each site rather than set as JAX's global default, so importing the
package changes nothing in the caller's own program.

Environment knobs:

* ``ALIGN3D_REF_DATA`` — override path to the test-fixture tree. Used only
  by tests/benchmarks; defaults to the fixtures vendored in-repo under
  ``tests/data`` (MIT, see ``tests/data/README.md``).
* ``JAX_COMPILATION_CACHE_DIR`` — where :func:`enable_compile_cache` keeps
  JAX's persistent compilation cache; unset, it is ``.jax_compilation_cache``
  at the checkout root.
"""

import os

import jax

MATMUL_PRECISION = jax.lax.Precision.HIGHEST

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMPILE_CACHE_DIR = os.path.join(_ROOT, ".jax_compilation_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; return its directory.

    With ``JAX_COMPILATION_CACHE_DIR`` set, JAX already reads it and nothing
    is changed here. Otherwise the cache goes to a fixed directory at the
    checkout root, so that every process of every run finds it again.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)
    return COMPILE_CACHE_DIR


# Default location of the test fixtures (SlamTb sample1/2, bloei.jpg,
# teapot.off/ply): the in-repo vendored copy. Tests skip gracefully when
# absent (e.g. an installed package without the source checkout).
_IN_REPO = os.path.join(_ROOT, "tests", "data")
REF_DATA_DIR = os.environ.get("ALIGN3D_REF_DATA", _IN_REPO)


def ref_data_path(*parts: str) -> str:
    return os.path.join(REF_DATA_DIR, *parts)


def has_ref_data() -> bool:
    return os.path.isdir(REF_DATA_DIR)
