"""Multi-host (multi-process) runtime entry for distributed odometry.

The reference is strictly single-process (SURVEY §2.6: no MPI/NCCL/sockets
anywhere); this module is the beyond-reference scale-out entry the BASELINE
north star asks for. Shape:

* :func:`initialize` wraps ``jax.distributed.initialize`` — each host joins
  the coordination service, after which ``jax.devices()`` is the GLOBAL
  device list and every mesh built from it spans hosts. Collectives compiled
  by XLA ride NVLink/NCCL between GPUs and the network across hosts; on the CPU backend
  (the CI / test harness) they ride Gloo over localhost.
* :func:`global_mesh` builds the 1-D data-parallel mesh over all global
  devices — the same axis name the single-process paths in
  :mod:`align3d_tpu.parallel.batch` / ``pose_graph`` / ``sequence`` use, so
  a sharded computation is *identical* code single- or multi-host.
* :func:`host_local_batch` places each process's slice of a globally-batched
  array into the global sharded array (``jax.make_array_from_process_local_
  data``), which is how per-host dataset shards feed one global computation.

There is no reference counterpart to cite: ``src/icp/image_icp.rs:96`` is a
rayon thread pool, the closest the reference gets to parallel execution.

Launch recipe (2 hosts):

    # host 0                                   # host 1
    initialize("host0:1234", 2, 0)             initialize("host0:1234", 2, 1)
    mesh = global_mesh()                       mesh = global_mesh()
    ... identical SPMD program on both ...

``tools/run_multiprocess.py`` drives exactly this on one machine with two
CPU processes (4 virtual devices each) and asserts parity with the
single-process result; ``tests/test_multihost.py`` runs it in CI.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from align3d_tpu.parallel.batch import BATCH_AXIS

Array = jax.Array


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Sequence[int]] = None,
) -> None:
    """Join the multi-process runtime (no-op for single-process runs).

    Arguments default from the standard env vars
    (``JAX_COORDINATOR_ADDRESS``/``JAX_NUM_PROCESSES``/``JAX_PROCESS_ID``) so
    launchers can configure purely through the environment. Must run before
    any computation creates the backend client.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None or (num_processes or 1) <= 1:
        return  # single-process: nothing to join
    jax.distributed.initialize(
        coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def global_mesh(axis_name: str = BATCH_AXIS) -> Mesh:
    """1-D mesh over ALL global devices (spans hosts after initialize)."""
    return Mesh(np.asarray(jax.devices()), (axis_name,))


def host_local_batch(
    mesh: Mesh, local_data: np.ndarray, axis_name: str = BATCH_AXIS
) -> Array:
    """Assemble a globally-sharded batch from this process's local slice.

    ``local_data``'s leading axis is this host's share; the global array's
    leading axis is ``num_processes`` times larger, sharded over ``mesh``'s
    ``axis_name``. Single-process meshes pass through unchanged.
    """
    sharding = NamedSharding(mesh, P(axis_name))
    n_proc = jax.process_count()
    global_shape = (local_data.shape[0] * n_proc,) + tuple(local_data.shape[1:])
    return jax.make_array_from_process_local_data(
        sharding, np.asarray(local_data), global_shape
    )


def replicate(mesh: Mesh, value) -> Array:
    """Replicate a host-local value across the global mesh."""
    import jax.numpy as jnp

    return jax.device_put(
        jnp.asarray(value), NamedSharding(mesh, P())
    )
