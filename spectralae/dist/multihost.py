"""Multi-process (multi-host) runtime: DP/TP spanning hosts.

The reference is a single process on one GPU (SURVEY.md §2.9).  On a GPU
cluster each process drives its local cards and ``jax.distributed``
federates them into one global device set; everything in
:mod:`spectralae.dist.mesh` then works unchanged — ``jax.devices()`` is
global, meshes span hosts, and XLA routes collectives through NCCL.  This
module is the thin host-side glue that the mesh layer needs:

- :func:`init_multihost` — coordinator handshake with an explicit
  ``host:port`` coordinator, world size and process id (nothing on a GPU
  cluster supplies them implicitly; CPU test rigs additionally get the
  gloo collectives backend);
- :func:`local_batch_to_global` — assemble the per-process slice of a
  batch into one globally-sharded array (each host feeds only its own
  frames; no host ever materializes the global batch);
- :func:`is_coordinator` — gate host-side side effects (checkpoint
  writes, logging) to process 0.

Verified end-to-end by ``tests/test_multihost.py``: two OS processes ×
4 virtual CPU devices each run the distributed train step and burst over
one 8-device global mesh and converge identically.
"""

from __future__ import annotations

import jax
import numpy as np

from .mesh import batch_sharding


def init_multihost(coordinator: str, num_processes: int,
                   process_id: int) -> None:
    """Join (or create) the multi-process runtime.

    ``coordinator`` is the ``host:port`` of process 0 (any free port), and
    every process passes the same ``num_processes`` and its own
    ``process_id``.  CPU backends get the gloo cross-process collectives
    implementation.
    """
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:  # older jaxlib without the option
        pass
    try:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    except RuntimeError as e:
        if "already initialized" not in str(e).lower():
            raise


def process_count() -> int:
    return jax.process_count()


def process_index() -> int:
    return jax.process_index()


def is_coordinator() -> bool:
    """True on the process that should perform host-side side effects."""
    return jax.process_index() == 0


def local_batch_to_global(mesh, local_batch: np.ndarray) -> jax.Array:
    """Assemble per-process frames into one batch-sharded global array.

    ``local_batch`` is this process's ``[B_local, D, H, W]`` slice; the
    returned array is ``[B_global, ...]`` sharded over the mesh's 'data'
    axis with every shard resident on the process that produced it
    (``jax.make_array_from_process_local_data`` — no cross-host copy).
    """
    return jax.make_array_from_process_local_data(
        batch_sharding(mesh), np.asarray(local_batch))
