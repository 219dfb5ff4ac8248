"""Multi-host (multi-process) scaling.

The reference has no distributed execution at all (SURVEY §2.5); its single
loop is one process on one machine.  The deployment story for this
workload is:

- **Within a host:** conversation windows are independent, so batches shard
  over every card's ``data`` axis (``mesh.py``); XLA's collectives (gradient
  all-reduce in training, nothing at all in inference) ride NVLink.
- **Across hosts:** each host process captures / ingests ITS OWN
  conversation streams and contributes a host-local window batch; the global
  array is assembled with ``jax.make_array_from_process_local_data`` so no
  raw audio ever crosses the network.  With pure data parallelism, the only
  cross-host traffic is the parameter/gradient all-reduce during training
  and nothing during serving.

These helpers keep the single-process path (tests, one-chip benches)
identical: ``initialize()`` is a no-op unless process coordination is
configured, and ``host_local_batch_to_global`` degrades to ``shard_batch``.

Typical multi-host entry::

    from mmla_audio_tpu.parallel import distributed as dist
    dist.initialize()                      # env-driven ($JAX_COORDINATOR_ADDRESS)
    mesh = dist.global_mesh()              # all chips across all processes
    xg = dist.host_local_batch_to_global(local_windows, mesh)
    labels, probs = DataParallel(pred.lower_fn(), mesh)(variables, xg, ng)
"""

from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh, PartitionSpec as P

from mmla_audio_tpu.parallel.mesh import batch_sharding, make_mesh, shard_batch

__all__ = ["initialize", "global_mesh", "host_local_batch_to_global",
           "process_info"]

_initialized = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Join (or skip joining) the multi-process runtime.

    With the three arguments, they are passed to
    ``jax.distributed.initialize``.  Without them, ``$JAX_COORDINATOR_ADDRESS``
    names the coordinator and ``jax.distributed.initialize()`` discovers the
    rest from the cluster it runs in.  Single-process runs (no coordinator)
    skip initialization entirely, so the same program works 1-host and
    N-host.  Safe to call more than once.
    """
    global _initialized
    if _initialized:
        return
    explicit = (coordinator_address, num_processes, process_id)
    if any(a is not None for a in explicit) \
            and any(a is None for a in explicit):
        # jax.distributed.initialize requires all three once a coordinator
        # is named; fail here with a clear message instead of deep inside
        raise ValueError(
            "initialize(): coordinator_address, num_processes and "
            f"process_id must be given together, got {explicit!r}")
    if coordinator_address is None:
        import os

        if not os.environ.get("JAX_COORDINATOR_ADDRESS"):
            return                       # single-process: nothing to join
        jax.distributed.initialize()
    else:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    _initialized = True


def process_info() -> tuple[int, int]:
    """(process_index, process_count) of this host."""
    return jax.process_index(), jax.process_count()


def global_mesh(n_model: int = 1) -> Mesh:
    """Mesh over every addressable chip across every process.

    ``jax.devices()`` is globally ordered with each process's chips
    contiguous, so the ``data`` axis groups each host's chips together and
    a host-local batch lands on that host's own chips (no cross-host input
    scatter)."""
    return make_mesh(n_model=n_model, devices=jax.devices())


def host_local_batch_to_global(x, mesh: Mesh):
    """Assemble per-host window batches into one globally-sharded array.

    Each process passes its own ``(B_local, ...)`` batch; the result behaves
    as a ``(num_processes * B_local, ...)`` array sharded over the ``data``
    axis, without any cross-host transfer of the data itself.  In a
    single-process run this is exactly ``shard_batch``.
    """
    if jax.process_count() == 1:
        return shard_batch(x, mesh)
    import numpy as np
    return jax.make_array_from_process_local_data(
        batch_sharding(mesh), np.asarray(x))
