"""Device mesh + sharding helpers.

The reference is single-process batch-size-1 (SURVEY §2.5) — the scaling
story here is pure data parallelism: conversation windows are independent,
so a window batch shards over the ``data`` axis and parameters replicate.
The ``model`` axis exists for forward-compat (these models are a few M params,
TP is not warranted) and stays size 1 by default.

All sharding goes through ``jax.jit`` with ``NamedSharding`` constraints —
XLA inserts the collectives (all-reduce of gradients, etc.), which NCCL runs
over NVLink between the cards of a host.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mmla_audio_tpu.core.config import MeshConfig

__all__ = ["make_mesh", "replicated", "batch_sharding", "shard_batch",
           "replicate_tree", "param_shardings", "shard_params",
           "DataParallel"]


def make_mesh(n_data: Optional[int] = None, n_model: Optional[int] = None,
              cfg: MeshConfig = MeshConfig(),
              devices: Optional[Sequence] = None) -> Mesh:
    """Explicit ``n_data``/``n_model`` win; otherwise the cfg's
    data_parallel/model_parallel fields apply (-1 = all devices)."""
    devices = list(devices if devices is not None else jax.devices())
    n_model = cfg.model_parallel if n_model is None else n_model
    n_data = cfg.data_parallel if n_data is None else n_data
    if n_data == -1:
        n_data = len(devices) // n_model
    assert n_data * n_model <= len(devices), (
        f"need {n_data}x{n_model} devices, have {len(devices)}")
    grid = np.array(devices[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(grid, (cfg.data_axis, cfg.model_axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def batch_sharding(mesh: Mesh, axis: Optional[str] = None) -> NamedSharding:
    # the batch axis is the mesh's FIRST axis by construction (make_mesh);
    # a hardcoded "data" literal broke meshes with a renamed data_axis
    return NamedSharding(mesh, P(axis if axis is not None
                                 else mesh.axis_names[0]))


def shard_batch(x, mesh: Mesh):
    return jax.device_put(x, batch_sharding(mesh))


def replicate_tree(tree: Any, mesh: Mesh):
    return jax.device_put(tree, replicated(mesh))


def param_shardings(tree: Any, mesh: Mesh, axis: Optional[str] = None):
    """Tensor-parallel sharding rule for a parameter tree: partition the
    LAST (output/feature) dimension of every >=2-D leaf that divides evenly
    by the model-axis size; replicate everything else (biases, BN
    scale/shift, odd-sized heads).

    This is GSPMD layout-level TP: conv kernels shard on C_out, dense/LSTM
    kernels on their feature dim, and XLA's partitioner inserts the
    collectives (all-gathers on the sharded-contraction boundaries) under
    ``jit``.  Sharding is layout, not algorithm, but it changes reduction
    ORDER: a single step agrees with the replicated layout to f32 ulp-level
    noise (pinned tightly by tests/test_parallel.py), and multi-epoch
    training agrees to ~1e-4 once RMSprop-style preconditioning amplifies
    the drift (pinned by tests/test_parallel_training.py).  For these
    few-M-param models TP is headroom, not a need
    (SURVEY §2.5: the scaling story is data-parallel window batching); the
    rule exists so a pod-scale deployment can spread parameter memory and
    is proven end-to-end by ``__graft_entry__.dryrun_multichip``'s 2-D
    (data x model) mesh leg.
    """
    axis = mesh.axis_names[-1] if axis is None else axis
    n = mesh.shape[axis]

    def rule(x):
        shape = getattr(x, "shape", ())
        if n > 1 and len(shape) >= 2 and shape[-1] % n == 0:
            return NamedSharding(
                mesh, P(*([None] * (len(shape) - 1) + [axis])))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map(rule, tree)


def shard_params(tree: Any, mesh: Mesh, axis: Optional[str] = None):
    """``device_put`` a parameter tree with :func:`param_shardings`."""
    return jax.device_put(tree, param_shardings(tree, mesh, axis))


class DataParallel:
    """Wrap a ``fn(variables/state, *batch_arrays)`` into a data-parallel
    jitted program: first argument replicated, the rest sharded on ``data``.

    Works for inference (``predictor.lower_fn()``) and training steps alike;
    gradients/metrics that contract over the batch come out replicated
    because XLA reduces them over the mesh automatically.
    """

    def __init__(self, fn, mesh: Mesh, donate_state: bool = False):
        self.mesh = mesh
        self.fn = fn
        # Input shardings are committed by device_put in __call__ (arity of
        # *batch varies); jit propagates them and inserts the collectives.
        self._jit = jax.jit(fn, donate_argnums=(0,) if donate_state else ())

    def __call__(self, state, *batch):
        state = replicate_tree(state, self.mesh)
        batch = tuple(shard_batch(b, self.mesh) for b in batch)
        return self._jit(state, *batch)
