"""Training loops: jitted steps, scanned epochs, Keras-parity callbacks.

Two execution styles:

* ``Trainer.fit`` — host epoch loop around a jitted per-epoch ``lax.scan``
  over batches (shuffle via device PRNG permutation, partial final batch
  handled by loss masking, exactly like Keras' non-dropping batching).
  Early stopping on val_loss (patience, no restore — Keras default) and an
  epoch-indexed LR schedule hook reproduce the reference's callback set
  (`overlap_detector.py:405-421`).

* ``fit_on_device`` (see ``transfer.py``) — the whole multi-epoch fine-tune
  as ONE compiled program for small enrolled corpora: the 500-epoch
  registration loop that dominates reference latency becomes a single
  ``lax.scan`` on the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

__all__ = ["TrainState", "Trainer", "pad_to_batches"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TrainState:
    params: Any
    batch_stats: Any
    opt_state: Any
    step: jnp.ndarray

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


def pad_to_batches(x: np.ndarray, y: np.ndarray, batch_size: int):
    """Pad (x, y) with zero rows to a multiple of batch_size; returns
    (x, y, mask) where mask marks real rows.  Keeps shapes static for scan."""
    n = x.shape[0]
    n_batches = -(-n // batch_size)
    total = n_batches * batch_size
    mask = np.zeros(total, np.float32)
    mask[:n] = 1.0
    if total > n:
        x = np.concatenate([x, np.zeros((total - n,) + x.shape[1:], x.dtype)])
        y = np.concatenate([y, np.zeros((total - n,) + y.shape[1:], y.dtype)])
    return x, y, mask


class Trainer:
    """Generic trainer for a model with (params, batch_stats).

    ``loss_fn(logits, y) -> per-example loss``;  the step adds
    ``extra_penalty_fn(params)`` (e.g. l2 kernel regularizers) to the batch
    mean, matching Keras' loss = data_loss + sum(regularizers).

    Known divergence: partial final batches are zero-padded + loss-masked
    (static shapes), so BatchNorm batch statistics see the padding rows,
    where Keras simply runs a smaller batch.  Negligible for the momentum-
    0.99 running stats unless most batches are partial.
    """

    def __init__(self, model, tx: optax.GradientTransformation,
                 loss_fn: Callable, *,
                 extra_penalty_fn: Optional[Callable] = None,
                 train_flag: bool = True):
        self.model = model
        self.tx = tx
        self.loss_fn = loss_fn
        self.extra_penalty_fn = extra_penalty_fn
        self.train_flag = train_flag
        self._epoch_jit = jax.jit(self._run_epoch, static_argnames=("batch_size",))
        self._eval_jit = jax.jit(self._eval)
        self._eval_scan_jit = jax.jit(self._eval_scan)

    # -- state ---------------------------------------------------------------
    def init_state(self, variables) -> TrainState:
        params = variables["params"]
        batch_stats = variables.get("batch_stats", {})
        return TrainState(params=params, batch_stats=batch_stats,
                          opt_state=self.tx.init(params),
                          step=jnp.zeros((), jnp.int32))

    def variables_of(self, state: TrainState) -> Dict[str, Any]:
        v = {"params": state.params}
        if state.batch_stats:
            v["batch_stats"] = state.batch_stats
        return v

    # -- steps ---------------------------------------------------------------
    def _loss_and_updates(self, params, batch_stats, x, y, mask, rng):
        variables = {"params": params}
        mutable = []
        if batch_stats:
            variables["batch_stats"] = batch_stats
            mutable = ["batch_stats"] if self.train_flag else []
        kwargs = {}
        if self.train_flag:
            kwargs = {"train": True, "rngs": {"dropout": rng}}
        if mutable:
            logits, updates = self.model.apply(variables, x, mutable=mutable,
                                               **kwargs)
            new_stats = updates["batch_stats"]
        else:
            logits = self.model.apply(variables, x, **kwargs)
            new_stats = batch_stats
        per_ex = self.loss_fn(logits, y)
        denom = jnp.maximum(jnp.sum(mask), 1.0)
        loss = jnp.sum(per_ex * mask) / denom
        if self.extra_penalty_fn is not None:
            loss = loss + self.extra_penalty_fn(params)
        correct = (jnp.argmax(logits, -1) == jnp.argmax(y, -1)).astype(jnp.float32)
        acc = jnp.sum(correct * mask) / denom
        return loss, (new_stats, acc)

    def _train_step(self, state: TrainState, x, y, mask, rng):
        grad_fn = jax.value_and_grad(self._loss_and_updates, has_aux=True)
        (loss, (new_stats, acc)), grads = grad_fn(
            state.params, state.batch_stats, x, y, mask, rng)
        updates, new_opt = self.tx.update(grads, state.opt_state, state.params)
        new_params = optax.apply_updates(state.params, updates)
        return TrainState(new_params, new_stats, new_opt, state.step + 1), loss, acc

    def _run_epoch(self, state: TrainState, x, y, mask, rng, batch_size: int):
        """One epoch: shuffle, scan over batches."""
        n = x.shape[0]
        perm_rng, drop_rng = jax.random.split(rng)
        perm = jax.random.permutation(perm_rng, n)
        xs = x[perm].reshape((-1, batch_size) + x.shape[1:])
        ys = y[perm].reshape((-1, batch_size) + y.shape[1:])
        ms = mask[perm].reshape((-1, batch_size))
        drop_rngs = jax.random.split(drop_rng, xs.shape[0])

        def body(carry, inp):
            st = carry
            bx, by, bm, brng = inp
            st, loss, acc = self._train_step(st, bx, by, bm, brng)
            return st, (loss, acc)

        state, (losses, accs) = jax.lax.scan(body, state, (xs, ys, ms, drop_rngs))
        return state, jnp.mean(losses), jnp.mean(accs)

    def _eval(self, params, batch_stats, x, y, mask):
        variables = {"params": params}
        if batch_stats:
            variables["batch_stats"] = batch_stats
        logits = self.model.apply(variables, x)
        per_ex = self.loss_fn(logits, y)
        denom = jnp.maximum(jnp.sum(mask), 1.0)
        loss = jnp.sum(per_ex * mask) / denom
        correct = (jnp.argmax(logits, -1) == jnp.argmax(y, -1)).astype(jnp.float32)
        return loss, jnp.sum(correct * mask) / denom

    def _eval_scan(self, params, batch_stats, xs, ys, ms):
        """Chunked eval: one compiled program scans (n_chunks, B, ...) and
        accumulates masked sums, so activation memory is one chunk's, not the
        whole split's (a 2,520-image overlap val fold full-batch allocates
        ~8 GB of stage-0 feature maps alone — OOM on one chip)."""
        def body(carry, inp):
            bx, by, bm = inp
            variables = {"params": params}
            if batch_stats:
                variables["batch_stats"] = batch_stats
            logits = self.model.apply(variables, bx)
            per_ex = self.loss_fn(logits, by)
            correct = (jnp.argmax(logits, -1) == jnp.argmax(by, -1)
                       ).astype(jnp.float32)
            ls, cs, ds = carry
            return (ls + jnp.sum(per_ex * bm), cs + jnp.sum(correct * bm),
                    ds + jnp.sum(bm)), None

        init = (jnp.zeros(()), jnp.zeros(()), jnp.zeros(()))
        (ls, cs, ds), _ = jax.lax.scan(body, init, (xs, ys, ms))
        denom = jnp.maximum(ds, 1.0)
        return ls / denom, cs / denom

    # -- public API ------------------------------------------------------------
    def evaluate(self, state: TrainState, x, y, batch_size: Optional[int] = None):
        """Eval loss/accuracy.  ``batch_size`` bounds per-program activation
        memory via a scanned chunked pass; None (default) evaluates the whole
        split as one batch (bit-identical to the historical path)."""
        x = jnp.asarray(x)
        y = jnp.asarray(y)
        n = x.shape[0]
        if batch_size is not None and n > batch_size:
            pad = (-n) % batch_size
            mask = (jnp.arange(n + pad) < n).astype(jnp.float32)
            if pad:
                x = jnp.concatenate(
                    [x, jnp.zeros((pad,) + x.shape[1:], x.dtype)])
                y = jnp.concatenate(
                    [y, jnp.zeros((pad,) + y.shape[1:], y.dtype)])
            xs = x.reshape((-1, batch_size) + x.shape[1:])
            ys = y.reshape((-1, batch_size) + y.shape[1:])
            ms = mask.reshape((-1, batch_size))
            loss, acc = self._eval_scan_jit(state.params, state.batch_stats,
                                            xs, ys, ms)
            return float(loss), float(acc)
        mask = jnp.ones(n, jnp.float32)
        loss, acc = self._eval_jit(state.params, state.batch_stats, x, y, mask)
        return float(loss), float(acc)

    def fit(self, state: TrainState, x_train, y_train, *, epochs: int,
            batch_size: int, x_val=None, y_val=None,
            early_stop_patience: Optional[int] = None,
            lr_schedule_epoch: Optional[Callable[[int], float]] = None,
            rng: Optional[jax.Array] = None,
            mesh=None,
            verbose: bool = False):
        """Keras-flavored fit.  Returns (state, history dict).

        ``mesh``: a ``jax.sharding.Mesh`` — every batch shards across the
        first (data) axis inside the scanned epoch and XLA all-reduces the
        gradients across devices.  Parameters replicate, unless the mesh has a
        distinct trailing model axis of size > 1, in which case the
        parameter tree (and its optimizer-state mirrors) spreads over it
        (``parallel.param_shardings``).  ``batch_size`` is global and must
        divide by the mesh's data-axis size.
        """
        rng = rng if rng is not None else jax.random.PRNGKey(0)
        n_train = int(np.shape(x_train)[0])
        if isinstance(x_train, jax.Array):
            # device-resident corpus (e.g. featurized on device): pad and
            # mask on device — np.asarray on a jax.Array would fetch the
            # whole corpus back to host.  Keyed on x alone: labels are tiny
            # and commonly built host-side, so np labels must not silently
            # push the big tensor down the host path.
            pad = (-n_train) % batch_size
            xp, yp = x_train, jnp.asarray(y_train)
            if pad:
                xp = jnp.concatenate(
                    [xp, jnp.zeros((pad,) + xp.shape[1:], xp.dtype)])
                yp = jnp.concatenate(
                    [yp, jnp.zeros((pad,) + yp.shape[1:], yp.dtype)])
            maskp = (jnp.arange(n_train + pad) < n_train).astype(jnp.float32)
        else:
            xp, yp, maskp = pad_to_batches(np.asarray(x_train),
                                           np.asarray(y_train), batch_size)
            xp, yp, maskp = jnp.asarray(xp), jnp.asarray(yp), jnp.asarray(maskp)
        if x_val is not None:
            # upload the validation split once, not once per epoch
            x_val, y_val = jnp.asarray(x_val), jnp.asarray(y_val)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            data_axis = mesh.axis_names[0]   # batch axis by construction
            n_data = mesh.shape[data_axis]
            assert batch_size % n_data == 0, (batch_size, n_data)
            rep = NamedSharding(mesh, P())
            if (len(mesh.axis_names) >= 2
                    and mesh.axis_names[-1] != data_axis
                    and mesh.shape[mesh.axis_names[-1]] > 1):
                # 2-D (data x model) mesh: spread parameters (and their
                # optimizer-state mirrors) over the model axis instead of
                # replicating — param_shardings is a per-leaf shape rule, so
                # applying it to the whole TrainState shards every >=2-D
                # kernel and replicates batch stats / biases / counters.
                # (The axis-count/name guard keeps a 1-D data-only mesh on
                # the replicated path: its last axis IS the data axis, and
                # sharding parameters over it would contradict this
                # docstring and add per-step collectives.)
                # Layout-level only: results agree with the replicated run
                # to accumulated-reduction precision (~1e-4 over epochs —
                # tests/test_parallel_training.py::
                # test_mesh_fit_2d_model_axis_matches_replicated pins it;
                # single-step equality is pinned tightly in
                # tests/test_parallel.py).
                from mmla_audio_tpu.parallel import param_shardings

                state = jax.device_put(state, param_shardings(state, mesh))
            else:
                state = jax.device_put(state, rep)
            # the scan reshapes to (n_batches, batch, ...): shard dim 1
            xp = jax.device_put(xp, NamedSharding(mesh, P(data_axis)))
            yp = jax.device_put(yp, NamedSharding(mesh, P(data_axis)))
            maskp = jax.device_put(maskp, NamedSharding(mesh, P(data_axis)))
        history = {"loss": [], "acc": [], "val_loss": [], "val_acc": []}
        best_val = np.inf
        patience_left = early_stop_patience
        for epoch in range(epochs):
            if lr_schedule_epoch is not None:
                # epoch-indexed LR emulating the Keras callback: requires the
                # optimizer to be wrapped in optax.inject_hyperparams so the
                # lr is a mutable leaf of opt_state rather than a traced
                # constant.  Silently ignoring the schedule otherwise would
                # train at a fixed lr without any signal — refuse instead.
                hyperparams = getattr(state.opt_state, "hyperparams", None)
                if hyperparams is None or "learning_rate" not in hyperparams:
                    raise ValueError(
                        "lr_schedule_epoch requires an optimizer built with "
                        "optax.inject_hyperparams(...)(learning_rate=...) so "
                        "the learning rate is schedulable; got opt_state of "
                        f"type {type(state.opt_state).__name__}")
                hyperparams["learning_rate"] = jnp.asarray(
                    lr_schedule_epoch(epoch), jnp.float32)
            rng, ep_rng = jax.random.split(rng)
            state, loss, acc = self._epoch_jit(state, xp, yp, maskp, ep_rng,
                                               batch_size=batch_size)
            history["loss"].append(float(loss))
            history["acc"].append(float(acc))
            if x_val is not None:
                vl, va = self.evaluate(state, x_val, y_val)
                history["val_loss"].append(vl)
                history["val_acc"].append(va)
                if verbose:
                    print(f"epoch {epoch}: loss={float(loss):.4f} acc={float(acc):.4f} "
                          f"val_loss={vl:.4f} val_acc={va:.4f}")
                if early_stop_patience is not None:
                    if vl < best_val:
                        best_val, patience_left = vl, early_stop_patience
                    else:
                        patience_left -= 1
                        if patience_left <= 0:
                            break
            elif verbose:
                print(f"epoch {epoch}: loss={float(loss):.4f} acc={float(acc):.4f}")
        return state, history
