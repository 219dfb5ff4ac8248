"""Speaker-registration transfer learning as an on-device program.

Reference flow (`speaker_identification.py:401-503` +
`SpeakerIdentification/scripts/record_on_pc.py:340-346`): slice the TIMIT
base model at ``layers[-2]`` (the post-BiLSTM dropout), freeze it, add a
fresh ``Dense(n_speakers, sigmoid)`` head, fit 500 epochs (b16, RMSprop 1e-4)
on enrolled-corpus MFCC windows, then unfreeze everything and fit 20 more
epochs (b8, RMSprop 1e-6); keep retraining from scratch until validation
accuracy >= 0.80.

The 500-epoch loop is the latency bottleneck of registration in the
reference (minutes of Keras fit on batch-16).  Here the *entire two-phase
fine-tune* runs as two compiled ``lax.scan`` programs over epochs — the
enrolled corpus (a few hundred (256, 39) windows) lives on the device for the whole
fine-tune and the host only sees the final params + accuracy.

Behavioral notes preserved from the reference:
  * The trunk is invoked with ``training=False`` in BOTH phases (Keras
    ``sliced_base_model(inputs, training=False)``): BN uses running stats and
    dropout is off, even while phase 2 updates trunk weights.
  * The head uses *sigmoid* activation with categorical crossentropy (Keras
    renormalizes probabilities inside the loss).
  * 70/30 stratified-ish train/validation split, seeded.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple


import jax
import jax.numpy as jnp
import numpy as np
import optax

from mmla_audio_tpu.core.config import SpeakerModelConfig, TransferConfig
from mmla_audio_tpu.models.speaker import SpeakerResBLSTM, l2_penalty
from mmla_audio_tpu.train.losses import keras_categorical_crossentropy
from mmla_audio_tpu.train.optimizers import rmsprop

__all__ = ["TransferLearner", "train_val_split"]


def train_val_split(x: np.ndarray, y: np.ndarray, val_ratio: float, seed: int):
    """Per-class proportional split (sklearn stratified semantics)."""
    rng = np.random.RandomState(seed)
    classes = np.argmax(y, axis=1)
    train_idx, val_idx = [], []
    for c in np.unique(classes):
        idx = np.where(classes == c)[0]
        rng.shuffle(idx)
        if len(idx) == 1:
            # too few windows to split: the lone window serves both sides
            # (the reference's sklearn split would simply error here)
            train_idx.extend(idx)
            val_idx.extend(idx)
            continue
        n_val = min(max(1, int(round(len(idx) * val_ratio))), len(idx) - 1)
        val_idx.extend(idx[:n_val])
        train_idx.extend(idx[n_val:])
    train_idx = np.array(train_idx, dtype=np.int64)
    val_idx = np.array(val_idx, dtype=np.int64)
    rng.shuffle(train_idx)
    rng.shuffle(val_idx)
    return x[train_idx], y[train_idx], x[val_idx], y[val_idx]


class TransferLearner:
    def __init__(self, base_variables: Dict[str, Any],
                 n_speakers: int,
                 model_cfg: SpeakerModelConfig = SpeakerModelConfig(),
                 cfg: TransferConfig = TransferConfig()):
        self.base_variables = base_variables
        self.n_speakers = n_speakers
        self.model_cfg = model_cfg
        self.cfg = cfg
        self.model = SpeakerResBLSTM(model_cfg, head_units=n_speakers)
        self._fit_jit = jax.jit(
            self._two_phase_fit,
            static_argnames=("n1", "b1", "n2", "b2"))

    # -- model pieces -----------------------------------------------------------
    def _init_variables(self, rng) -> Dict[str, Any]:
        """Fresh head + base trunk (the 'slice at layers[-2]' graft)."""
        variables = self.model.init_variables(rng)
        params = dict(variables["params"])
        params["trunk"] = self.base_variables["params"]["trunk"]
        out = {"params": params}
        if "batch_stats" in self.base_variables:
            out["batch_stats"] = self.base_variables["batch_stats"]
        return out

    def _apply(self, variables, x):
        # trunk always in inference mode (see module docstring)
        return self.model.apply(variables, x, train=False)

    def _loss(self, params, batch_stats, x, y, mask):
        variables = {"params": params}
        if batch_stats:
            variables["batch_stats"] = batch_stats
        logits = self._apply(variables, x)
        per_ex = keras_categorical_crossentropy(logits, y, activation="sigmoid")
        denom = jnp.maximum(jnp.sum(mask), 1.0)
        # slicing a Keras model keeps the trunk's kernel_regularizers, so the
        # reference's fine-tune loss still carries the stage-1/2 L2 penalty
        # (speaker_identification.py:176-187 via transfer_learning :401-447);
        # phase-1 trunk grads are zeroed regardless, phase-2's follow it
        return jnp.sum(per_ex * mask) / denom + l2_penalty(params,
                                                           self.model_cfg)

    # -- scanned fit ------------------------------------------------------------
    def _phase(self, params, batch_stats, tx, opt_state, x, y, mask, rng,
               n_epochs: int, batch_size: int, freeze_trunk: bool):
        n = x.shape[0]
        n_batches = n // batch_size

        def epoch_body(carry, ep_rng):
            params, opt_state = carry
            perm = jax.random.permutation(ep_rng, n)
            xs = x[perm][: n_batches * batch_size].reshape(
                (n_batches, batch_size) + x.shape[1:])
            ys = y[perm][: n_batches * batch_size].reshape(
                (n_batches, batch_size) + y.shape[1:])
            ms = mask[perm][: n_batches * batch_size].reshape(
                (n_batches, batch_size))

            def batch_body(carry, inp):
                params, opt_state = carry
                bx, by, bm = inp
                loss, grads = jax.value_and_grad(self._loss)(
                    params, batch_stats, bx, by, bm)
                if freeze_trunk:
                    grads = dict(grads)
                    grads["trunk"] = jax.tree_util.tree_map(
                        jnp.zeros_like, params["trunk"])
                updates, opt_state = tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), loss

            (params, opt_state), losses = jax.lax.scan(
                batch_body, (params, opt_state), (xs, ys, ms))
            return (params, opt_state), jnp.mean(losses)

        ep_rngs = jax.random.split(rng, n_epochs)
        (params, opt_state), losses = jax.lax.scan(
            epoch_body, (params, opt_state), ep_rngs)
        return params, opt_state, losses

    def _two_phase_fit(self, variables, x_tr, y_tr, m_tr, x_val, y_val, rng,
                       n1: int, b1: int, n2: int, b2: int):
        params = variables["params"]
        batch_stats = variables.get("batch_stats", {})
        rng1, rng2 = jax.random.split(rng)

        tx1 = rmsprop(self.cfg.phase1_lr)
        params, _, losses1 = self._phase(
            params, batch_stats, tx1, tx1.init(params), x_tr, y_tr, m_tr,
            rng1, n1, b1, freeze_trunk=True)

        tx2 = rmsprop(self.cfg.phase2_lr)
        params, _, losses2 = self._phase(
            params, batch_stats, tx2, tx2.init(params), x_tr, y_tr, m_tr,
            rng2, n2, b2, freeze_trunk=False)

        v = {"params": params}
        if batch_stats:
            v["batch_stats"] = batch_stats
        logits = self._apply(v, x_val)
        per_ex = keras_categorical_crossentropy(logits, y_val, activation="sigmoid")
        val_loss = jnp.mean(per_ex)
        val_acc = jnp.mean((jnp.argmax(logits, -1) == jnp.argmax(y_val, -1))
                           .astype(jnp.float32))
        return params, val_loss, val_acc, jnp.concatenate([losses1, losses2])

    # -- public -------------------------------------------------------------------
    def fit_once(self, x: np.ndarray, y: np.ndarray, seed: int = 0,
                 epochs_override: Tuple[int, int] | None = None):
        """One two-phase fine-tune.  Returns (variables, val_acc, losses)."""
        cfg = self.cfg
        n1, n2 = epochs_override or (cfg.phase1_epochs, cfg.phase2_epochs)
        x_tr, y_tr, x_val, y_val = train_val_split(
            np.asarray(x, np.float32), np.asarray(y, np.float32), 0.3, seed)
        # pad train set to a multiple of both batch sizes
        import math
        lcm = math.lcm(cfg.phase1_batch, cfg.phase2_batch)
        n = x_tr.shape[0]
        total = max(lcm, -(-n // lcm) * lcm)
        mask = np.zeros(total, np.float32)
        mask[:n] = 1.0
        if total > n:
            x_tr = np.concatenate([x_tr, np.zeros((total - n,) + x_tr.shape[1:],
                                                  np.float32)])
            y_tr = np.concatenate([y_tr, np.zeros((total - n,) + y_tr.shape[1:],
                                                  np.float32)])
        variables = self._init_variables(jax.random.PRNGKey(seed))
        params, val_loss, val_acc, losses = self._fit_jit(
            variables, jnp.asarray(x_tr), jnp.asarray(y_tr), jnp.asarray(mask),
            jnp.asarray(x_val), jnp.asarray(y_val),
            jax.random.PRNGKey(seed + 1),
            n1=n1, b1=cfg.phase1_batch, n2=n2, b2=cfg.phase2_batch)
        out = {"params": params}
        if "batch_stats" in variables:
            out["batch_stats"] = variables["batch_stats"]
        return out, float(val_acc), np.asarray(losses)

    def fit_until_gate(self, x, y, seed: int = 0,
                       epochs_override: Tuple[int, int] | None = None):
        """retrain-until-accuracy>=gate loop (record_on_pc.py:344-346)."""
        best = None
        for round_ in range(self.cfg.max_retrain_rounds):
            variables, acc, losses = self.fit_once(
                x, y, seed=seed + round_, epochs_override=epochs_override)
            if best is None or acc > best[1]:
                best = (variables, acc, losses)
            if acc >= self.cfg.accuracy_gate:
                return variables, acc, losses
        return best
