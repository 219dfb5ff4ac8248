"""Overlap-detector training orchestration (the `OverlapDetector` class role).

Covers `overlap_detector.py`'s workflow on device: stratified 5-fold
train/test split (fold 0), class-weight computation, optional image-pyramid
class rebalancing, weighted-CCE Adadelta training with cosine annealing +
early stopping + best checkpointing, continue-training, and evaluation with
a confusion matrix (`evaluation`, :513-543).
"""

from __future__ import annotations


from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from mmla_audio_tpu.core.config import OverlapModelConfig, OverlapTrainConfig
from mmla_audio_tpu.models.overlap import OverlapResBLSTM
from mmla_audio_tpu.ops.image import pyramid_augment
from mmla_audio_tpu.train.checkpoints import BestCheckpointer, load_variables
from mmla_audio_tpu.train.losses import (
    cal_weighted_penalty,
    keras_categorical_crossentropy,
    weighted_categorical_crossentropy,
)
from mmla_audio_tpu.train.optimizers import adadelta
from mmla_audio_tpu.train.schedules import cosine_annealing
from mmla_audio_tpu.train.trainer import Trainer, TrainState

__all__ = ["stratified_kfold_indices", "augment_to_balance", "confusion_matrix",
           "OverlapTrainer"]


def stratified_kfold_indices(labels: np.ndarray, n_splits: int = 5,
                             seed: int = 0, fold: int = 0
                             ) -> Tuple[np.ndarray, np.ndarray]:
    """Literal transcription of sklearn StratifiedKFold(shuffle=True,
    random_state=seed)._make_test_folds, so fold membership matches the
    reference's split exactly (`overlap_detector.py:274-275`, fold 0):
    classes are encoded by first appearance, per-fold allocation comes from
    interleaving the SORTED label vector, and each class's fold vector is
    shuffled with the shared RandomState in encoded-class order.  (An
    earlier round-robin deal produced different memberships and piled every
    class's remainder into the low folds.)"""
    rng = np.random.RandomState(seed)
    y = np.asarray(labels)
    _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_idx, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_idx)
    y_order = np.sort(y_encoded)
    allocation = np.asarray(
        [np.bincount(y_order[i::n_splits], minlength=n_classes)
         for i in range(n_splits)])
    test_folds = np.empty(len(y), dtype=np.int32)
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        rng.shuffle(folds_for_class)
        test_folds[y_encoded == k] = folds_for_class
    test_mask = test_folds == fold
    return np.where(~test_mask)[0], np.where(test_mask)[0]


def augment_to_balance(x, y_onehot, rng_seed: int = 0):
    """Class rebalancing via the pyramid ladder (`augment_images`,
    overlap_detector.py:142-225): each minority class is duplicated
    ``round(max_count / count - 1)`` times, copy i blurred through i+1
    pyrDown/pyrUp rounds.  Returns augmented (x, y) incl. originals.

    For odd-width images the ladder rounds the width up (151 -> 152) and the
    reference's final ``[:, :-1]`` crop lands back on the original width, so
    augmented tensors batch with the originals unchanged.

    Device-residency contract: a ``jax.Array`` corpus stays on device — the
    ladder runs as device programs and the concat is ``jnp`` (a host
    round-trip of a reference-scale 12,600-image tensor costs minutes of
    D2H on a slow link); balanced classes (every ratio 0 — the reference's
    own 6,300+6,300 composition) return the inputs untouched.  NumPy in
    gives NumPy out, as before."""
    y_np = np.asarray(y_onehot)
    counts = y_np.sum(axis=0)
    base = counts.max()
    plans = []                  # (class indices, pyramid rounds)
    for c in range(y_np.shape[1]):
        if counts[c] == 0:
            continue
        ratio = int(round(base / counts[c] - 1))
        cls = np.where(y_np[:, c] == 1)[0]
        for i in range(ratio):
            plans.append((cls, i + 1))
    if not plans:
        return x, y_onehot
    ys = np.concatenate([y_np] + [y_np[cls] for cls, _ in plans])
    if isinstance(x, jax.Array):
        xs = [x] + [pyramid_augment(x[cls], rounds).astype(x.dtype)
                    for cls, rounds in plans]
        return jnp.concatenate(xs), ys
    # NumPy path: only the minority-class subsets ride the device — the
    # originals pass through untouched (no full-corpus H2D/D2H round-trip
    # and no f64->f32 narrowing of original rows; only the blurred copies,
    # which go through the float pyramid anyway, are computed on device).
    aug = [np.asarray(pyramid_augment(jnp.asarray(x[cls]), rounds))
           .astype(x.dtype) for cls, rounds in plans]
    return np.concatenate([x] + aug), ys.astype(y_onehot.dtype)


def confusion_matrix(y_true_idx: np.ndarray, y_pred_idx: np.ndarray,
                     n_classes: int) -> np.ndarray:
    m = np.zeros((n_classes, n_classes), np.int64)
    for t, p in zip(y_true_idx, y_pred_idx):
        m[t, p] += 1
    return m


class OverlapTrainer:
    """train_model / continue_train_model / evaluation as jitted programs."""

    def __init__(self, model_cfg: OverlapModelConfig = OverlapModelConfig(),
                 train_cfg: OverlapTrainConfig = OverlapTrainConfig()):
        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.model = OverlapResBLSTM(model_cfg)
        # one jit wrapper per trainer: jit's compile cache is per-wrapper,
        # so a fresh lambda in evaluation() would retrace and recompile on
        # every call
        self._argmax_apply = jax.jit(
            lambda v, bx: jnp.argmax(self.model.apply(v, bx), -1))

    def _make_trainer(self, weights: Optional[np.ndarray]):
        sched = cosine_annealing(self.cfg.cosine_t_max, self.cfg.cosine_eta_max,
                                 self.cfg.cosine_eta_min)
        tx = optax.inject_hyperparams(
            lambda learning_rate: adadelta(learning_rate))(
                learning_rate=self.cfg.lr)
        if weights is not None:
            w = jnp.asarray(weights, jnp.float32)
            loss_fn = lambda lg, y: weighted_categorical_crossentropy(lg, y, w)
        else:
            loss_fn = keras_categorical_crossentropy
        trainer = Trainer(self.model, tx, loss_fn)
        return trainer, sched

    def train(self, x: np.ndarray, y_onehot: np.ndarray, *,
              weighted: bool = True, augmented: bool = False,
              epochs: Optional[int] = None, batch_size: Optional[int] = None,
              checkpoint_dir=None, seed: int = 0, verbose: bool = False):
        """Full train_model flow.  Returns (state, history, test split)."""
        labels = np.argmax(y_onehot, axis=1)
        train_idx, test_idx = stratified_kfold_indices(labels, 5, seed=0)
        x_train, y_train = x[train_idx], y_onehot[train_idx]
        x_test, y_test = x[test_idx], y_onehot[test_idx]
        if augmented:
            x_train, y_train = augment_to_balance(x_train, y_train)
        weights = cal_weighted_penalty(y_train) if weighted else None
        trainer, sched = self._make_trainer(weights)
        variables = self.model.init_variables(jax.random.PRNGKey(seed),
                                              input_shape=x.shape[1:])
        state = trainer.init_state(variables)
        ckpt = BestCheckpointer(checkpoint_dir) if checkpoint_dir else None

        def lr_epoch(e):
            return float(sched(e))

        # fit with early stopping on the test(=val) split, best checkpointing
        history = {"loss": [], "acc": [], "val_loss": [], "val_acc": []}
        best_val = np.inf
        patience = self.cfg.early_stop_patience
        rng = jax.random.PRNGKey(seed + 1)
        n_epochs = self.cfg.epochs if epochs is None else epochs
        bsz = self.cfg.batch_size if batch_size is None else batch_size
        # upload train/test once; per-epoch fit/evaluate then see device
        # arrays and skip the host->device transfer every epoch
        x_train, y_train = jnp.asarray(x_train), jnp.asarray(y_train)
        x_test_d, y_test_d = jnp.asarray(x_test), jnp.asarray(y_test)
        for epoch in range(n_epochs):
            state, h = trainer.fit(state, x_train, y_train, epochs=1,
                                   batch_size=bsz,
                                   lr_schedule_epoch=lambda _: lr_epoch(epoch),
                                   rng=jax.random.fold_in(rng, epoch))[0:2]
            vl, va = trainer.evaluate(state, x_test_d, y_test_d,
                                      batch_size=self.cfg.eval_batch_size)
            history["loss"].append(h["loss"][0])
            history["acc"].append(h["acc"][0])
            history["val_loss"].append(vl)
            history["val_acc"].append(va)
            if verbose:
                print(f"epoch {epoch}: loss={h['loss'][0]:.4f} val_acc={va:.4f}")
            if ckpt is not None:
                ckpt.update(va, trainer.variables_of(state),
                            {"epoch": epoch, "val_loss": vl})
            if vl < best_val:
                best_val, patience = vl, self.cfg.early_stop_patience
            else:
                patience -= 1
                if patience <= 0:
                    break
        self._trainer = trainer
        return state, history, (x_test, y_test)

    def continue_train(self, checkpoint_dir, x, y_onehot, *,
                       weighted: bool = True, epochs: int = 10,
                       batch_size: Optional[int] = None, seed: int = 0):
        """continue_train_model (`overlap_detector.py:480-511`): restore
        variables and keep training with the SAME callback set as the
        initial run — EarlyStopping(val_loss, patience 10), cosine-annealed
        LR (1e-2 -> 1e-4, T=100), val on an 80/20 stratified split of the
        provided data (the reference's train_test_split(test_size=0.2,
        random_state=0, stratify=y))."""
        from mmla_audio_tpu.train.transfer import train_val_split

        weights = cal_weighted_penalty(y_onehot) if weighted else None
        trainer, sched = self._make_trainer(weights)
        template = self.model.init_variables(jax.random.PRNGKey(0),
                                             input_shape=x.shape[1:])
        variables = load_variables(checkpoint_dir, template)
        state = trainer.init_state(variables)
        x_tr, y_tr, x_val, y_val = train_val_split(
            np.asarray(x), np.asarray(y_onehot), val_ratio=0.2, seed=0)
        state, history = trainer.fit(
            state, x_tr, y_tr, epochs=epochs,
            batch_size=self.cfg.batch_size if batch_size is None else batch_size,
            x_val=x_val, y_val=y_val,
            early_stop_patience=self.cfg.early_stop_patience,
            lr_schedule_epoch=lambda e: float(sched(e)),
            rng=jax.random.PRNGKey(seed))
        self._trainer = trainer
        return state, history

    def evaluation(self, state: TrainState, x, y_onehot
                   ) -> Dict[str, np.ndarray | float]:
        """Confusion matrix + recall/precision (`evaluation`, :513-543)."""
        variables = {"params": state.params}
        if state.batch_stats:
            variables["batch_stats"] = state.batch_stats
        apply = self._argmax_apply
        x = jnp.asarray(x, jnp.float32)
        # chunked prediction: same activation-memory bound as evaluate()
        chunk = self.cfg.eval_batch_size
        preds = []
        for i in range(0, x.shape[0], chunk):
            bx = x[i: i + chunk]
            n_i = bx.shape[0]
            if n_i < chunk and x.shape[0] > chunk:   # pad ragged tail only
                bx = jnp.concatenate(
                    [bx, jnp.zeros((chunk - n_i,) + bx.shape[1:], bx.dtype)])
            preds.append(np.asarray(apply(variables, bx))[:n_i])
        pred = np.concatenate(preds)
        true = np.argmax(np.asarray(y_onehot), axis=1)
        n = y_onehot.shape[1]
        cm = confusion_matrix(true, pred, n)
        with np.errstate(invalid="ignore", divide="ignore"):
            recall = np.diag(cm) / cm.sum(axis=1)
            precision = np.diag(cm) / cm.sum(axis=0)
        return {"confusion": cm, "recall": recall, "precision": precision,
                "accuracy": float((pred == true).mean())}
