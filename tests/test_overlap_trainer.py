"""Overlap trainer orchestration: kfold, balancing, checkpoints, eval."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from mmla_audio_tpu.core.config import OverlapModelConfig, OverlapTrainConfig
from mmla_audio_tpu.train.checkpoints import (
    BestCheckpointer,
    load_feature_cache,
    load_variables,
    save_feature_cache,
    save_variables,
)
from mmla_audio_tpu.train.overlap_trainer import (
    OverlapTrainer,
    augment_to_balance,
    confusion_matrix,
    stratified_kfold_indices,
)


def test_stratified_kfold_properties():
    labels = np.array([0] * 50 + [1] * 30 + [2] * 20)
    train, test = stratified_kfold_indices(labels, 5, seed=0, fold=0)
    assert len(train) + len(test) == 100
    assert len(set(train) & set(test)) == 0
    # per-class 1/5 in test (within rounding)
    for c, total in [(0, 50), (1, 30), (2, 20)]:
        in_test = (labels[test] == c).sum()
        assert abs(in_test - total / 5) <= 1
    # different folds partition the data
    all_test = set()
    for f in range(5):
        _, tf = stratified_kfold_indices(labels, 5, seed=0, fold=f)
        all_test |= set(tf)
    assert all_test == set(range(100))


def _toy_images(n0=20, n1=8, seed=0):
    rng = np.random.RandomState(seed)
    x0 = rng.rand(n0, 32, 39, 3).astype(np.float32) * 255
    x1 = rng.rand(n1, 32, 39, 3).astype(np.float32) * 255
    x1[:, :8] += 100  # separable signal
    x = np.concatenate([x0, x1])
    y = np.zeros((n0 + n1, 2), np.float32)
    y[:n0, 0] = 1
    y[n0:, 1] = 1
    return x, y


def test_augment_to_balance_counts():
    x, y = _toy_images(20, 8)
    xa, ya = augment_to_balance(x, y)
    c = ya.sum(axis=0)
    # class 1 duplicated round(20/8 - 1)=2 times: 8 + 16 = 24
    assert c[0] == 20 and c[1] == 24
    assert xa.shape[1:] == x.shape[1:]


def test_confusion_matrix():
    cm = confusion_matrix(np.array([0, 0, 1, 2]), np.array([0, 1, 1, 2]), 3)
    np.testing.assert_array_equal(cm, [[1, 1, 0], [0, 1, 0], [0, 0, 1]])


def test_overlap_trainer_end_to_end(tmp_path):
    x, y = _toy_images(30, 20, seed=1)
    t = OverlapTrainer(
        OverlapModelConfig(stage_filters=(4, 4, 8), lstm_units=8,
                           num_classes=2),
        OverlapTrainConfig(epochs=3, batch_size=8, early_stop_patience=5))
    state, history, (x_test, y_test) = t.train(
        x, y, weighted=True, augmented=False,
        checkpoint_dir=tmp_path / "ckpt", seed=0)
    assert len(history["loss"]) <= 3
    assert np.isfinite(history["loss"]).all()
    ev = t.evaluation(state, x_test, y_test)
    assert ev["confusion"].sum() == len(x_test)
    assert 0.0 <= ev["accuracy"] <= 1.0

    # checkpoint written and loadable; continue training from it
    state2, hist2 = t.continue_train(tmp_path / "ckpt", x, y, epochs=1,
                                     batch_size=8)
    assert np.isfinite(hist2["loss"]).all()


def test_evaluation_chunked_matches_unchunked():
    """eval_batch_size chunks evaluation()/evaluate() (activation-memory
    bound for reference-scale folds); predictions and the confusion matrix
    must be identical to the single-batch path, ragged tail included."""
    import dataclasses

    x, y = _toy_images(13, 9, seed=2)          # 22 samples
    mcfg = OverlapModelConfig(stage_filters=(4, 4, 8), lstm_units=8,
                              num_classes=2)
    t_full = OverlapTrainer(mcfg, OverlapTrainConfig(eval_batch_size=512))
    t_chunk = OverlapTrainer(mcfg, OverlapTrainConfig(eval_batch_size=8))
    variables = t_full.model.init_variables(jax.random.PRNGKey(5),
                                            input_shape=x.shape[1:])
    trainer, _ = t_full._make_trainer(None)
    state = trainer.init_state(variables)
    ev_full = t_full.evaluation(state, x, y)
    ev_chunk = t_chunk.evaluation(state, x, y)
    np.testing.assert_array_equal(ev_full["confusion"], ev_chunk["confusion"])
    assert ev_full["accuracy"] == ev_chunk["accuracy"]


def test_save_load_variables_roundtrip(tmp_path):
    from mmla_audio_tpu.models.speaker import SpeakerResBLSTM
    from mmla_audio_tpu.core.config import SpeakerModelConfig
    cfg = SpeakerModelConfig(stage_filters=(4, 4, 4), lstm_units=8,
                             num_speakers=5)
    m = SpeakerResBLSTM(cfg)
    v = m.init_variables(jax.random.PRNGKey(0))
    save_variables(tmp_path / "m", v, {"note": "test"})
    back = load_variables(tmp_path / "m", v)
    for (p1, a), (p2, b) in zip(jax.tree_util.tree_leaves_with_path(v),
                                jax.tree_util.tree_leaves_with_path(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_save_load_variables_without_template(tmp_path):
    """No template: the nested dicts are rebuilt from the saved paths, and
    the checkpoint is a plain npz keyed by '/'-joined paths + metadata."""
    v = {"params": {"trunk": {"w": np.arange(6.0).reshape(2, 3)},
                    "head": {"b": np.zeros(2, np.float32)}},
         "batch_stats": {"m": np.ones(3, np.float32)}}
    save_variables(tmp_path / "m", v, {"note": "x"})
    with np.load(tmp_path / "m" / "variables.npz") as data:
        assert sorted(data.files) == ["batch_stats/m", "params/head/b",
                                      "params/trunk/w"]
    back = load_variables(tmp_path / "m")
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(v)
    for a, b in zip(jax.tree_util.tree_leaves(v),
                    jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    import json
    assert json.loads((tmp_path / "m" / "metadata.json").read_text()) == \
        {"note": "x"}


def test_load_variables_template_mismatch_raises(tmp_path):
    import pytest

    save_variables(tmp_path / "m", {"params": {"w": np.zeros((2, 3),
                                                             np.float32)}})
    with pytest.raises(ValueError, match=r"params/w is float32\[2, 3\]"):
        load_variables(tmp_path / "m",
                       {"params": {"w": np.zeros((3, 2), np.float32)}})
    with pytest.raises(ValueError, match="template wants float64"):
        load_variables(tmp_path / "m",
                       {"params": {"w": np.zeros((2, 3), np.float64)}})
    with pytest.raises(ValueError, match="missing.*params/b"):
        load_variables(tmp_path / "m",
                       {"params": {"w": np.zeros((2, 3), np.float32),
                                   "b": np.zeros(3, np.float32)}})


def test_best_checkpointer_keeps_best(tmp_path):
    ck = BestCheckpointer(tmp_path / "best")
    v1 = {"params": {"w": np.array([1.0])}}
    v2 = {"params": {"w": np.array([2.0])}}
    v3 = {"params": {"w": np.array([3.0])}}
    assert ck.update(0.5, v1)
    assert ck.update(0.8, v2)
    assert not ck.update(0.6, v3)      # worse: not saved
    back = load_variables(tmp_path / "best", v1)
    np.testing.assert_array_equal(back["params"]["w"], [2.0])


def test_feature_cache_roundtrip(tmp_path):
    x = np.random.RandomState(0).rand(4, 256, 39).astype(np.float32)
    y = np.eye(4, dtype=np.float32)
    sid = {"0": "alice", "1": "bob"}
    save_feature_cache(tmp_path / "experiment_feature", x, y, sid)
    x2, y2, sid2 = load_feature_cache(tmp_path / "experiment_feature")
    np.testing.assert_array_equal(x, x2)
    np.testing.assert_array_equal(y, y2)
    assert sid2 == sid


def test_stratified_kfold_matches_sklearn_exactly():
    """The split is a literal transcription of sklearn
    StratifiedKFold(shuffle=True, random_state=0) — the reference's split
    (`overlap_detector.py:274-275`) — so fold membership must match
    sklearn index-for-index."""
    sklearn = pytest.importorskip("sklearn.model_selection")
    rng = np.random.RandomState(42)
    for _ in range(5):
        y = rng.randint(0, 3, rng.randint(30, 200))
        skf = sklearn.StratifiedKFold(n_splits=5, shuffle=True,
                                      random_state=0)
        ref_train, ref_test = next(iter(skf.split(np.zeros((len(y), 1)), y)))
        ours_train, ours_test = stratified_kfold_indices(y, 5, seed=0, fold=0)
        np.testing.assert_array_equal(np.sort(ref_test), np.sort(ours_test))
        np.testing.assert_array_equal(np.sort(ref_train),
                                      np.sort(ours_train))


def test_augment_numpy_path_preserves_originals():
    """NumPy in => NumPy out with the ORIGINAL rows bit-identical and the
    input dtype preserved (incl. float64, which a whole-corpus jnp.asarray
    would silently narrow to f32) — only the blurred minority copies ride
    the device."""
    x, y = _toy_images(20, 8)
    x64 = x.astype(np.float64)
    xa, ya = augment_to_balance(x64, y)
    assert isinstance(xa, np.ndarray) and xa.dtype == np.float64
    np.testing.assert_array_equal(xa[: len(x64)], x64)
    assert ya.dtype == y.dtype
    # device in => device out, originals exact
    xd = jnp.asarray(x)
    xa_d, _ = augment_to_balance(xd, y)
    assert isinstance(xa_d, jax.Array)
    np.testing.assert_array_equal(np.asarray(xa_d[: len(x)]), x)
