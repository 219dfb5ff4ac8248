"""Training loops: losses/metrics parity, convergence, transfer learning."""

import numpy as np
import jax
import jax.numpy as jnp
import optax

from mmla_audio_tpu.core.config import SpeakerModelConfig, TransferConfig
from mmla_audio_tpu.models.overlap import OverlapResBLSTM
from mmla_audio_tpu.models.speaker import SpeakerResBLSTM
from mmla_audio_tpu.core.config import OverlapModelConfig
from mmla_audio_tpu.train import (
    TransferLearner,
    Trainer,
    cal_weighted_penalty,
    cosine_annealing,
    keras_categorical_crossentropy,
    weighted_categorical_crossentropy,
    adadelta,
    rmsprop,
    train_val_split,
)


def test_keras_cce_matches_manual():
    logits = jnp.asarray([[2.0, -1.0, 0.5]])
    y = jnp.asarray([[1.0, 0.0, 0.0]])
    p = np.exp([2.0, -1.0, 0.5])
    p /= p.sum()
    expect = -np.log(np.clip(p[0], 1e-7, 1 - 1e-7))
    got = float(keras_categorical_crossentropy(logits, y)[0])
    np.testing.assert_allclose(got, expect, rtol=1e-5)


def test_weighted_cce_weights_scale_terms():
    logits = jnp.asarray([[1.0, 1.0]])
    y = jnp.asarray([[0.0, 1.0]])
    base = float(keras_categorical_crossentropy(logits, y)[0])
    w2 = float(weighted_categorical_crossentropy(logits, y, [1.0, 2.0])[0])
    np.testing.assert_allclose(w2, 2 * base, rtol=1e-6)


def test_sigmoid_cce_renormalizes():
    # sigmoid outputs don't sum to 1; Keras renormalizes inside the loss
    logits = jnp.asarray([[0.0, 0.0]])       # sigmoid -> [0.5, 0.5] -> renorm [0.5, 0.5]
    y = jnp.asarray([[1.0, 0.0]])
    got = float(keras_categorical_crossentropy(logits, y, activation="sigmoid")[0])
    np.testing.assert_allclose(got, -np.log(0.5), rtol=1e-5)


def test_cal_weighted_penalty_reference_semantics():
    y = np.zeros((10, 3))
    y[:6, 0] = 1
    y[6:9, 1] = 1
    y[9:, 2] = 1
    w = cal_weighted_penalty(y)
    np.testing.assert_allclose(w, [1 - 0.6, 1 - 0.3, 1 - 0.1])


def test_cosine_annealing_schedule():
    sched = cosine_annealing(t_max=100, eta_max=1e-2, eta_min=1e-4)
    assert abs(float(sched(0)) - 1e-2) < 1e-9
    mid = float(sched(50))
    np.testing.assert_allclose(mid, 1e-4 + (1e-2 - 1e-4) / 2, rtol=1e-6)
    assert abs(float(sched(100)) - 1e-4) < 1e-9


def _toy_speaker_data(n_per_class=24, n_classes=3, seed=0):
    """Separable (256, 39) features: class-dependent mean offsets."""
    rng = np.random.RandomState(seed)
    xs, ys = [], []
    for c in range(n_classes):
        base = np.zeros((1, 256, 39), np.float32)
        base[..., c * 10:(c + 1) * 10] = 3.0
        x = base + rng.randn(n_per_class, 256, 39).astype(np.float32)
        y = np.zeros((n_per_class, n_classes), np.float32)
        y[:, c] = 1
        xs.append(x)
        ys.append(y)
    return np.concatenate(xs), np.concatenate(ys)


def test_trainer_converges_small_model():
    """A small speaker model should fit separable toy data."""
    cfg = SpeakerModelConfig(stage_filters=(8, 8, 8), lstm_units=16,
                             num_speakers=3)
    model = SpeakerResBLSTM(cfg)
    variables = model.init_variables(jax.random.PRNGKey(0))
    trainer = Trainer(model, rmsprop(1e-3),
                      lambda lg, y: keras_categorical_crossentropy(lg, y))
    state = trainer.init_state(variables)
    x, y = _toy_speaker_data()
    state, hist = trainer.fit(state, x, y, epochs=5, batch_size=16,
                              rng=jax.random.PRNGKey(1))
    assert hist["loss"][-1] < hist["loss"][0]
    _, acc = trainer.evaluate(state, x, y)
    assert acc > 0.8, acc


def test_trainer_partial_batch_masking():
    """n not divisible by batch_size must not crash or skew shapes."""
    cfg = SpeakerModelConfig(stage_filters=(4, 4, 4), lstm_units=8,
                             num_speakers=3)
    model = SpeakerResBLSTM(cfg)
    variables = model.init_variables(jax.random.PRNGKey(0))
    trainer = Trainer(model, adadelta(1e-2),
                      lambda lg, y: keras_categorical_crossentropy(lg, y))
    state = trainer.init_state(variables)
    x, y = _toy_speaker_data(n_per_class=7)   # 21 samples, batch 16
    state, hist = trainer.fit(state, x, y, epochs=2, batch_size=16)
    assert len(hist["loss"]) == 2
    assert np.isfinite(hist["loss"]).all()


def test_trainer_chunked_evaluate_matches_full_batch():
    """evaluate(batch_size=k) scans k-sized chunks (bounds activation memory
    on reference-scale held-out folds) and must agree with the single-batch
    path, including a ragged final chunk that needs masked padding."""
    cfg = SpeakerModelConfig(stage_filters=(4, 4, 4), lstm_units=8,
                             num_speakers=3)
    model = SpeakerResBLSTM(cfg)
    variables = model.init_variables(jax.random.PRNGKey(0))
    trainer = Trainer(model, rmsprop(1e-3),
                      lambda lg, y: keras_categorical_crossentropy(lg, y))
    state = trainer.init_state(variables)
    x, y = _toy_speaker_data(n_per_class=7)          # 21 samples
    full_loss, full_acc = trainer.evaluate(state, x, y)
    for bs in (8, 21, 64):                           # ragged, exact, > n
        loss, acc = trainer.evaluate(state, x, y, batch_size=bs)
        np.testing.assert_allclose(loss, full_loss, rtol=1e-5)
        np.testing.assert_allclose(acc, full_acc, rtol=1e-6)


def test_trainer_early_stopping():
    cfg = SpeakerModelConfig(stage_filters=(4, 4, 4), lstm_units=8,
                             num_speakers=3)
    model = SpeakerResBLSTM(cfg)
    variables = model.init_variables(jax.random.PRNGKey(0))
    trainer = Trainer(model, rmsprop(0.0),   # lr=0: val loss never improves
                      lambda lg, y: keras_categorical_crossentropy(lg, y))
    state = trainer.init_state(variables)
    x, y = _toy_speaker_data(n_per_class=8)
    state, hist = trainer.fit(state, x, y, epochs=50, batch_size=8,
                              x_val=x[:6], y_val=y[:6],
                              early_stop_patience=3)
    assert len(hist["loss"]) <= 5   # 1 best + 3 patience + slack


def test_train_val_split_stratified():
    x, y = _toy_speaker_data(n_per_class=10)
    xt, yt, xv, yv = train_val_split(x, y, 0.3, seed=0)
    assert xt.shape[0] + xv.shape[0] == 30
    # every class appears in both splits
    assert set(np.argmax(yt, 1)) == {0, 1, 2}
    assert set(np.argmax(yv, 1)) == {0, 1, 2}


def test_transfer_learner_freezes_then_unfreezes():
    cfg = SpeakerModelConfig(stage_filters=(4, 4, 4), lstm_units=8,
                             num_speakers=10)
    base = SpeakerResBLSTM(cfg)
    base_vars = base.init_variables(jax.random.PRNGKey(0))
    x, y = _toy_speaker_data(n_per_class=16, n_classes=3)

    tl = TransferLearner(base_vars, n_speakers=3, model_cfg=cfg,
                         cfg=TransferConfig(phase1_epochs=3, phase2_epochs=0,
                                            max_retrain_rounds=1))
    variables, acc, losses = tl.fit_once(x, y, seed=0)
    # phase-1 with frozen trunk: trunk params identical to base
    for (p1, v1), (p2, v2) in zip(
            jax.tree_util.tree_leaves_with_path(base_vars["params"]["trunk"]),
            jax.tree_util.tree_leaves_with_path(variables["params"]["trunk"])):
        np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))

    tl2 = TransferLearner(base_vars, n_speakers=3, model_cfg=cfg,
                          cfg=TransferConfig(phase1_epochs=1, phase2_epochs=2,
                                             max_retrain_rounds=1))
    variables2, acc2, _ = tl2.fit_once(x, y, seed=0)
    # phase-2 unfrozen: trunk params must have moved
    moved = False
    for (p1, v1), (p2, v2) in zip(
            jax.tree_util.tree_leaves_with_path(base_vars["params"]["trunk"]),
            jax.tree_util.tree_leaves_with_path(variables2["params"]["trunk"])):
        if not np.array_equal(np.asarray(v1), np.asarray(v2)):
            moved = True
    assert moved


def test_transfer_learner_converges_to_gate():
    cfg = SpeakerModelConfig(stage_filters=(8, 8, 8), lstm_units=16,
                             num_speakers=10)
    base = SpeakerResBLSTM(cfg)
    base_vars = base.init_variables(jax.random.PRNGKey(42))
    x, y = _toy_speaker_data(n_per_class=24, n_classes=3, seed=1)
    # Random (untrained) trunk, so give phase 2 (unfrozen, but reference lr
    # 1e-6 is too slow for a test) a real lr via a custom config.
    tcfg = TransferConfig(phase1_epochs=120, phase1_lr=3e-3,
                          phase2_epochs=0, max_retrain_rounds=3)
    tl = TransferLearner(base_vars, n_speakers=3, model_cfg=cfg, cfg=tcfg)
    variables, acc, losses = tl.fit_until_gate(x, y, seed=0)
    assert acc >= 0.8, acc
    assert losses[0] > losses[len(losses) // 2]


def test_lr_schedule_requires_injectable_optimizer():
    """lr_schedule_epoch with a plain (non-inject_hyperparams) optimizer must
    raise, not silently train at a fixed lr."""
    import pytest

    cfg = SpeakerModelConfig(stage_filters=(4, 4, 4), lstm_units=8,
                             num_speakers=2)
    model = SpeakerResBLSTM(cfg)
    variables = model.init_variables(jax.random.PRNGKey(0))
    trainer = Trainer(model, rmsprop(1e-3), keras_categorical_crossentropy)
    state = trainer.init_state(variables)
    x = np.random.RandomState(0).randn(8, 256, 39).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[np.arange(8) % 2]
    with pytest.raises(ValueError, match="inject_hyperparams"):
        trainer.fit(state, x, y, epochs=1, batch_size=4,
                    lr_schedule_epoch=lambda e: 1e-3)


def test_rmsprop_matches_keras_update_rule():
    """Step-by-step parity with a NumPy transcription of Keras RMSprop
    (uncentered, no momentum): rms = rho*rms + (1-rho)*g^2;
    p -= lr * g / (sqrt(rms) + eps) — eps OUTSIDE the sqrt (optax's default
    eps_in_sqrt=True diverges when rms is small)."""
    import numpy as np
    import jax.numpy as jnp
    import optax

    lr, rho, eps = 1e-2, 0.9, 1e-7
    tx = rmsprop(lr, decay=rho, eps=eps)
    p = jnp.asarray(np.float32([0.5, -1.0, 2.0]))
    opt_state = tx.init(p)
    p_ref = np.asarray(p, np.float64).copy()
    rms = np.zeros_like(p_ref)
    rng = np.random.RandomState(0)
    for step in range(8):
        g = rng.randn(3).astype(np.float32) * (1e-4 if step < 3 else 1.0)
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, p)
        p = optax.apply_updates(p, updates)
        g64 = g.astype(np.float64)
        rms = rho * rms + (1 - rho) * g64 * g64
        p_ref -= lr * g64 / (np.sqrt(rms) + eps)
        np.testing.assert_allclose(np.asarray(p), p_ref, rtol=2e-5, atol=2e-6)


def test_adadelta_matches_keras_update_rule():
    """Step-by-step parity with a NumPy transcription of Keras Adadelta:
    acc = rho*acc + (1-rho)*g^2; delta = g*sqrt(acc_d+eps)/sqrt(acc+eps);
    acc_d = rho*acc_d + (1-rho)*delta^2; p -= lr*delta (eps inside BOTH
    square roots, as in TF/Keras)."""
    import numpy as np
    import jax.numpy as jnp
    import optax

    lr, rho, eps = 1e-1, 0.95, 1e-7
    tx = adadelta(lr, rho=rho, eps=eps)
    p = jnp.asarray(np.float32([1.0, -0.5, 0.25]))
    opt_state = tx.init(p)
    p_ref = np.asarray(p, np.float64).copy()
    acc = np.zeros_like(p_ref)
    acc_d = np.zeros_like(p_ref)
    rng = np.random.RandomState(1)
    for _ in range(8):
        g = rng.randn(3).astype(np.float32)
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, p)
        p = optax.apply_updates(p, updates)
        g64 = g.astype(np.float64)
        acc = rho * acc + (1 - rho) * g64 * g64
        delta = g64 * np.sqrt(acc_d + eps) / np.sqrt(acc + eps)
        acc_d = rho * acc_d + (1 - rho) * delta * delta
        p_ref -= lr * delta
        np.testing.assert_allclose(np.asarray(p), p_ref, rtol=2e-5, atol=2e-6)


def test_fit_device_resident_inputs_match_host_inputs():
    """Passing jax.Arrays (device-resident corpus) to ``fit`` must produce
    the same training trajectory as NumPy inputs — including a partial last
    batch, which the device path pads and masks on device instead of
    round-tripping through the host."""
    cfg = SpeakerModelConfig(stage_filters=(4, 4, 4), lstm_units=8,
                             num_speakers=3)
    model = SpeakerResBLSTM(cfg)
    variables = model.init_variables(jax.random.PRNGKey(0))
    x, y = _toy_speaker_data(n_per_class=7)   # 21 samples: pad to batch 16

    def run(xin, yin):
        trainer = Trainer(model, rmsprop(1e-3),
                          lambda lg, y: keras_categorical_crossentropy(lg, y))
        state = trainer.init_state(variables)
        state, hist = trainer.fit(state, xin, yin, epochs=3, batch_size=16,
                                  x_val=xin[:6], y_val=yin[:6],
                                  rng=jax.random.PRNGKey(2))
        return hist

    h_np = run(x, y)
    # device features + HOST labels: the device path must key on x alone
    # (np labels are the common shape and must not silently pull the big
    # tensor down the host path)
    h_dev = run(jnp.asarray(x), y)
    np.testing.assert_allclose(h_dev["loss"], h_np["loss"], rtol=1e-6)
    np.testing.assert_allclose(h_dev["acc"], h_np["acc"], rtol=1e-6)
    np.testing.assert_allclose(h_dev["val_loss"], h_np["val_loss"], rtol=1e-6)


def test_weighted_cce_sigmoid_activation():
    """activation='sigmoid' renormalizes sigmoid outputs inside the weighted
    loss (the transfer head is sigmoid, speaker_identification.py:409)."""
    logits = jnp.asarray([[0.0, 0.0]])   # sigmoid [.5,.5] -> renorm [.5,.5]
    y = jnp.asarray([[0.0, 1.0]])
    got = float(weighted_categorical_crossentropy(
        logits, y, [1.0, 1.0], activation="sigmoid")[0])
    np.testing.assert_allclose(got, -np.log(0.5), rtol=1e-6)
    # weights scale the sigmoid-branch terms identically to softmax
    w2 = float(weighted_categorical_crossentropy(
        logits, y, [1.0, 2.0], activation="sigmoid")[0])
    np.testing.assert_allclose(w2, 2 * got, rtol=1e-6)


def test_categorical_accuracy_metric():
    from mmla_audio_tpu.train import categorical_accuracy

    logits = jnp.asarray([[2.0, 1.0], [0.0, 3.0], [5.0, 0.0], [0.0, 1.0]])
    y = jnp.asarray([[1.0, 0.0], [0.0, 1.0], [0.0, 1.0], [1.0, 0.0]])
    np.testing.assert_allclose(float(categorical_accuracy(logits, y)), 0.5)
