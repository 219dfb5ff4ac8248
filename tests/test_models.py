"""Model architecture tests: shapes, determinism, LSTM-math golden, and
numeric goldens of the Flax implementation the plain-JAX models replaced."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mmla_audio_tpu.core.config import OverlapModelConfig, SpeakerModelConfig
from mmla_audio_tpu.models import OverlapResBLSTM, SpeakerResBLSTM, l2_penalty
from mmla_audio_tpu.models.layers import bilstm, bilstm_init, lstm, lstm_init


def np_lstm_last(x, kernel, rec_kernel, bias, reverse=False):
    """NumPy Keras-semantics LSTM (gate order i,f,c,o) returning last h."""
    B, T, C = x.shape
    H = rec_kernel.shape[0]
    h = np.zeros((B, H))
    c = np.zeros((B, H))
    order = range(T - 1, -1, -1) if reverse else range(T)
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))
    for t in order:
        z = x[:, t] @ kernel + h @ rec_kernel + bias
        i = sig(z[:, :H])
        f = sig(z[:, H:2 * H])
        g = np.tanh(z[:, 2 * H:3 * H])
        o = sig(z[:, 3 * H:])
        c = f * c + i * g
        h = o * np.tanh(c)
    return h


def test_lstm_matches_numpy_golden():
    B, T, C, H = 3, 11, 7, 5
    rng = np.random.RandomState(0)
    x = rng.randn(B, T, C).astype(np.float32)
    p = lstm_init(jax.random.PRNGKey(0), (), C, H)
    ours = np.asarray(lstm(p, jnp.asarray(x)))
    ref = np_lstm_last(x.astype(np.float64), np.asarray(p["kernel"]),
                       np.asarray(p["recurrent_kernel"]), np.asarray(p["bias"]))
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


def test_lstm_reverse_matches_numpy_golden():
    B, T, C, H = 2, 9, 4, 6
    rng = np.random.RandomState(1)
    x = rng.randn(B, T, C).astype(np.float32)
    p = lstm_init(jax.random.PRNGKey(0), (), C, H)
    ours = np.asarray(lstm(p, jnp.asarray(x), reverse=True))
    ref = np_lstm_last(x.astype(np.float64), np.asarray(p["kernel"]),
                       np.asarray(p["recurrent_kernel"]), np.asarray(p["bias"]),
                       reverse=True)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-5)


def test_lstm_unit_forget_bias():
    b = np.asarray(lstm_init(jax.random.PRNGKey(0), (), 2, 4)["bias"])
    np.testing.assert_array_equal(b[:4], 0)
    np.testing.assert_array_equal(b[4:8], 1)
    np.testing.assert_array_equal(b[8:], 0)


def test_bilstm_shape():
    p = bilstm_init(jax.random.PRNGKey(0), (), 128, 256)
    out = bilstm(p, jnp.zeros((2, 19, 128)))
    assert out.shape == (2, 512)


def test_overlap_model_shapes():
    model = OverlapResBLSTM(OverlapModelConfig(num_classes=2))
    variables = model.init_variables(jax.random.PRNGKey(0), batch=2)
    x = jnp.asarray(np.random.RandomState(0).rand(2, 128, 151, 3) * 255,
                    jnp.float32)
    logits = model.apply(variables, x)
    assert logits.shape == (2, 2)
    assert np.isfinite(np.asarray(logits)).all()


def test_overlap_model_layer_counts():
    # The reference SavedModel metadata confirms 22 Conv2D + 18 BN layers:
    # 1 stem + 9 blocks x 2 inner convs + 3 shortcuts = 22; 9 x 2 BN = 18.
    model = OverlapResBLSTM()
    variables = model.init_variables(jax.random.PRNGKey(0))
    flat = jax.tree_util.tree_leaves_with_path(variables["params"])
    n_convs = sum(1 for p, v in flat if v.ndim == 4 and "kernel" in str(p))
    assert n_convs == 22, n_convs
    n_bn = sum(1 for p, v in flat if "BatchNorm" in str(p) and "scale" in str(p))
    assert n_bn == 18, n_bn


def test_speaker_model_shapes():
    model = SpeakerResBLSTM()
    variables = model.init_variables(jax.random.PRNGKey(0), batch=3)
    x = jnp.asarray(np.random.RandomState(0).randn(3, 256, 39), jnp.float32)
    logits = model.apply(variables, x)
    assert logits.shape == (3, 630)
    assert np.isfinite(np.asarray(logits)).all()


def test_speaker_head_swap():
    """Transfer-learning head: same trunk params, different head width."""
    base = SpeakerResBLSTM()
    variables = base.init_variables(jax.random.PRNGKey(0))
    small = SpeakerResBLSTM(head_units=4)
    v2 = small.init_variables(jax.random.PRNGKey(1))
    # graft trunk params from base into small
    p2 = dict(v2["params"])
    p2["trunk"] = variables["params"]["trunk"]
    x = jnp.zeros((1, 256, 39))
    out = small.apply({"params": p2, "batch_stats": variables["batch_stats"]}, x)
    assert out.shape == (1, 4)


def test_speaker_l2_penalty_positive_and_selective():
    model = SpeakerResBLSTM()
    variables = model.init_variables(jax.random.PRNGKey(0))
    pen = float(l2_penalty(variables["params"]))
    assert pen > 0
    # zero coefficients -> zero penalty
    cfg0 = SpeakerModelConfig(stage_l2=(0.0, 0.0, 0.0))
    assert float(l2_penalty(variables["params"], cfg0)) == 0.0


def test_dropout_train_vs_eval():
    model = SpeakerResBLSTM()
    variables = model.init_variables(jax.random.PRNGKey(0), batch=2)
    x = jnp.asarray(np.random.RandomState(2).randn(2, 256, 39), jnp.float32)
    eval1 = model.apply(variables, x)
    eval2 = model.apply(variables, x)
    np.testing.assert_array_equal(np.asarray(eval1), np.asarray(eval2))
    tr1 = model.apply(variables, x, train=True,
                      rngs={"dropout": jax.random.PRNGKey(1)},
                      mutable=["batch_stats"])[0]
    tr2 = model.apply(variables, x, train=True,
                      rngs={"dropout": jax.random.PRNGKey(2)},
                      mutable=["batch_stats"])[0]
    assert not np.allclose(np.asarray(tr1), np.asarray(tr2))


GOLDEN = Path(__file__).parent / "golden"

# Reduced configs of tests/golden/models_flax.npz (written by the Flax linen
# models before they were replaced): init variables from PRNGKey(0), eval
# logits, and train-mode logits + batch_stats with dropout key PRNGKey(1).
_GOLDEN_CASES = {
    "overlap": (lambda: OverlapResBLSTM(OverlapModelConfig(
        stem_filters=4, stage_filters=(4, 6, 8), blocks_per_stage=2,
        lstm_units=5, num_classes=3, input_scale=1 / 255)), (16, 20, 3)),
    "speaker": (lambda: SpeakerResBLSTM(SpeakerModelConfig(
        stem_filters=4, stage_filters=(4, 6, 8), blocks_per_stage=2,
        lstm_units=5, num_speakers=7)), (64, 39)),
    "speaker_head4": (lambda: SpeakerResBLSTM(SpeakerModelConfig(
        stem_filters=4, stage_filters=(4, 6, 8), blocks_per_stage=2,
        lstm_units=5, num_speakers=7), head_units=4), (64, 39)),
}


def _flat(tree):
    return {"/".join(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _golden(name, part):
    g = np.load(GOLDEN / "models_flax.npz")
    prefix = f"{name}/{part}/"
    return {k[len(prefix):]: g[k] for k in g.files if k.startswith(prefix)}


@pytest.mark.parametrize("name", sorted(_GOLDEN_CASES))
def test_init_matches_flax_golden(name):
    """Same seed, same initial values: keys are derived as Flax derived them."""
    make, shape = _GOLDEN_CASES[name]
    got = _flat(make().init_variables(jax.random.PRNGKey(0), input_shape=shape))
    want = _golden(name, "init")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(_GOLDEN_CASES))
def test_apply_matches_flax_golden(name):
    """Eval logits, train-mode logits (batch statistics + dropout masks) and
    the updated running statistics equal the Flax implementation's."""
    make, _ = _GOLDEN_CASES[name]
    g = np.load(GOLDEN / "models_flax.npz")
    variables = {}
    for key, arr in _golden(name, "init").items():
        node = variables
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr)
    model = make()
    x = jnp.asarray(g[f"{name}/x"])
    np.testing.assert_allclose(np.asarray(model.apply(variables, x)),
                               g[f"{name}/eval_logits"], rtol=1e-5, atol=1e-6)
    logits, upd = model.apply(variables, x, train=True,
                              rngs={"dropout": jax.random.PRNGKey(1)},
                              mutable=["batch_stats"])
    np.testing.assert_allclose(np.asarray(logits), g[f"{name}/train_logits"],
                               rtol=1e-5, atol=1e-6)
    want = _golden(name, "train_stats")
    got = _flat(upd)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("name", ["overlap", "speaker"])
def test_default_variable_tree_paths_and_shapes(name):
    """The default configs keep the variable paths and shapes of the Flax
    models, so Keras/TF-bundle imports and saved checkpoints map 1:1."""
    model = {"overlap": OverlapResBLSTM, "speaker": SpeakerResBLSTM}[name]()
    v = jax.eval_shape(lambda: model.init_variables(jax.random.PRNGKey(0)))
    got = {"/".join(k.key for k in p): list(a.shape)
           for p, a in jax.tree_util.tree_leaves_with_path(v)}
    want = json.loads((GOLDEN / "model_tree.json").read_text())[name]
    assert got == want


def test_train_apply_requires_mutable_batch_stats():
    model = SpeakerResBLSTM(SpeakerModelConfig(stage_filters=(4, 4, 4),
                                               lstm_units=4, num_speakers=3))
    v = model.init_variables(jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="mutable"):
        model.apply(v, jnp.zeros((1, 256, 39)), train=True,
                    rngs={"dropout": jax.random.PRNGKey(1)})
    out, upd = model.apply(v, jnp.zeros((1, 256, 39)), mutable=["batch_stats"])
    assert out.shape == (1, 3)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: bool(jnp.array_equal(a, b)), upd["batch_stats"],
        v["batch_stats"]))


def test_main_path_imports_neither_flax_nor_orbax():
    code = ("import sys\n"
            "import mmla_audio_tpu.inference, mmla_audio_tpu.train, "
            "mmla_audio_tpu.streaming.multiplex, mmla_audio_tpu.cli\n"
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('flax', 'orbax'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         cwd=Path(__file__).resolve().parent.parent,
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stdout + out.stderr[-2000:]
