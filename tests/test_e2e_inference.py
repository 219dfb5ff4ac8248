"""End-to-end slice: WAV -> jitted featurize+forward -> label -> TSV log.

Mirrors `overlap_detector_run.py` / the post-time pipelines with random-init
weights (the reference's shipped weight blobs are stripped)."""

import numpy as np
import jax
import jax.numpy as jnp

from tests.conftest import synth_speech, synth_speech_i16

from mmla_audio_tpu.analyze.logs import (
    OVERLAP_LABELS_3WAY,
    SessionLog,
    parse_log,
)
from mmla_audio_tpu.data.wavio import read_wav, read_wav_float, write_wav
from mmla_audio_tpu.core.config import OverlapModelConfig, SpeakerModelConfig
from mmla_audio_tpu.inference import SILENT, OverlapPredictor, SpeakerPredictor
from mmla_audio_tpu.models.overlap import OverlapResBLSTM
from mmla_audio_tpu.models.speaker import SpeakerResBLSTM


def test_wav_roundtrip(tmp_path):
    sig = synth_speech_i16(40960, seed=1)
    p = tmp_path / "a.wav"
    write_wav(p, sig)
    back, rate = read_wav(p)
    assert rate == 16000
    np.testing.assert_array_equal(back, sig)
    backf, _ = read_wav_float(p)
    np.testing.assert_allclose(backf, sig.astype(np.float32) / 32768.0)


def test_overlap_predict_end_to_end(tmp_path):
    model = OverlapResBLSTM()
    variables = model.init_variables(jax.random.PRNGKey(0))
    pred = OverlapPredictor(variables)

    # one window from a WAV file, one silent window
    wav = tmp_path / "w.wav"
    write_wav(wav, synth_speech_i16(40960, seed=2))
    sig, _ = read_wav(wav)
    buf = np.zeros((2, 40960), np.float32)
    buf[0, :len(sig)] = sig
    buf[1, :100] = 500.0  # silent: only 100 valid samples
    labels, probs = pred.predict(buf, np.array([len(sig), 100]))
    labels = np.asarray(labels)
    assert labels.shape == (2,)
    assert labels[0] in (0, 1)
    assert labels[1] == SILENT
    assert np.allclose(np.asarray(probs).sum(-1), 1.0, atol=1e-5)


def test_int16_input_matches_float32():
    """int16 PCM is the preferred transfer dtype; results must be identical
    to float32 at int16 scale, for both predictors."""
    ov = OverlapPredictor(OverlapResBLSTM().init_variables(jax.random.PRNGKey(0)))
    sp = SpeakerPredictor(SpeakerResBLSTM().init_variables(jax.random.PRNGKey(1)))
    buf_f = np.zeros((2, 40960), np.float32)
    buf_f[0] = synth_speech_i16(40960, seed=4)
    buf_f[1, :2000] = 321.0
    buf_i = buf_f.astype(np.int16)
    n = np.array([40960, 2000])
    for pred in (ov, sp):
        lf, pf = pred.predict(buf_f, n)
        li, pi = pred.predict(buf_i, n)
        np.testing.assert_array_equal(np.asarray(lf), np.asarray(li))
        np.testing.assert_array_equal(np.asarray(pf), np.asarray(pi))


def test_matmul_precision_knob():
    """``matmul_precision="highest"`` forces true-FP32 dots/convs for strict
    GPU<->CPU label parity (chip_smoke.py phase 4 measures the agreement on
    the card).  On CPU the knob is a no-op numerically —
    results must match the default path exactly."""
    ov_vars = OverlapResBLSTM().init_variables(jax.random.PRNGKey(0))
    sp_vars = SpeakerResBLSTM().init_variables(jax.random.PRNGKey(1))
    buf = np.zeros((2, 40960), np.float32)
    buf[0] = synth_speech_i16(40960, seed=11)
    buf[1] = synth_speech_i16(40960, seed=12)
    n = np.array([40960, 40960])
    for default, strict in (
        (OverlapPredictor(ov_vars),
         OverlapPredictor(ov_vars, matmul_precision="highest")),
        (SpeakerPredictor(sp_vars),
         SpeakerPredictor(sp_vars, matmul_precision="highest")),
    ):
        ld, pd = default.predict(buf, n)
        ls, ps = strict.predict(buf, n)
        np.testing.assert_array_equal(np.asarray(ld), np.asarray(ls))
        np.testing.assert_array_equal(np.asarray(pd), np.asarray(ps))


def test_matmul_precision_auto_defaults():
    """'auto' resolves per model to the measured default (PARITY.md): the
    overlap trunk stays fast (conv-heavy, 2.2x for a guarantee the default
    already meets), the speaker trunk forces 'highest' (~10 % for
    0.984 -> 1.000 cross-backend label agreement)."""
    ov_vars = OverlapResBLSTM(
        OverlapModelConfig(stage_filters=(4, 4, 4), lstm_units=8)
    ).init_variables(jax.random.PRNGKey(0))
    sp_vars = SpeakerResBLSTM(
        SpeakerModelConfig(stage_filters=(4, 4, 4), lstm_units=8,
                           num_speakers=4)
    ).init_variables(jax.random.PRNGKey(1))
    ov_cfg = OverlapModelConfig(stage_filters=(4, 4, 4), lstm_units=8)
    sp_cfg = SpeakerModelConfig(stage_filters=(4, 4, 4), lstm_units=8,
                                num_speakers=4)
    assert OverlapPredictor(ov_vars, ov_cfg).matmul_precision is None
    assert SpeakerPredictor(sp_vars, sp_cfg).matmul_precision == "highest"
    # explicit None is the fast knob on both
    assert SpeakerPredictor(sp_vars, sp_cfg,
                            matmul_precision=None).matmul_precision is None
    # explicit choice always wins
    assert OverlapPredictor(
        ov_vars, ov_cfg, matmul_precision="highest"
    ).matmul_precision == "highest"


def test_overlap_single_window_api():
    model = OverlapResBLSTM()
    variables = model.init_variables(jax.random.PRNGKey(0))
    pred = OverlapPredictor(variables)
    buf = np.zeros(40960, np.float32)
    sig = synth_speech_i16(24000, seed=3)
    buf[:24000] = sig
    label, probs = pred.predict(buf, 24000)
    assert np.asarray(label).shape == ()
    assert probs.shape == (2,)


def test_speaker_predict_end_to_end():
    model = SpeakerResBLSTM()
    variables = model.init_variables(jax.random.PRNGKey(0))
    pred = SpeakerPredictor(variables)
    buf = np.zeros((3, 40960), np.float32)
    for i in range(2):
        buf[i] = synth_speech_i16(40960, seed=4 + i)
    n = np.array([40960, 40960, 1000])
    labels, probs = pred.predict(buf, n)
    labels = np.asarray(labels)
    assert labels.shape == (3,)
    assert 0 <= labels[0] < 630 and 0 <= labels[1] < 630
    assert labels[2] == SILENT
    assert probs.shape == (3, 630)


def test_transfer_head_predictor():
    model = SpeakerResBLSTM(head_units=3)
    variables = model.init_variables(jax.random.PRNGKey(0))
    pred = SpeakerPredictor(variables, head_units=3, sigmoid_head=True)
    buf = np.zeros((1, 40960), np.float32)
    buf[0] = synth_speech_i16(40960, seed=9)
    labels, probs = pred.predict(buf, np.array([40960]))
    assert probs.shape == (1, 3)
    assert ((np.asarray(probs) >= 0) & (np.asarray(probs) <= 1)).all()


def test_session_log_format(tmp_path):
    log = SessionLog(tmp_path / "s.txt", kind="overlap", start_index=1)
    log.append("non-overlapped")
    log.append("silent")
    text = (tmp_path / "s.txt").read_text().splitlines()
    assert text[0] == "segment\toverlapped degree\ttimestamp"
    seg, label, ts = text[1].split("\t")
    assert seg == "1" and label == "non-overlapped"
    # str(datetime.today()) format: 'YYYY-MM-DD HH:MM:SS.ffffff'
    assert len(ts.split(" ")) == 2 and "-" in ts and ":" in ts
    rows = parse_log(tmp_path / "s.txt")
    assert rows == [(1, "non-overlapped", rows[0][2]), (2, "silent", rows[1][2])]


def test_post_time_log_timestamps(tmp_path):
    from datetime import datetime
    log = SessionLog(tmp_path / "p.txt", kind="speaker", start_index=0,
                     overwrite=True)
    t0 = datetime(2026, 1, 1, 12, 0, 0)
    log.append_batch(["alice", "bob", "silent"], t0, 2.56)
    rows = parse_log(tmp_path / "p.txt")
    assert [r[0] for r in rows] == [0, 1, 2]
    assert rows[0][2] == "2026-01-01 12:00:00"
    assert rows[1][2] == "2026-01-01 12:00:02.560000"
    labels = OVERLAP_LABELS_3WAY
    assert labels["2"] == "silent"


def test_odd_input_dtypes_cast_to_float32():
    """int16/float32 pass through _as_device_pcm untouched; any other dtype
    (float64 host buffers, int32 from a decoder) casts to float32 host-side
    and must land on the exact same labels/probs as the float32 call."""
    cfg = OverlapModelConfig(stage_filters=(4, 4, 4), lstm_units=8)
    pred = OverlapPredictor(
        OverlapResBLSTM(cfg).init_variables(jax.random.PRNGKey(0)),
        model_cfg=cfg)
    buf = synth_speech_i16(40960, seed=5).astype(np.float32)
    n = np.array([40960], np.int32)
    want_l, want_p = pred.predict(buf[None], n)
    for dtype in (np.float64, np.int32):
        got_l, got_p = pred.predict(buf[None].astype(dtype), n)
        np.testing.assert_array_equal(np.asarray(got_l), np.asarray(want_l))
        np.testing.assert_array_equal(np.asarray(got_p), np.asarray(want_p))


def test_speaker_predictor_fast_mode_single_window():
    """matmul_precision=None (the explicit fast opt-out) through the 1-D
    single-window predict API."""
    cfg = SpeakerModelConfig(stage_filters=(4, 4, 4), lstm_units=8,
                             num_speakers=3)
    pred = SpeakerPredictor(
        SpeakerResBLSTM(cfg).init_variables(jax.random.PRNGKey(1)),
        model_cfg=cfg, matmul_precision=None)
    label, probs = pred.predict(synth_speech_i16(40960, seed=3), 40960)
    assert probs.shape == (3,)
    assert int(label) in (SILENT, 0, 1, 2)
