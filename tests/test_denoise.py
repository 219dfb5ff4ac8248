"""Spectral-gating denoise vs the NumPy/SciPy golden + properties."""

import numpy as np
import jax.numpy as jnp

from tests.conftest import synth_speech
from tests.golden import noisereduce_ref as gold

from mmla_audio_tpu.core.config import DenoiseConfig
from mmla_audio_tpu.ops.denoise import (
    amp_to_db,
    noise_threshold,
    reduce_noise,
    smoothing_filter,
)


def _noise(n, seed=0, amp=0.01):
    return (np.random.RandomState(seed).randn(n) * amp).astype(np.float32)


def test_smoothing_filter_matches():
    ours = smoothing_filter(16000, 1024, 256, 500.0, 50.0)
    ref = gold._smoothing_filter()
    np.testing.assert_allclose(ours, ref, atol=1e-7)
    np.testing.assert_allclose(ours.sum(), 1.0, rtol=1e-5)


def test_amp_to_db_matches():
    x = np.abs(np.random.RandomState(0).randn(32, 16)) + 1e-6
    ours = np.asarray(amp_to_db(jnp.asarray(x)))
    ref = gold._amp_to_db(x)
    np.testing.assert_allclose(ours, ref, atol=1e-4)


def test_noise_threshold_matches():
    noise = _noise(160000, seed=1)
    ours = np.asarray(noise_threshold(jnp.asarray(noise)))
    S = gold._stft(noise.astype(np.float64))
    db = gold._amp_to_db(np.abs(S))
    ref = db.mean(axis=1) + db.std(axis=1) * 1.5
    np.testing.assert_allclose(ours, ref, atol=2e-2)


def test_reduce_noise_matches_golden():
    noise = _noise(160000, seed=2)
    sig = synth_speech(40960, seed=3) + _noise(40960, seed=4)
    thr = noise_threshold(jnp.asarray(noise))
    ours = np.asarray(reduce_noise(jnp.asarray(sig), thr))
    ref = gold.reduce_noise(sig.astype(np.float64), noise.astype(np.float64))
    assert ours.shape == ref.shape
    scale = np.abs(ref).max()
    np.testing.assert_allclose(ours, ref, atol=5e-3 * scale)


def test_reduce_noise_attenuates_pure_noise():
    noise_clip = _noise(160000, seed=5, amp=0.02)
    window = _noise(40960, seed=6, amp=0.02)
    thr = noise_threshold(jnp.asarray(noise_clip))
    out = np.asarray(reduce_noise(jnp.asarray(window), thr))
    assert np.sqrt((out ** 2).mean()) < 0.25 * np.sqrt((window ** 2).mean())


def test_reduce_noise_preserves_loud_tone():
    sr = 16000
    noise_clip = _noise(160000, seed=7, amp=0.005)
    t = np.arange(40960) / sr
    tone = (0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    window = tone + _noise(40960, seed=8, amp=0.005)
    thr = noise_threshold(jnp.asarray(noise_clip))
    out = np.asarray(reduce_noise(jnp.asarray(window), thr))
    # The smoothed mask dilutes a single-bin tone to ~0.5 amplitude (same as
    # real noisereduce); what must survive is the tone SHAPE, not full energy.
    corr = np.corrcoef(out, tone)[0, 1]
    assert corr > 0.95, corr
    assert np.sqrt((out ** 2).mean()) > 0.3 * np.sqrt((tone ** 2).mean())


def test_reduce_noise_batched_matches_single():
    """Batched denoise must be BIT-identical to per-window denoise on the
    host backend: the multiplexer's batched chain feeds the same webrtcvad
    state threading as the per-stream sessions, so one flipped int16 sample
    desynchronizes the detector-state equality contract.  Regression pin for
    the einsum('...tk,ts->...sk') time-smoothing form, whose batched
    XLA:CPU lowering used a different accumulation order than the
    single-window form (~10-20 flipped samples per window at the
    quantization boundary)."""
    import jax

    from mmla_audio_tpu.ops.denoise import quantize_i16

    noise_clip = _noise(160000, seed=9)
    thr = noise_threshold(jnp.asarray(noise_clip))
    w0 = synth_speech(40960, seed=10) * 0.2
    w1 = synth_speech(40960, seed=11) * 0.2
    batch = np.asarray(reduce_noise(jnp.asarray(np.stack([w0, w1])), thr))
    s0 = np.asarray(reduce_noise(jnp.asarray(w0), thr))
    s1 = np.asarray(reduce_noise(jnp.asarray(w1), thr))
    np.testing.assert_array_equal(batch[0], s0)
    np.testing.assert_array_equal(batch[1], s1)

    # and through jit+vmap (the multiplexer arrangement), post-quantization
    def chain(y):
        return quantize_i16(reduce_noise(y, thr))

    # compare EVERY batch row (batched-lowering divergence can hit only
    # non-leading rows via tiling/remainder paths)
    b = np.asarray(jax.jit(jax.vmap(chain))(jnp.asarray(np.stack([w0, w1]))))
    q0 = np.asarray(jax.jit(chain)(jnp.asarray(w0)))
    q1 = np.asarray(jax.jit(chain)(jnp.asarray(w1)))
    np.testing.assert_array_equal(b[0], q0)
    np.testing.assert_array_equal(b[1], q1)


def test_multi_pass():
    noise_clip = _noise(160000, seed=12, amp=0.02)
    window = _noise(40960, seed=13, amp=0.02)
    thr = noise_threshold(jnp.asarray(noise_clip))
    out1 = np.asarray(reduce_noise(jnp.asarray(window), thr, passes=1))
    out3 = np.asarray(reduce_noise(jnp.asarray(window), thr, passes=3))
    assert np.sqrt((out3 ** 2).mean()) <= np.sqrt((out1 ** 2).mean()) + 1e-9


def test_banded_gemm_smoothing_matches_conv2d():
    """The rank-1 factored banded-GEMM smoothing must equal the literal 2-D
    'same' convolution with the outer-product kernel (the noisereduce form)."""
    import scipy.signal

    from mmla_audio_tpu.ops.denoise import (
        _band_matrix,
        _smoothing_factors,
        smoothing_filter,
    )

    sr, n_fft, hop = 16000, 1024, 256
    filt = smoothing_filter(sr, n_fft, hop, 500.0, 50.0)
    v_f, v_t = _smoothing_factors(sr, n_fft, hop, 500.0, 50.0)
    # factors reassemble the kernel exactly
    np.testing.assert_allclose(np.outer(v_f, v_t), filt, atol=1e-8)

    rng = np.random.RandomState(5)
    T, K = 47, 61
    mask = (rng.rand(T, K) > 0.5).astype(np.float32)
    # reference: true 2-D convolution over (freq, time) = (K, T) layout
    ref = scipy.signal.convolve2d(mask.T, filt, mode="same").T

    mf = _band_matrix(v_f, K)
    mt = _band_matrix(v_t, T)
    got = np.asarray(jnp.einsum(
        "tk,ts->sk", jnp.asarray(mask) @ jnp.asarray(mf), jnp.asarray(mt)))
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_short_pad_matches_full_pad():
    """The phase-aligned short chunk pad must reproduce the literal
    30000-sample noisereduce padding to fp tolerance (the frame grid over
    the signal is sample-identical; all edge effects stay in the zero
    region)."""
    from mmla_audio_tpu.ops.denoise import (
        _chunk_pad,
        noise_threshold,
        reduce_noise,
    )
    from mmla_audio_tpu.core.config import DenoiseConfig

    cfg = DenoiseConfig()
    pad = _chunk_pad(cfg, 16000)
    assert pad < 30000 and pad % cfg.hop_length == 30000 % cfg.hop_length

    rng = np.random.RandomState(11)
    t = np.arange(40960) / 16000.0
    sig = (0.3 * np.sin(2 * np.pi * 300 * t)
           * (np.sin(2 * np.pi * 1.3 * t) > 0)
           + 0.01 * rng.randn(len(t))).astype(np.float32)
    noise = (0.01 * rng.randn(160000)).astype(np.float32)
    nt = noise_threshold(jnp.asarray(noise), cfg)

    for passes in (1, 3):
        short = np.asarray(reduce_noise(jnp.asarray(sig), nt, cfg,
                                        passes=passes))
        full = np.asarray(reduce_noise(jnp.asarray(sig), nt, cfg,
                                       passes=passes, full_pad=True))
        np.testing.assert_allclose(short, full, atol=2e-6)


def test_precision_config_threads_into_gemms():
    """``DenoiseConfig.precision`` must reach every STFT/ISTFT/smoothing
    dot in the traced program (CPU ignores precision at runtime, so this
    pins the *trace*: a silent drop of the flag would only surface as a
    GPU-only parity regression)."""
    import dataclasses
    import jax

    noise = _noise(160000, seed=3)
    sig = jnp.asarray(_noise(40960, seed=4, amp=0.1))

    for prec, expect in (("highest", jax.lax.Precision.HIGHEST),
                         ("high", jax.lax.Precision.HIGH),
                         ("default", jax.lax.Precision.DEFAULT)):
        cfg = dataclasses.replace(DenoiseConfig(), precision=prec)
        nt = noise_threshold(jnp.asarray(noise), cfg)
        jaxpr = jax.make_jaxpr(
            lambda y: reduce_noise(y, nt, cfg))(sig)
        precisions = [
            eqn.params["precision"]
            for eqn in jaxpr.jaxpr.eqns
            if eqn.primitive.name == "dot_general"
        ]
        assert precisions, "denoise lost its GEMM formulation"
        assert all(p == (expect, expect) for p in precisions), (
            prec, set(precisions))


def test_reduce_noise_fallback_paths_match_golden():
    """hop that does NOT divide n_fft disables both fast paths (split-GEMM
    framing and shifted-pad overlap-add) and takes the literal framing +
    scatter overlap-add fallbacks — those must match the NumPy golden just
    like the fast paths (same noisereduce semantics, different schedule)."""
    import dataclasses

    cfg = dataclasses.replace(DenoiseConfig(), hop_length=320)
    assert cfg.n_fft % cfg.hop_length != 0
    noise = _noise(160000, seed=12)
    sig = synth_speech(40960, seed=13) + _noise(40960, seed=14)
    thr = noise_threshold(jnp.asarray(noise), cfg)
    ours = np.asarray(reduce_noise(jnp.asarray(sig), thr, cfg, full_pad=True))
    ref = gold.reduce_noise(sig.astype(np.float64), noise.astype(np.float64),
                            hop=320)
    assert ours.shape == ref.shape
    scale = np.abs(ref).max()
    np.testing.assert_allclose(ours, ref, atol=5e-3 * scale)
