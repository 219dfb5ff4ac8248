"""WebRTC-architecture GMM voice-activity detector, as parallel device ops.

The reference's per-frame speech decision is webrtcvad — WebRTC's adaptive
GMM VAD (`OverlapDetection/scripts/record_on_pc.py:33,246-295` uses
``Vad(3)`` over 30 ms frames).  This module implements the same detector
architecture device-side:

* a six-band analysis filterbank built from half-band allpass-pair split
  filters (split at 2 kHz, 3 kHz, 1 kHz, 500 Hz, 250 Hz; 80 Hz high-pass on
  the lowest band), yielding log energies for 80-250 / 250-500 / 500-1000 /
  1000-2000 / 2000-3000 / 3000-4000 Hz per 30 ms frame;
* per band, two-component Gaussian mixtures for noise and for speech over
  the log-energy feature, evaluated as a likelihood-ratio test: speech is
  declared when the spectrum-weighted global log-LR **or** any single band's
  log-LR exceeds its (aggressiveness-dependent) threshold;
* sequential model adaptation across frames (`lax.scan`): the winning
  component of the decided class tracks the observation, with minimum-
  statistics clamping so the noise model can follow a rising floor but never
  climbs above the running energy minimum.

Device details:

* WebRTC's filters are first/second-order IIRs (sample-serial).  Here each
  one is converted to a truncated-FIR equivalent via its impulse response
  (allpass pole 0.64 -> 64 taps leaves < 1e-11 residual), so the whole
  filterbank is a stack of causal convolutions — fully parallel, no
  per-sample scan.
* The noise mixtures initialise from the session's 10 s ambient-noise
  calibration (the reference records one anyway), which is strictly more
  information than WebRTC's fixed spectral priors; the speech mixtures start
  at calibrated-noise + typical-SNR offsets and adapt.

**Status: benchmark/reference probe, not a serving option**.  This module is the *float approximation* of
webrtcvad — detector architecture and aggressiveness semantics, with the
noise model initialised from the session's calibration clip instead of
WebRTC's fixed priors.  It was the round-2 stepping stone toward the
bit-exact engine; once ``vad/webrtc.py`` (the int32 transcription of the
published fixed-point algorithm, golden-pinned in
``tests/test_vad_webrtc.py``) landed, gmm became strictly dominated — less
faithful than webrtc (invented thresholds below), slower than energy —
so it was removed from
``VadConfig.decision``.  It remains exercised by
``benchmarks/vad_agreement.py`` / ``vad_latency.py`` (pass ``gmm_state``
explicitly to ``preprocess_window``) and unit-tested as an algorithm
reference.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["GmmVadState", "band_log_energies", "gmm_init_from_noise",
           "gmm_vad", "GMM_THRESHOLDS"]

_N_BANDS = 6
_FIR_TAPS = 64
# WebRTC's split-filter allpass coefficients (vad_filterbank.c, Q13 5243 and
# 1392 -> 0.64 and 0.17).
_AP_UPPER = 0.64
_AP_LOWER = 0.17
# Spectrum weights per band, low to high (vad_core.c kSpectrumWeight).
_SPECTRUM_WEIGHT = np.asarray([6.0, 8.0, 10.0, 12.0, 14.0, 16.0])
_SPECTRUM_WEIGHT /= _SPECTRUM_WEIGHT.sum()

# Aggressiveness -> (global weighted log-LR threshold, per-band local
# threshold).  Monotone in aggressiveness, matching Vad(0..3) semantics:
# higher mode demands stronger evidence for "speech".
GMM_THRESHOLDS = {
    0: (0.5, 2.0),
    1: (1.0, 3.0),
    2: (1.5, 4.0),
    3: (2.0, 5.0),
}

# Frames whose total energy is below this (dBFS-ish, int16 domain) are never
# speech — WebRTC's kMinEnergy short-circuit.
_MIN_ENERGY_DB = 10.0   # ~1 LSB RMS in int16 scale


def _allpass_fir(a: float, n: int = _FIR_TAPS) -> np.ndarray:
    """Truncated impulse response of H(z) = (a + z^-1) / (1 + a z^-1)."""
    h = np.zeros(n)
    h[0] = a
    h[1:] = (1.0 - a * a) * (-a) ** np.arange(n - 1)
    return h


def _hp80_fir(n: int = _FIR_TAPS) -> np.ndarray:
    """80 Hz high-pass biquad applied to the 0-250 Hz band at 500 Hz rate
    (vad_filterbank.c HighPassFilter coefficients,
    Q14 {6631,-13262,6631}/{16384,-7756,5620}), FIR-ized."""
    b = np.asarray([6631.0, -13262.0, 6631.0]) / 16384.0
    a = np.asarray([16384.0, -7756.0, 5620.0]) / 16384.0
    h = np.zeros(n)
    x = np.zeros(n)
    x[0] = 1.0
    s1 = s2 = 0.0
    for i in range(n):          # direct form II transposed impulse response
        y = b[0] * x[i] + s1
        s1 = b[1] * x[i] - a[1] * y + s2
        s2 = b[2] * x[i] - a[2] * y
        h[i] = y
    return h


# host numpy constants — a module-level jnp.asarray would device_put at
# IMPORT time, forcing backend init; jnp ops fold these at trace time
# instead
_H_UPPER = _allpass_fir(_AP_UPPER).astype(np.float32)
_H_LOWER = _allpass_fir(_AP_LOWER).astype(np.float32)
_H_HP80 = _hp80_fir().astype(np.float32)


def _corr(xp: jnp.ndarray, h: jnp.ndarray, n: int) -> jnp.ndarray:
    """Causal FIR over the (already left-padded) last axis: gathers sliding
    windows and contracts against the reversed taps — one fused VPU op, no
    per-sample recursion."""
    k = h.shape[0]
    idx = jnp.arange(n)[:, None] + jnp.arange(k)[None, :]
    # window [n .. n+k-1] of padded signal against reversed taps
    return jnp.sum(xp[..., idx] * h[::-1], axis=-1)


def _split(x: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Half-band split + decimate-by-2: (high band, low band), each at half
    the input rate (SplitFilter: hp = A0(x_even) - A1(x_odd), lp = sum)."""
    up = _corr(jnp.pad(x[..., 0::2], [(0, 0)] * (x.ndim - 1)
                       + [(_FIR_TAPS - 1, 0)]), _H_UPPER, x.shape[-1] // 2)
    lo = _corr(jnp.pad(x[..., 1::2], [(0, 0)] * (x.ndim - 1)
                       + [(_FIR_TAPS - 1, 0)]), _H_LOWER, x.shape[-1] // 2)
    return up - lo, up + lo


def band_log_energies(x: jnp.ndarray, frame_len: int = 480) -> jnp.ndarray:
    """int16-scale signal ``(n,)`` -> per-frame band log energies ``(T, 6)``
    in dB, T = n // frame_len (30 ms at 16 kHz).

    The filterbank runs over the whole window (continuous state, like the
    persistent filter memory of a long-lived webrtcvad instance), then each
    decimated band is framed at its own rate.
    """
    n = x.shape[-1]
    T = n // frame_len
    # webrtcvad first decimates 16 kHz -> 8 kHz (WebRtcVad_CalcVad16khz);
    # the 4-8 kHz half is discarded.
    _, x8 = _split(x)                               # 8 kHz rate   (decim 2)
    hp24, lp02 = _split(x8)                         # 4 kHz rate   (decim 4)
    # hp24 holds 2-4 kHz decimated by 2 => spectrally INVERTED (original
    # 4 kHz at DC), so the next split's high output is the *lower* original
    # sub-band: hp -> 2-3 kHz, lp -> 3-4 kHz.
    b23, b34 = _split(hp24)                         # 2 kHz rate   (decim 8)
    b12, lp01 = _split(lp02)                        # 2 kHz rate   (decim 8)
    b051, lp005 = _split(lp01)                      # 1 kHz rate   (decim 16)
    b0205, lp0025 = _split(lp005)                   # 500 Hz rate  (decim 32)
    b008 = _corr(jnp.pad(lp0025, [(0, 0)] * (x.ndim - 1)
                         + [(_FIR_TAPS - 1, 0)]), _H_HP80,
                 lp0025.shape[-1])                  # 500 Hz: 80-250 Hz

    def frame_energy(sig, decim):
        m = frame_len // decim
        s = sig[..., : T * m]
        new_shape = s.shape[:-1] + (T, m)
        e = jnp.mean(jnp.square(s.reshape(new_shape)), axis=-1)
        return 10.0 * jnp.log10(jnp.maximum(e, 1e-10))

    bands = [frame_energy(b008, 32), frame_energy(b0205, 32),
             frame_energy(b051, 16), frame_energy(b12, 8),
             frame_energy(b23, 8), frame_energy(b34, 8)]
    return jnp.stack(bands, axis=-1)                # (..., T, 6)


class GmmVadState(NamedTuple):
    """Per-band two-component mixtures over log energy (dB domain)."""
    noise_mean: jnp.ndarray      # (6, 2)
    noise_std: jnp.ndarray       # (6, 2)
    speech_mean: jnp.ndarray     # (6, 2)
    speech_std: jnp.ndarray      # (6, 2)
    min_track: jnp.ndarray       # (6,) running energy minimum per band


def gmm_init_from_noise(noise_i16: np.ndarray,
                        frame_len: int = 480) -> GmmVadState:
    """Initialise the mixtures from the session's ambient-noise calibration
    clip (the 10 s recording of `record_on_pc.py:302-322`)."""
    x = jnp.asarray(np.asarray(noise_i16, np.float32))
    e = np.asarray(band_log_energies(x, frame_len))      # (T, 6)
    if e.shape[0] == 0:
        e = np.full((1, _N_BANDS), -10.0, np.float32)
    mean = e.mean(axis=0)                                # (6,)
    std = np.maximum(e.std(axis=0), 1.5)
    noise_mean = np.stack([mean - 0.5 * std, mean + 0.5 * std], axis=-1)
    noise_std = np.stack([std, std], axis=-1)
    # speech prior: calibrated floor + typical near-field SNR offsets
    speech_mean = np.stack([mean + 12.0, mean + 24.0], axis=-1)
    speech_std = np.full((_N_BANDS, 2), 6.0)
    return GmmVadState(
        noise_mean=jnp.asarray(noise_mean, jnp.float32),
        noise_std=jnp.asarray(noise_std, jnp.float32),
        speech_mean=jnp.asarray(speech_mean, jnp.float32),
        speech_std=jnp.asarray(speech_std, jnp.float32),
        min_track=jnp.asarray(mean, jnp.float32),
    )


def _log_mix(e, means, stds):
    """log( 0.5 N(e; m0, s0) + 0.5 N(e; m1, s1) ) per band; e (6,)."""
    z = (e[:, None] - means) / stds
    comp = -0.5 * z * z - jnp.log(stds) - 0.9189385  # log N, log(sqrt(2pi))
    return jax.nn.logsumexp(comp + jnp.log(0.5), axis=-1)   # (6,)


def gmm_vad(x: jnp.ndarray, state: GmmVadState, *,
            aggressiveness: int = 3, frame_len: int = 480,
            adapt: bool = True) -> tuple[jnp.ndarray, GmmVadState]:
    """Per-frame speech decisions for one window.

    ``x``: int16-scale signal ``(n,)``.  Returns ``(decisions (T,) bool,
    final model state)``; thread the state across windows for a long-lived
    detector, or re-pass the calibrated state for per-window independence.
    """
    g_thr, l_thr = GMM_THRESHOLDS[int(aggressiveness)]
    energies = band_log_energies(x, frame_len)           # (T, 6)
    total_db = 10.0 * jnp.log10(jnp.maximum(
        jnp.mean(jnp.square(x[: (x.shape[-1] // frame_len) * frame_len]
                            .reshape(-1, frame_len)), axis=-1), 1e-10))
    w = jnp.asarray(_SPECTRUM_WEIGHT, jnp.float32)

    def step(st: GmmVadState, inp):
        e, tot = inp                                     # (6,), scalar
        llr = _log_mix(e, st.speech_mean, st.speech_std) \
            - _log_mix(e, st.noise_mean, st.noise_std)   # (6,)
        is_speech = ((jnp.sum(w * llr) > g_thr) | jnp.any(llr > l_thr)) \
            & (tot > _MIN_ENERGY_DB)

        if not adapt:
            return st, is_speech
        # --- adaptation (winning component of the decided class tracks e,
        # losing class drifts slowly; minimum statistics clamp the noise) ---
        min_track = jnp.minimum(st.min_track * 0.998 + 0.002 * e, e)

        def upd(means, stds, rate):
            z = jnp.abs(e[:, None] - means) / stds
            win = jnp.argmin(z, axis=-1)                 # (6,)
            onehot = jax.nn.one_hot(win, 2)
            m = means + rate * onehot * (e[:, None] - means)
            s = stds + rate * onehot * (jnp.abs(e[:, None] - m) - stds)
            return m, jnp.clip(s, 1.0, 12.0)

        nm, ns = upd(st.noise_mean, st.noise_std,
                     jnp.where(is_speech, 0.0, 0.05))
        sm, ss = upd(st.speech_mean, st.speech_std,
                     jnp.where(is_speech, 0.05, 0.0))
        # the noise model may never rise far above the tracked minimum
        nm = jnp.minimum(nm, (min_track + 6.0)[:, None])
        # keep the hypotheses separated
        sm = jnp.maximum(sm, nm.max(axis=-1, keepdims=True) + 4.0)
        new = GmmVadState(nm, ns, sm, ss, min_track)
        return new, is_speech

    final, decisions = jax.lax.scan(step, state, (energies, total_db))
    return decisions, final
