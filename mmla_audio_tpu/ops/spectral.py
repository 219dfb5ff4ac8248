"""Spectral DSP primitives, built as matrix products.

Replaces the librosa calls of the reference front-end
(`OverlapDetection/scripts/overlap_features_generator.py:65-101`) with
fixed-shape JAX ops.  The design rule: every per-frame transform is a single
batched matmul that XLA hands to the GEMM libraries —

    frames (B*T, win) @ [cos|sin] basis (win, 2*(n_fft//2+1))  ->  spectrum
    power   (B, T, bins) @ mel_fb.T (bins, n_mels)             ->  mel

instead of an FFT micro-kernel with awkward shapes.  At these sizes
(win 400-512, 151-256 frames/window) the DFT-as-GEMM is exactly
reproducible against the NumPy golden.

Semantics follow librosa 0.8 (the reference pins numpy 1.21 / numba 0.53,
`setup.py:32-41`): centered STFT with reflect padding, periodic Hann,
power-2 spectrum, Slaney mel filterbank (fmax = sr/2), ``power_to_db`` with
ref=max and top_db=80.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "hann_periodic",
    "frame_signal",
    "stft_power",
    "mel_filterbank",
    "melspectrogram_power",
    "power_to_db",
    "minmax_normalize",
    "zero_crossing_rate",
]


def hann_periodic(win_length: int) -> np.ndarray:
    """Periodic Hann window — scipy.signal.get_window('hann', n, fftbins=True)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dft_basis(n_fft: int, win_length: int, windowed: bool = True):
    """Real-DFT basis matrices, optionally pre-multiplied by the Hann window.

    Returns ``(cos, sin)`` each of shape ``(win_length, n_fft // 2 + 1)`` so a
    frame matrix ``(N, win)`` contracts to the half spectrum in one GEMM.
    """
    k = np.arange(n_fft // 2 + 1)
    t = np.arange(win_length)
    ang = 2.0 * np.pi * np.outer(t, k) / n_fft
    cos = np.cos(ang)
    sin = -np.sin(ang)
    if windowed:
        w = hann_periodic(win_length)[:, None].astype(np.float64)
        cos = cos * w
        sin = sin * w
    return cos.astype(np.float32), sin.astype(np.float32)


def frame_signal(y: jnp.ndarray, frame_length: int, hop_length: int,
                 n_frames: int) -> jnp.ndarray:
    """Slice ``y (..., n_samples)`` into ``(..., n_frames, frame_length)``.

    Static-shape gather; ``y`` must already contain any centering padding.
    """
    idx = (np.arange(n_frames)[:, None] * hop_length
           + np.arange(frame_length)[None, :])
    return y[..., idx]


def _center_pad_reflect(y: jnp.ndarray, pad: int) -> jnp.ndarray:
    """librosa-style centered reflect padding along the last axis."""
    cfg = [(0, 0)] * (y.ndim - 1) + [(pad, pad)]
    return jnp.pad(y, cfg, mode="reflect")


def stft_power(y: jnp.ndarray, n_fft: int, hop_length: int,
               center: bool = True, pad_mode: str = "reflect") -> jnp.ndarray:
    """Power spectrogram ``|STFT|^2`` of ``y (..., n_samples)``.

    librosa.stft semantics with ``win_length == n_fft``, periodic Hann,
    centered reflect padding.  Output: ``(..., n_fft//2+1, n_frames)`` with
    ``n_frames = 1 + n_samples // hop`` when centered.
    """
    n_samples = y.shape[-1]
    if center:
        if pad_mode == "reflect":
            y = _center_pad_reflect(y, n_fft // 2)
        else:
            cfg = [(0, 0)] * (y.ndim - 1) + [(n_fft // 2, n_fft // 2)]
            y = jnp.pad(y, cfg)
        n_frames = 1 + n_samples // hop_length
    else:
        n_frames = 1 + (n_samples - n_fft) // hop_length
    frames = frame_signal(y, n_fft, hop_length, n_frames)       # (..., T, win)
    cos, sin = _dft_basis(n_fft, n_fft, windowed=True)
    # HIGHEST: these GEMMs define features the labels depend on; a float32
    # dot at default precision may run in TF32 on a GPU (about three decimal
    # digits) and break golden parity.
    re = jnp.matmul(frames, cos, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    im = jnp.matmul(frames, sin, preferred_element_type=jnp.float32,
                    precision=jax.lax.Precision.HIGHEST)
    power = re * re + im * im                                    # (..., T, bins)
    return jnp.swapaxes(power, -1, -2)                           # (..., bins, T)


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = f >= min_log_hz
    mels = np.where(log_region,
                    min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    mels)
    return mels


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = m >= min_log_mel
    freqs = np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)
    return freqs


@functools.lru_cache(maxsize=None)
def mel_filterbank(sr: int, n_fft: int, n_mels: int,
                   fmin: float = 0.0, fmax: float | None = None,
                   htk: bool = False, norm: str | None = "slaney") -> np.ndarray:
    """Triangular mel filterbank ``(n_mels, n_fft//2 + 1)``.

    ``htk=False`` matches librosa.filters.mel defaults (Slaney scale + Slaney
    area normalization) used by the overlap features; ``htk=True`` gives the
    2595*log10(1+f/700) scale used by python_speech_features MFCCs.
    """
    if fmax is None:
        fmax = sr / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sr / 2.0, n_bins)
    if htk:
        def to_mel(f):
            return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)

        def to_hz(m):
            return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)
    else:
        to_mel, to_hz = _hz_to_mel_slaney, _mel_to_hz_slaney

    mel_pts = np.linspace(to_mel(fmin), to_mel(fmax), n_mels + 2)
    hz_pts = to_hz(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (hz_pts[2: n_mels + 2] - hz_pts[:n_mels])
        fb = fb * enorm[:, None]
    return fb.astype(np.float32)


def melspectrogram_power(y: jnp.ndarray, sr: int, n_fft: int, hop_length: int,
                         n_mels: int, fmin: float = 0.0,
                         fmax: float | None = None) -> jnp.ndarray:
    """librosa.feature.melspectrogram(power=2):  mel_fb @ |STFT|^2.

    ``y (..., n_samples)`` -> ``(..., n_mels, n_frames)``.
    """
    power = stft_power(y, n_fft, hop_length)                    # (..., bins, T)
    fb = jnp.asarray(mel_filterbank(sr, n_fft, n_mels, fmin, fmax))
    return jnp.einsum("mb,...bt->...mt", fb, power,
                      precision=jax.lax.Precision.HIGHEST)


def power_to_db(S: jnp.ndarray, ref: str | float = "max", amin: float = 1e-10,
                top_db: float | None = 80.0,
                reduce_axes: tuple | None = None) -> jnp.ndarray:
    """librosa.power_to_db.  ``ref='max'`` couples each spectrogram to its own
    peak (``overlap_features_generator.py:82``); ``reduce_axes`` selects which
    trailing axes form "one spectrogram" when batched (default: all axes).
    """
    if ref == "max":
        if reduce_axes is None:
            ref_value = jnp.max(S)
        else:
            ref_value = jnp.max(S, axis=reduce_axes, keepdims=True)
    else:
        ref_value = jnp.abs(jnp.asarray(ref, dtype=S.dtype))
    log_spec = 10.0 * jnp.log10(jnp.maximum(amin, S))
    log_spec = log_spec - 10.0 * jnp.log10(jnp.maximum(amin, ref_value))
    if top_db is not None:
        if reduce_axes is None:
            peak = jnp.max(log_spec)
        else:
            peak = jnp.max(log_spec, axis=reduce_axes, keepdims=True)
        log_spec = jnp.maximum(log_spec, peak - top_db)
    return log_spec


def minmax_normalize(m: jnp.ndarray, reduce_axes: tuple | None = None) -> jnp.ndarray:
    """(m - min) / (max - min) — overlap_features_generator.py:103-117, minus
    the O(N^2) Python loop."""
    if reduce_axes is None:
        mn, mx = jnp.min(m), jnp.max(m)
    else:
        mn = jnp.min(m, axis=reduce_axes, keepdims=True)
        mx = jnp.max(m, axis=reduce_axes, keepdims=True)
    # degenerate (constant) spectrograms -> 0 instead of NaN; the reference
    # would divide by zero here, but that only happens for exactly-silent
    # windows which its VAD gate intercepts earlier.
    diff = mx - mn
    return jnp.where(diff > 0, (m - mn) / jnp.where(diff > 0, diff, 1.0), 0.0)


def zero_crossing_rate(y: jnp.ndarray, frame_length: int, hop_length: int,
                       center: bool = True, threshold: float = 1e-10) -> jnp.ndarray:
    """librosa.feature.zero_crossing_rate for ``y (..., n_samples)``.

    Edge-pads by ``frame_length // 2`` when centered, frames, then counts
    sign-bit changes between consecutive samples within each frame (zeros and
    positives share a sign bit; ``|y| <= threshold`` snaps to +0).  Returns
    ``(..., n_frames)`` with ``n_frames = 1 + n_samples // hop`` centered.
    """
    n_samples = y.shape[-1]
    if center:
        cfg = [(0, 0)] * (y.ndim - 1) + [(frame_length // 2, frame_length // 2)]
        y = jnp.pad(y, cfg, mode="edge")
        n_frames = 1 + n_samples // hop_length
    else:
        n_frames = 1 + (n_samples - frame_length) // hop_length
    frames = frame_signal(y, frame_length, hop_length, n_frames)
    snapped = jnp.where(jnp.abs(frames) <= threshold, 0.0, frames)
    negative = jnp.signbit(snapped)
    crossings = negative[..., 1:] != negative[..., :-1]
    # librosa.zero_crossings pads the indicator back to frame_length
    # (constant False under feature.zero_crossing_rate's pad=False), so the
    # mean divides by frame_length, NOT the frame_length-1 diff count —
    # count/400 vs count/399 shifts the uint8-quantized R channel by one.
    return jnp.sum(crossings.astype(jnp.float32), axis=-1) / frame_length
