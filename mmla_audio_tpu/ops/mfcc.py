"""MFCC + delta features with python_speech_features semantics, as GEMMs.

Reproduces the speaker-ID front-end of the reference
(`SpeakerIdentification/scripts/speaker_identification.py:141-151, 372-398`):
13 MFCCs (25 ms / 10 ms frames, NFFT 512, 26 HTK mel filters, DCT-II ortho,
ceplifter 22, log-energy in c0, preemphasis 0.97, rectangular window) computed
on raw int16-valued samples, plus the reference's hand-rolled delta
(regression over +-2 frames with edge padding).

Device mapping: framing is a static gather; the 512-point real DFT and the DCT
are matmuls against precomputed bases; the mel projection is one more matmul.
Streaming windows are fixed-shape: the signal arrives in a constant-size
buffer plus a valid-sample count, and frame validity is handled by masking +
clipped-index gathers so the jitted program never sees a dynamic shape while
still matching the reference bit-for-bit on variable-length (VAD-trimmed)
audio.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from mmla_audio_tpu.ops.spectral import frame_signal

__all__ = [
    "max_frames_for",
    "num_valid_frames",
    "mfcc13",
    "delta",
    "mfcc39",
    "mfcc39_windowed",
    "mfcc39_windowed_batch",
]


def _rdft_basis(n_fft: int, win_length: int):
    """Unwindowed real-DFT basis — python_speech_features uses a rectangular
    window.  One basis construction for the whole package: delegates to
    ``spectral._dft_basis(windowed=False)``."""
    from mmla_audio_tpu.ops.spectral import _dft_basis

    return _dft_basis(n_fft, win_length, windowed=False)


@functools.lru_cache(maxsize=None)
def _psf_filterbank(n_filt: int, n_fft: int, sample_rate: int,
                    low_freq: float = 0.0, high_freq: float | None = None
                    ) -> np.ndarray:
    """python_speech_features ``get_filterbanks``: HTK mel points snapped to
    integer FFT bins via ``floor((nfft+1) * hz / sr)`` — NOT the continuous
    triangles of librosa.  Shape ``(n_filt, n_fft//2 + 1)``."""
    high_freq = high_freq or sample_rate / 2
    def hz2mel(hz):
        return 2595 * np.log10(1 + np.asarray(hz, dtype=np.float64) / 700.0)
    def mel2hz(mel):
        return 700 * (10 ** (np.asarray(mel, dtype=np.float64) / 2595.0) - 1)
    melpoints = np.linspace(hz2mel(low_freq), hz2mel(high_freq), n_filt + 2)
    bins = np.floor((n_fft + 1) * mel2hz(melpoints) / sample_rate)
    fbank = np.zeros((n_filt, n_fft // 2 + 1))
    for j in range(n_filt):
        for i in range(int(bins[j]), int(bins[j + 1])):
            fbank[j, i] = (i - bins[j]) / (bins[j + 1] - bins[j])
        for i in range(int(bins[j + 1]), int(bins[j + 2])):
            fbank[j, i] = (bins[j + 2] - i) / (bins[j + 2] - bins[j + 1])
    return fbank.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _dct2_ortho(n_in: int, n_out: int) -> np.ndarray:
    """DCT-II with ortho norm as a matrix ``(n_in, n_out)`` (scipy.fftpack.dct
    type 2, norm='ortho', truncated to the first ``n_out`` coefficients)."""
    n = np.arange(n_in)[:, None]
    k = np.arange(n_out)[None, :]
    mat = 2.0 * np.cos(np.pi * k * (2.0 * n + 1.0) / (2.0 * n_in))
    scale = np.full((1, n_out), np.sqrt(1.0 / (2.0 * n_in)))
    scale[0, 0] = np.sqrt(1.0 / (4.0 * n_in))
    return (mat * scale).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _lifter(n_cep: int, L: int) -> np.ndarray:
    return (1.0 + (L / 2.0) * np.sin(np.pi * np.arange(n_cep) / L)).astype(np.float32)


def max_frames_for(n_samples: int, win_length: int = 400, hop_length: int = 160) -> int:
    """psf frame count for a signal of exactly ``n_samples``."""
    if n_samples <= win_length:
        return 1
    return 1 + int(np.ceil((n_samples - win_length) / hop_length))


def num_valid_frames(n_samples: jnp.ndarray, win_length: int = 400,
                     hop_length: int = 160) -> jnp.ndarray:
    """Traced psf frame count: 1 if n <= win else 1 + ceil((n - win) / hop)."""
    n = jnp.asarray(n_samples, jnp.int32)
    extra = jnp.maximum(n - win_length, 0)
    return jnp.where(n <= win_length, 1, 1 + -(-extra // hop_length))


def _preemphasis(sig: jnp.ndarray, coeff: float) -> jnp.ndarray:
    first = sig[..., :1]
    rest = sig[..., 1:] - coeff * sig[..., :-1]
    return jnp.concatenate([first, rest], axis=-1)


def mfcc13(sig: jnp.ndarray, *, sample_rate: int = 16_000, win_length: int = 400,
           hop_length: int = 160, n_fft: int = 512, n_filt: int = 26,
           n_cep: int = 13, preemph: float = 0.97, ceplifter: int = 22,
           append_energy: bool = True, n_frames: int | None = None) -> jnp.ndarray:
    """MFCC-13 of ``sig (..., n_samples)`` -> ``(..., n_frames, n_cep)``.

    ``sig`` holds raw int16-scale values as floats (the reference feeds
    ``scipy.io.wavfile`` output straight into psf ``mfcc``).  The trailing
    zero-padding implied by psf framing is reproduced exactly because callers
    pass buffers already zero-padded to cover the last frame.
    """
    if n_frames is None:
        n_frames = max_frames_for(sig.shape[-1], win_length, hop_length)
    sig = _preemphasis(sig.astype(jnp.float32), preemph)
    pad_to = (n_frames - 1) * hop_length + win_length
    if sig.shape[-1] < pad_to:
        cfg = [(0, 0)] * (sig.ndim - 1) + [(0, pad_to - sig.shape[-1])]
        sig = jnp.pad(sig, cfg)
    frames = frame_signal(sig, win_length, hop_length, n_frames)  # (..., T, win)

    cos, sin = _rdft_basis(n_fft, win_length)
    re = jnp.matmul(frames, jnp.asarray(cos), preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)
    im = jnp.matmul(frames, jnp.asarray(sin), preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)
    powspec = (re * re + im * im) / n_fft                         # (..., T, bins)

    energy = jnp.sum(powspec, axis=-1)                            # (..., T)
    # psf clamps zeros with FLOAT64 eps (2.22e-16 -> log = -36.04); the f32
    # eps (1.19e-7 -> -15.94) would shift silence frames by ~20 and bleed
    # into neighboring deltas.  2.22e-16 is exactly representable in f32.
    eps = float(np.finfo(np.float64).eps)
    energy = jnp.where(energy == 0, eps, energy)

    fb = jnp.asarray(_psf_filterbank(n_filt, n_fft, sample_rate))
    feat = jnp.matmul(powspec, fb.T, preferred_element_type=jnp.float32, precision=jax.lax.Precision.HIGHEST)
    feat = jnp.where(feat == 0, eps, feat)
    feat = jnp.log(feat)

    feat = jnp.matmul(feat, jnp.asarray(_dct2_ortho(n_filt, n_cep)),
                      preferred_element_type=jnp.float32,
                      precision=jax.lax.Precision.HIGHEST)
    if ceplifter > 0:
        feat = feat * jnp.asarray(_lifter(n_cep, ceplifter))
    if append_energy:
        feat = feat.at[..., 0].set(jnp.log(energy))
    return feat


def delta(feat: jnp.ndarray, N: int = 2,
          valid_len: jnp.ndarray | None = None) -> jnp.ndarray:
    """The reference's hand-rolled delta (`speaker_identification.py:141-151`):
    ``d[t] = sum_{i=-N..N} i * feat[t+i] / (2 * sum i^2)`` with edge padding.

    With ``valid_len`` (traced *scalar*), edge padding is taken at
    ``valid_len - 1`` instead of the static end, matching the reference's
    behavior of computing deltas on the un-padded frame sequence before
    zero-padding to 256.  For per-example valid lengths, ``jax.vmap`` this.
    """
    T = feat.shape[-2]
    denom = 2.0 * sum(i * i for i in range(1, N + 1))
    offsets = np.arange(-N, N + 1)
    pos = np.arange(T)[:, None] + offsets[None, :]                # (T, 2N+1)
    if valid_len is None:
        idx = jnp.asarray(np.clip(pos, 0, T - 1))
    else:
        hi = jnp.asarray(valid_len, jnp.int32) - 1
        idx = jnp.clip(jnp.asarray(pos), 0, hi)                   # traced clip
    rows = jnp.take(feat, idx.reshape(-1), axis=-2)               # (..., T*(2N+1), C)
    rows = rows.reshape(feat.shape[:-2] + (T, offsets.size, feat.shape[-1]))
    w = jnp.asarray(offsets, jnp.float32)
    # feature-parity contraction: HIGHEST like every other GEMM here (a
    # reduced-precision pass, e.g. TF32 at a GPU's default, drifts the
    # feature dims)
    return jnp.einsum("k,...tkc->...tc", w, rows,
                      precision=jax.lax.Precision.HIGHEST) / denom


def mfcc39(sig: jnp.ndarray, *, n_frames: int | None = None,
           delta_n: int = 2, **kw) -> jnp.ndarray:
    """MFCC + delta + delta-delta -> ``(..., n_frames, 39)`` (static length)."""
    m = mfcc13(sig, n_frames=n_frames, **kw)
    d = delta(m, delta_n)
    dd = delta(d, delta_n)
    return jnp.concatenate([m, d, dd], axis=-1)


def mfcc39_windowed(buf: jnp.ndarray, n_samples: jnp.ndarray, *,
                    max_frames: int = 256, delta_n: int = 2,
                    win_length: int = 400, hop_length: int = 160,
                    **kw) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Fixed-shape streaming path for ONE window: ``buf (max_samples,)``
    zero-padded with ``n_samples`` (traced scalar) valid samples ->
    ``((max_frames, 39), valid_frames)``.  Batch with ``mfcc39_windowed_batch``.

    Matches `input_feature_gen` (`speaker_identification.py:372-398`): MFCCs of
    the valid prefix, deltas with edge handling at the dynamic end, rows padded
    with zeros to ``max_frames`` (or truncated).  The <4000-sample silent gate
    is the caller's job (it is a label decision, not a feature).
    """
    n_samples = jnp.asarray(n_samples, jnp.int32)
    T_max = min(max_frames_for(buf.shape[-1], win_length, hop_length), max_frames)
    idx = jnp.arange(buf.shape[-1])
    sig = jnp.where(idx < n_samples, buf, 0.0)
    # psf preemphasizes before framing; emulate by masking after preemphasis
    # (preemphasis of a zero-masked buffer leaks one sample past the boundary).
    sig = _preemphasis(sig.astype(jnp.float32), kw.get("preemph", 0.97))
    sig = jnp.where(idx < n_samples, sig, 0.0)
    kw2 = dict(kw)
    kw2["preemph"] = 0.0  # already applied
    kw2.setdefault("win_length", win_length)
    kw2.setdefault("hop_length", hop_length)
    m = mfcc13(sig, n_frames=T_max, **kw2)                        # (T_max, 13)
    valid = jnp.minimum(num_valid_frames(n_samples, win_length, hop_length), T_max)
    d = delta(m, delta_n, valid_len=valid)
    dd = delta(d, delta_n, valid_len=valid)
    feat = jnp.concatenate([m, d, dd], axis=-1)                   # (T_max, 39)
    if T_max < max_frames:
        feat = jnp.pad(feat, [(0, max_frames - T_max), (0, 0)])
    mask = jnp.arange(max_frames) < valid
    feat = jnp.where(mask[:, None], feat, 0.0)
    return feat, valid


def mfcc39_windowed_batch(bufs: jnp.ndarray, n_samples: jnp.ndarray,
                          **static_kw) -> tuple[jnp.ndarray, jnp.ndarray]:
    """vmapped ``mfcc39_windowed``: ``(B, max_samples), (B,)`` ->
    ``((B, max_frames, 39), (B,))``."""
    fn = functools.partial(mfcc39_windowed, **static_kw)
    return jax.vmap(fn)(bufs, jnp.asarray(n_samples, jnp.int32))
