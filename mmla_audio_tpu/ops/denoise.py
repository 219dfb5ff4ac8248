"""Stationary spectral-gating noise reduction (noisereduce semantics).

The reference calls ``noisereduce.reduce_noise(y_noise=<10 s ambient>,
stationary=True)`` once per live window (`record_on_pc.py:208-212`), x3 on
post-time ``audio*`` files and x4 on the Pi.  Algorithm (noisereduce 2.x
``SpectralGateStationary``):

  1. noise profile: ``|STFT|`` (n_fft 1024, hop 256, Hann, centered) ->
     dB (librosa ``amplitude_to_db``: 20 log10, amin 1e-20, top_db 80) ->
     per-frequency ``mean + 1.5 * std`` threshold.
  2. signal: same STFT -> dB -> boolean mask ``sig_db > thresh`` ->
     ``mask * prop_decrease + (1 - prop_decrease)`` -> smoothed by an outer
     triangular kernel (~500 Hz x 50 ms, normalized, 'same' convolution).
  3. ``STFT * mask`` -> inverse STFT (overlap-add with squared-window
     normalization).  The signal is zero-padded by 30 000 samples each side
     before filtering and trimmed after (noisereduce's chunk padding).

Device mapping: STFT/ISTFT are the same DFT-as-GEMM bases as ``ops.spectral``;
the mask smoothing is one small 2-D convolution; the overlap-add is a
scatter-add.  Everything is fixed-shape, so a whole batch of windows
denoises in one fused program, replacing the reference's per-window
host round-trip.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from mmla_audio_tpu.core.config import DenoiseConfig
from mmla_audio_tpu.ops.spectral import frame_signal, hann_periodic

__all__ = ["quantize_i16", "amp_to_db", "gate_mask", "noise_threshold",
           "reduce_noise", "smoothing_filter"]


def quantize_i16(y):
    """PCM16 WAV round-trip: scale, round, clip — the reference writes the
    denoised window to disk and re-reads it as int16 (soundfile float->PCM16
    semantics, verified empirically).  THE one encoding of this rule; the
    streaming layer imports it rather than restating it."""
    import jax.numpy as jnp

    return jnp.clip(jnp.round(y * 32768.0), -32768.0, 32767.0)

_PAD = 30_000  # noisereduce chunk padding


def _prec(precision) -> jax.lax.Precision:
    """DenoiseConfig.precision (str) -> jax.lax.Precision."""
    if isinstance(precision, jax.lax.Precision):
        return precision
    return jax.lax.Precision(precision)


def _chunk_pad(cfg: DenoiseConfig, sr: int) -> int:
    """Effective zero-pad per side.

    noisereduce pads each chunk with 30 000 zeros, but only the frames
    within the time-smoothing half-width (+ the ISTFT/reflect edges) of the
    signal influence the output — the rest are all-zero frames whose mask
    value is constant.  Use the smallest pad that (a) preserves the
    30 000-pad frame-grid phase (pad ≡ 30 000 mod hop, so every
    signal-overlapping frame is sample-identical) and (b) keeps all edge
    effects inside the zero region: time-smoothing half-width * hop plus
    2 * n_fft of ISTFT/centering margin.  Output equals the full-pad form
    within fp tolerance (pinned by test_denoise).  Cuts the padded length
    (and the STFT/ISTFT GEMM work) ~2.2x at the default geometry."""
    _, v_t = _smoothing_factors(
        sr, cfg.n_fft, cfg.hop_length, cfg.freq_mask_smooth_hz,
        cfg.time_mask_smooth_ms)
    margin = (len(v_t) // 2) * cfg.hop_length + 2 * cfg.n_fft
    rem = _PAD % cfg.hop_length
    pad = rem + cfg.hop_length * (
        (margin - rem + cfg.hop_length - 1) // cfg.hop_length)
    return min(pad, _PAD)


@functools.lru_cache(maxsize=None)
def _bases_f64(n_fft: int):
    """f64 windowed forward rDFT bases, UNwindowed inverse bases, and the
    synthesis window — the ONE construction both the whole-frame and
    hop-block-split basis caches slice/cast from (the DFT convention lives
    here exactly once)."""
    k = np.arange(n_fft // 2 + 1)
    t = np.arange(n_fft)
    ang = 2.0 * np.pi * np.outer(t, k) / n_fft
    w = hann_periodic(n_fft).astype(np.float64)
    fwd_cos = np.cos(ang) * w[:, None]
    fwd_sin = -np.sin(ang) * w[:, None]
    # inverse: x_t = (1/N) [sum_k c_k (a_k cos - b_k sin)], c = 2 except DC/Nyq
    c = np.full(n_fft // 2 + 1, 2.0)
    c[0] = 1.0
    c[-1] = 1.0
    inv_cos = np.cos(ang) * c[None, :] / n_fft                        # (T, K)
    inv_sin = np.sin(ang) * c[None, :] / n_fft
    return fwd_cos, fwd_sin, inv_cos, inv_sin, w


@functools.lru_cache(maxsize=None)
def _bases(n_fft: int):
    """Windowed forward rDFT bases and inverse (bins -> time) bases."""
    fwd_cos, fwd_sin, inv_cos, inv_sin, _ = _bases_f64(n_fft)
    return (fwd_cos.astype(np.float32), fwd_sin.astype(np.float32),
            inv_cos.astype(np.float32), inv_sin.astype(np.float32))


@functools.lru_cache(maxsize=None)
def _bases_split(n_fft: int, hop: int):
    """hop-block-split DFT bases for the ``hop | n_fft`` geometry (the
    noisereduce default, 1024/256).  Forward: the windowed bases' j-th
    hop-block ROWS, so the STFT GEMM runs directly on hop-strided signal
    blocks and the (..., T, n_fft) frames tensor is never materialized (the
    framing gather + its layout copies were ~1.5 GB/step of the b512 denoise
    traffic — HLO audit).  Inverse: the j-th
    hop-block COLUMNS of the synthesis-WINDOW-FOLDED inverse bases, so each
    GEMM emits one shifted overlap-add part and the separate windowing
    multiply (a full frames-tensor broadcast) disappears."""
    fwd_cos, fwd_sin, inv_cos, inv_sin, w = _bases_f64(n_fft)
    inv_cos_w = inv_cos * w[:, None]
    inv_sin_w = inv_sin * w[:, None]
    r = n_fft // hop
    fc = tuple(np.ascontiguousarray(
        fwd_cos[j * hop:(j + 1) * hop]).astype(np.float32) for j in range(r))
    fs = tuple(np.ascontiguousarray(
        fwd_sin[j * hop:(j + 1) * hop]).astype(np.float32) for j in range(r))
    ic = tuple(np.ascontiguousarray(
        inv_cos_w[j * hop:(j + 1) * hop].T).astype(np.float32)
        for j in range(r))                                       # (K, hop)
    isn = tuple(np.ascontiguousarray(
        inv_sin_w[j * hop:(j + 1) * hop].T).astype(np.float32)
        for j in range(r))
    return fc, fs, ic, isn


def _stft_ri(y: jnp.ndarray, n_fft: int, hop: int,
             precision=jax.lax.Precision.HIGHEST):
    """Centered (reflect) STFT -> (re, im) of shape (..., frames, bins)."""
    n = y.shape[-1]
    cfg = [(0, 0)] * (y.ndim - 1) + [(n_fft // 2, n_fft // 2)]
    yp = jnp.pad(y, cfg, mode="reflect")
    n_frames = 1 + n // hop
    if n_fft % hop == 0:
        # split-GEMM framing: frame t is r = n_fft//hop consecutive
        # hop-blocks, so  frames @ fc  ==  sum_j blocks[j:j+T] @ fc_rows_j
        # on hop-strided reshaped VIEWS of the padded signal — no frames
        # tensor, no gather, no layout copies (HLO audit: ~1.5 GB/step).
        r = n_fft // hop
        nb = n_frames + r - 1
        blocks = yp[..., : nb * hop].reshape(yp.shape[:-1] + (nb, hop))
        fc, fs, _, _ = _bases_split(n_fft, hop)
        re = im = None
        for j in range(r):
            sub = blocks[..., j: j + n_frames, :]
            rj = jnp.matmul(sub, fc[j], preferred_element_type=jnp.float32,
                            precision=precision)
            ij = jnp.matmul(sub, fs[j], preferred_element_type=jnp.float32,
                            precision=precision)
            re = rj if re is None else re + rj
            im = ij if im is None else im + ij
        return re, im
    frames = frame_signal(yp, n_fft, hop, n_frames)
    fc, fs, _, _ = _bases(n_fft)
    re = jnp.matmul(frames, fc, preferred_element_type=jnp.float32,
                    precision=precision)
    im = jnp.matmul(frames, fs, preferred_element_type=jnp.float32,
                    precision=precision)
    return re, im


def _istft(re: jnp.ndarray, im: jnp.ndarray, n_fft: int, hop: int,
           out_len: int,
           precision=jax.lax.Precision.HIGHEST) -> jnp.ndarray:
    """librosa.istft: windowed inverse frames, overlap-add, /= win^2 sum,
    trim n_fft//2 head (centered)."""
    T = re.shape[-2]
    total = n_fft + (T - 1) * hop
    batch = re.shape[:-2]
    w_np = np.asarray(hann_periodic(n_fft), np.float64)
    if n_fft % hop == 0:
        # hop divides n_fft (the noisereduce geometry: 1024/256): each frame
        # contributes r = n_fft//hop aligned hop-blocks, so overlap-add is r
        # shifted pads summed — pure vector ops.  The scatter formulation
        # (.at[idx].add over T*n_fft indices) serializes its updates and
        # dominated the whole denoise chain on the previous accelerator.
        # Each part comes STRAIGHT from a GEMM against the window-folded
        # hop-block inverse bases: the (..., T, n_fft) inverse-frames tensor,
        # its synthesis-window broadcast multiply, and the block
        # reshape+layout-copy never exist (HLO audit).
        r = n_fft // hop
        _, _, ic, isn = _bases_split(n_fft, hop)
        parts = []
        for j in range(r):
            b = (jnp.matmul(re, ic[j], preferred_element_type=jnp.float32,
                            precision=precision)
                 - jnp.matmul(im, isn[j], preferred_element_type=jnp.float32,
                              precision=precision))
            pad = [(0, 0)] * len(batch) + [(j, r - 1 - j), (0, 0)]
            parts.append(jnp.pad(b, pad))
        y = sum(parts).reshape(batch + (total,))
    else:
        _, _, ic, isn = _bases(n_fft)
        # x_frame (..., T, n_fft)
        x = (jnp.matmul(re, ic.T, preferred_element_type=jnp.float32,
                        precision=precision)
             - jnp.matmul(im, isn.T, preferred_element_type=jnp.float32,
                          precision=precision))
        xw = x * jnp.asarray(w_np, jnp.float32)           # synthesis window
        idx = (np.arange(T)[:, None] * hop
               + np.arange(n_fft)[None, :]).reshape(-1)
        idx = jnp.asarray(idx)

        def oadd(frames_flat):
            return jnp.zeros((total,), jnp.float32).at[idx].add(frames_flat)

        flat = xw.reshape((-1, T * n_fft))
        y = jax.vmap(oadd)(flat).reshape(batch + (total,))
    # squared-window normalization is input-independent: precompute on host
    wsq_np = np.zeros(total, np.float64)
    for t in range(T):
        wsq_np[t * hop: t * hop + n_fft] += w_np * w_np
    y = y / jnp.asarray(np.maximum(wsq_np, 1e-10), jnp.float32)
    start = n_fft // 2
    return y[..., start: start + out_len]


def amp_to_db(x: jnp.ndarray, top_db: float = 80.0,
              reduce_axes: tuple | None = None) -> jnp.ndarray:
    """librosa.amplitude_to_db(ref=1.0, amin=1e-20): 20 log10 with top_db
    clamp below the (per-``reduce_axes``) max."""
    db = 20.0 * jnp.log10(jnp.maximum(jnp.abs(x), 1e-20))
    if top_db is not None:
        peak = jnp.max(db) if reduce_axes is None else \
            jnp.max(db, axis=reduce_axes, keepdims=True)
        db = jnp.maximum(db, peak - top_db)
    return db


@functools.lru_cache(maxsize=None)
def smoothing_filter(sr: int, n_fft: int, hop: int,
                     freq_hz: float, time_ms: float) -> np.ndarray:
    """noisereduce's outer triangular mask-smoothing kernel, sum-normalized."""
    v_f, v_t = _smoothing_factors(sr, n_fft, hop, freq_hz, time_ms)
    return np.outer(v_f, v_t).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _smoothing_factors(sr: int, n_fft: int, hop: int,
                       freq_hz: float, time_ms: float
                       ) -> tuple[np.ndarray, np.ndarray]:
    """The smoothing kernel's rank-1 factors (it is an outer product of two
    triangular windows), each carrying half the sum-normalization.  The
    smoothing is applied as two banded-GEMM 1-D convolutions — the 2-D
    C_in=1 spatial conv form maps poorly onto matrix units and dominated
    the b512 denoise chain on the previous accelerator."""
    n_grad_freq = int(freq_hz / (sr / (n_fft / 2)))
    n_grad_time = int(time_ms / ((hop / sr) * 1000))
    v_f = np.concatenate([
        np.linspace(0, 1, n_grad_freq + 1, endpoint=False),
        np.linspace(1, 0, n_grad_freq + 2),
    ])[1:-1]
    v_t = np.concatenate([
        np.linspace(0, 1, n_grad_time + 1, endpoint=False),
        np.linspace(1, 0, n_grad_time + 2),
    ])[1:-1]
    total = v_f.sum() * v_t.sum()
    scale = np.sqrt(total)
    return ((v_f / scale).astype(np.float64),
            (v_t / scale).astype(np.float64))


def _band_matrix(v: np.ndarray, n: int) -> np.ndarray:
    """(n, n) matrix M with ``(x @ M)[i] = sum_k v[k] * x[i + c - k]``
    (zero-padded 'same' true convolution with the odd-length kernel v)."""
    c = len(v) // 2
    m = np.zeros((n, n), np.float64)
    for d, val in enumerate(v):
        # out[i] = sum_d v[d] * x[i + c - d]  =>  x[m] feeds out[m + d - c]
        m += np.eye(n, k=d - c) * val
    return m.astype(np.float32)


_AMIN = 1e-20     # librosa amplitude_to_db amin
_TOP_DB = 80.0    # librosa amplitude_to_db top_db (see amp_to_db)


def gate_mask(re: jnp.ndarray, im: jnp.ndarray, noise_thresh: jnp.ndarray,
              prop_decrease: float) -> jnp.ndarray:
    """The spectral gate's pre-smoothing mask, computed in the
    SQUARED-magnitude domain: sqrt and log10 are monotonic, so with
    ``amin = 1e-20`` and ``top_db = 80`` (the `amp_to_db` constants)

      db > nt  <=>  raw_db > nt  OR  peak_db - top_db > nt
               <=>  max(mag^2, amin^2) > 10^(nt/10)
                    OR  max_magsq > 10^(nt/10) * 10^(top_db/10) .

    Equivalent decisions to ``amp_to_db(mag, reduce_axes=(-2, -1)) > nt``
    up to fp rounding exactly at the boundary; removes the abs/sqrt/log
    full-spectrogram materializations (~0.8 GB/step at b512 — HLO audit).  THE one encoding of the gate decision;
    benchmarks import it rather than restating the constants."""
    magsq = jnp.maximum(re * re + im * im, _AMIN * _AMIN)
    thr_sq = jnp.power(10.0, noise_thresh / 10.0)
    peak_sq = jnp.max(magsq, axis=(-2, -1), keepdims=True)
    mask = jnp.logical_or(
        magsq > thr_sq,
        peak_sq > thr_sq * 10.0 ** (_TOP_DB / 10.0)).astype(jnp.float32)
    return mask * prop_decrease + (1.0 - prop_decrease)


def noise_threshold(noise: jnp.ndarray, cfg: DenoiseConfig = DenoiseConfig()
                    ) -> jnp.ndarray:
    """Per-frequency gate threshold from the ambient-noise clip:
    ``mean_db + n_std * std_db`` over time.  ``noise (n,)`` float [-1, 1]."""
    re, im = _stft_ri(noise, cfg.n_fft, cfg.hop_length,
                      precision=_prec(cfg.precision))
    mag = jnp.sqrt(re * re + im * im)
    db = amp_to_db(mag)                                   # (T, K)
    mean = jnp.mean(db, axis=-2)
    std = jnp.std(db, axis=-2)
    return mean + std * cfg.n_std_thresh                  # (K,)


def reduce_noise(y: jnp.ndarray, noise_thresh: jnp.ndarray,
                 cfg: DenoiseConfig = DenoiseConfig(),
                 sr: int = 16_000, passes: int = 1,
                 quantize_between_passes: bool = True,
                 full_pad: bool = False) -> jnp.ndarray:
    """Denoise ``y (..., n)`` (float [-1, 1]) against a precomputed threshold.

    ``passes`` > 1 re-applies the gate (reference applies x3/x4 on some
    paths) — the reference writes a PCM16 WAV and re-loads it between passes
    (`record_on_pi.py:103-112`), so intermediate results are quantized to
    int16; ``quantize_between_passes`` reproduces that.  The threshold is
    computed ONCE per session from the calibration clip — exactly the
    reference's flow, where the noise profile never changes between passes.

    ``full_pad`` forces noisereduce's literal 30 000-sample chunk padding;
    the default uses the phase-aligned short pad (see :func:`_chunk_pad`),
    equal within fp tolerance at ~2.2x less STFT/ISTFT work.
    """
    n = y.shape[-1]
    precision = _prec(cfg.precision)
    pad = _PAD if full_pad else _chunk_pad(cfg, sr)
    pad_cfg = [(0, 0)] * (y.ndim - 1) + [(pad, pad)]
    v_f, v_t = _smoothing_factors(
        sr, cfg.n_fft, cfg.hop_length, cfg.freq_mask_smooth_hz,
        cfg.time_mask_smooth_ms)

    mf = mt_t = None
    for pass_idx in range(passes):
        if pass_idx > 0 and quantize_between_passes:
            y = jnp.clip(jnp.round(y * 32768.0), -32768.0, 32767.0) / 32768.0
        yp = jnp.pad(y, pad_cfg)
        re, im = _stft_ri(yp, cfg.n_fft, cfg.hop_length,
                          precision=precision)            # (..., T, K)
        mask = gate_mask(re, im, noise_thresh, cfg.prop_decrease)
        # 'same' 2-D smoothing convolution.  The kernel is rank-1
        # (outer(v_f, v_t)), so it factors into two 1-D convolutions, each
        # expressed as a banded-matrix GEMM.  The literal C_in=1
        # spatial-conv form maps poorly onto matrix units
        # (benchmarks/denoise_profile.py times both).
        if mf is None:
            mf = jnp.asarray(_band_matrix(v_f, mask.shape[-1]))   # (K, K)
            mt_t = jnp.asarray(
                _band_matrix(v_t, mask.shape[-2]).T)              # (T, T)
        # feature-parity contraction: the smoothed mask multiplies the
        # STFT every downstream feature consumes — a GPU's default TF32
        # pass would diverge from the CPU golden.  Both smoothing
        # contractions are expressed as plain matmuls (mt.T @ x for the
        # time axis, NOT einsum('...tk,ts->...sk')): XLA:CPU lowers the
        # batched einsum with a different accumulation order than the
        # single-window form, so batched-vs-single denoise differed in the
        # last ulp and occasionally flipped an int16 quantization — matmul
        # forms are measured batch-invariant, keeping the multiplexer's
        # batched chain bit-identical to the per-stream sessions.
        sm = jnp.matmul(mask, mf, preferred_element_type=jnp.float32,
                        precision=precision)      # freq axis
        sm = jnp.matmul(mt_t, sm, preferred_element_type=jnp.float32,
                        precision=precision)      # time axis
        mask = sm
        re = re * mask
        im = im * mask
        y = _istft(re, im, cfg.n_fft, cfg.hop_length, yp.shape[-1],
                   precision=precision)
        y = y[..., pad: pad + n]
    return y
