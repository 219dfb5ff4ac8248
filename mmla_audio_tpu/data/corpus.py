"""Enrolled-corpus featurization (`make_feature_experiment`,
`speaker_identification.py:317-369`).

Each ``experiment/corpus/<name>.wav`` (a VAD-trimmed ~60 s enrollment clip)
is featurized in one MFCC pass and sliced into ``ceil(T / 256)`` windows of
(256, 39), zero-padded at the tail; every window carries the speaker's
one-hot label.  Label indices follow first-appearance order over the sorted
file list (the reference's ``binarizer``), and ``speaker_id_dict`` maps
``str(argmax index) -> name``.

Also covers ``make_feature_timit`` (base-training features: one 256-frame
window per clip) via ``featurize_clips``.
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import jax
import numpy as np
import jax.numpy as jnp

from mmla_audio_tpu.core.config import SpeakerFeatureConfig
from mmla_audio_tpu.data.wavio import read_wav
from mmla_audio_tpu.ops.mfcc import max_frames_for, mfcc39_windowed

__all__ = ["featurize_corpus", "featurize_clips", "one_hot_first_appearance"]

_BUCKET_SECONDS = 5.0


@functools.lru_cache(maxsize=None)
def _windowed_jit(bucket_T: int, cfg: SpeakerFeatureConfig):
    def fn(buf, n):
        return mfcc39_windowed(
            buf, n, max_frames=bucket_T, delta_n=cfg.delta_n,
            win_length=cfg.win_length, hop_length=cfg.hop_length,
            sample_rate=cfg.sample_rate, n_fft=cfg.n_fft, n_filt=cfg.n_filt,
            n_cep=cfg.n_cep, preemph=cfg.preemph, ceplifter=cfg.ceplifter,
            append_energy=cfg.append_energy)
    return jax.jit(fn)


def _mfcc39_clip(sig: np.ndarray, cfg: SpeakerFeatureConfig) -> np.ndarray:
    """Whole-clip MFCC+Δ+ΔΔ with ``cfg``'s psf parameters, through the
    fixed-shape windowed kernel: the clip zero-pads to a 5 s bucket so live
    registration compiles ONE device program per bucket instead of one per
    unique clip length (each compile costs seconds to minutes).
    Values match psf on the exact clip — the windowed path's valid-prefix
    masking and dynamic-end delta handling are the parity-tested live
    contract."""
    bucket = int(_BUCKET_SECONDS * cfg.sample_rate)
    n = len(sig)
    pad_len = max(-(-n // bucket), 1) * bucket
    padded = np.zeros(pad_len, np.float32)
    padded[:n] = sig
    bucket_T = max_frames_for(pad_len, cfg.win_length, cfg.hop_length)
    feat, valid = _windowed_jit(bucket_T, cfg)(jnp.asarray(padded),
                                               jnp.asarray(n, jnp.int32))
    return np.asarray(feat)[: int(valid)]


def one_hot_first_appearance(labels: Sequence[str], dim: int | None = None
                             ) -> Tuple[np.ndarray, Dict[str, str]]:
    """binarizer semantics (speaker_identification.py:121-138): class index =
    first-appearance order.  Returns (one-hot (N, dim), {index: label})."""
    index: Dict[str, int] = {}
    for lab in labels:
        if lab not in index:
            index[lab] = len(index)
    dim = dim or len(index)
    y = np.zeros((len(labels), dim), np.float32)
    for i, lab in enumerate(labels):
        y[i, index[lab]] = 1.0
    id_dict = {str(v): k for k, v in index.items()}
    return y, id_dict


def featurize_corpus(corpus_dir, cfg: SpeakerFeatureConfig = SpeakerFeatureConfig(),
                     min_samples: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray, Dict[str, str]]:
    """-> (x (N, 256, 39), y one-hot (N, n_speakers), speaker_id_dict).

    ``min_samples``: skip clips shorter than this — the reference's
    ``get_wav_files`` drops corpus files under 240 000 bytes (~7.5 s,
    `speaker_identification.py:56-66`), i.e. ``min_samples=120_000``;
    default 0 keeps every enrollment.
    """
    xs: List[np.ndarray] = []
    labels: List[str] = []
    for path in sorted(Path(corpus_dir).glob("*.wav")):
        sig, rate = read_wav(path)
        if rate != cfg.sample_rate:
            # read_wav accepts any 8-48 kHz WAV; featurizing at the wrong
            # rate would silently produce garbage MFCCs and an unusable
            # registered model — resample first (data.standardize).
            raise ValueError(
                f"{path}: sample rate {rate} != configured "
                f"{cfg.sample_rate}; run standardize_audio first")
        if len(sig) < min_samples:
            continue
        feats = _mfcc39_clip(sig.astype(np.float32), cfg)
        T = feats.shape[0]
        n_slices = -(-T // cfg.max_frames)
        feats = np.concatenate(
            [feats, np.zeros((n_slices * cfg.max_frames - T, cfg.feat_dim),
                             np.float32)])
        for i in range(n_slices):
            xs.append(feats[i * cfg.max_frames:(i + 1) * cfg.max_frames])
            labels.append(path.stem)
    assert xs, f"no wav files in {corpus_dir}"
    y, id_dict = one_hot_first_appearance(labels)
    return np.stack(xs), y, id_dict


def featurize_clips(clips: Sequence[np.ndarray], labels: Sequence[str],
                    dim: int | None = None,
                    cfg: SpeakerFeatureConfig = SpeakerFeatureConfig()
                    ) -> Tuple[np.ndarray, np.ndarray, Dict[str, str]]:
    """make_feature_timit: one (256, 39) window per clip (truncate/pad).
    Clips must already be at ``cfg.sample_rate``."""
    xs = []
    for sig in clips:
        feats = _mfcc39_clip(np.asarray(sig, np.float32), cfg)
        if feats.shape[0] < cfg.max_frames:
            feats = np.concatenate(
                [feats, np.zeros((cfg.max_frames - feats.shape[0],
                                  cfg.feat_dim), np.float32)])
        xs.append(feats[: cfg.max_frames])
    y, id_dict = one_hot_first_appearance(labels, dim)
    return np.stack(xs), y, id_dict
