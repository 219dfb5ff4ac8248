"""Post-time (offline) batch pipelines for whole conversation recordings.

Reference behavior reproduced:

* Overlap (`overlap_detection_post_processing.py:151-226`): every file under
  ``experiment/recordings/post-time/whole`` is standardized (``zoom*``: 0
  denoise passes, ``audio*``: 3), cut into back-to-back 1.5 s segments,
  featurized, predicted, logged (segment index from 0, +1.5 s synthetic
  timestamps, first write truncates) and charted.  No silent gate here.

* Speaker (`speaker_identification_post_processing.py:191-354`): standardized
  conversations are cut into 2.56 s segments whose VAD-trimmed length marks
  ``silent`` entries; the WHOLE standardized file is featurized in one MFCC
  pass and sliced into ceil(T/256) windows which the model predicts in one
  batch; +2.56 s timestamps are added BEFORE every row (including the first),
  prior log deleted.

Device difference: every per-segment disk round-trip becomes one batched device
call (all windows of a conversation in a single program execution).
"""

from __future__ import annotations

import functools
from datetime import datetime, timedelta
from pathlib import Path
from typing import Dict

import jax
import numpy as np
import jax.numpy as jnp

from mmla_audio_tpu.analyze.charts import visualize_log
from mmla_audio_tpu.analyze.logs import OVERLAP_LABELS, SessionLog
from mmla_audio_tpu.core.config import PipelineConfig
from mmla_audio_tpu.data.standardize import segment_signal, standardize_audio
from mmla_audio_tpu.data.wavio import read_wav, write_wav
from mmla_audio_tpu.ops.mfcc import mfcc39
from mmla_audio_tpu.utils.experiment import ExperimentDirs
from mmla_audio_tpu.vad import calibrate_threshold, collect_mask, energy_vad, frame_count

__all__ = ["overlap_post_analyze", "speaker_post_analyze",
           "speaker_id_dict_from_corpus"]


@functools.lru_cache(maxsize=None)
def _webrtc_seg_scan(mode: int, frame_len: int, sample_rate: int, ring: int):
    """One cached jitted program per VAD config: scans the webrtc detector
    state across a conversation's segments, emitting kept-frame counts.
    A fresh ``jax.jit(lambda ...)`` per FILE defeats the jit cache and
    recompiles the expensive sample-serial webrtc scan for every wav."""
    from mmla_audio_tpu.vad.webrtc import webrtc_vad_frames

    def _seg_step(st, seg):
        dec, st = webrtc_vad_frames(seg, st, mode=mode, frame_len=frame_len,
                                    sample_rate=sample_rate)
        return st, collect_mask(dec, ring=ring).sum()

    return jax.jit(lambda st, s: jax.lax.scan(_seg_step, st, s))


@functools.lru_cache(maxsize=None)
def _energy_seg_counts(ring: int):
    """Cached jitted per-segment energy-VAD kept-frame counter (threshold
    passed as an operand so one program serves every file/session)."""
    def _kept_frames(fr, thr):
        dec = energy_vad(fr, thr)
        return collect_mask(dec, ring=ring).sum()

    return jax.jit(jax.vmap(_kept_frames, in_axes=(0, None)))


def _standardize_file(path: Path, dirs: ExperimentDirs, noise, passes_audio: int,
                      cfg: PipelineConfig) -> Path:
    sig, sr = read_wav(path)
    passes = 0 if path.name.startswith("zoom") else passes_audio
    out = standardize_audio(sig, sr, target_sr=cfg.audio.sample_rate,
                            noise=noise, noise_passes=passes,
                            denoise_cfg=cfg.denoise, vad_cfg=cfg.vad)
    dst = dirs.post_standardized / (path.stem + ".wav")
    write_wav(dst, out, cfg.audio.sample_rate)
    return dst


def overlap_post_analyze(dirs: ExperimentDirs, predictor, *,
                         cfg: PipelineConfig = PipelineConfig(),
                         noise: np.ndarray | None = None,
                         start_time: datetime | None = None,
                         make_charts: bool = True) -> Dict[str, Path]:
    """Run the overlap post-time pipeline over ``post-time/whole``.

    ``predictor``: OverlapPredictor.  Returns {conversation: log_path}.
    """
    logs = {}
    win = 1.5
    sr = cfg.audio.sample_rate
    for f in sorted(dirs.post_whole.glob("*.wav")):
        std = _standardize_file(f, dirs, noise, cfg.denoise.passes_post, cfg)
        sig, _ = read_wav(std)
        segs = segment_signal(sig, sr, win, win)             # (N, 24000)
        log_path = dirs.logs / (f.stem + ".txt")
        # first write truncates, like the reference's open(..., 'w')
        # (`overlap_detection_post_processing.py:214`) — a rerun must not
        # append a second header/restart indices mid-file
        log = SessionLog(log_path, kind="overlap", start_index=0,
                         overwrite=True)
        log.ensure_header()
        t0 = start_time or datetime.today()
        if len(segs):
            # the predictor slices buf[..., :24000] itself — no need to pad
            # each segment out to the 40960-sample live-window shape
            n = np.full((segs.shape[0],), segs.shape[1], np.int32)
            labels, _ = predictor.predict(segs.astype(np.int16), n)
            names = [OVERLAP_LABELS.get(str(int(l)), "silent")
                     for l in np.asarray(labels)]
            log.append_batch(names, t0, win)
        logs[f.stem] = log_path
        if make_charts:
            visualize_log(log_path, dirs.charts, kind="overlap")
    return logs


def speaker_id_dict_from_corpus(corpus_dir) -> Dict[str, str]:
    """speaker_id_dict rebuilt from enrollment filenames
    (`speaker_identification_post_processing.py:193-197`)."""
    files = sorted(p.name for p in Path(corpus_dir).glob("*.wav"))
    return {str(i): name[:-4] for i, name in enumerate(files)}


def speaker_post_analyze(dirs: ExperimentDirs, predictor, *,
                         cfg: PipelineConfig = PipelineConfig(),
                         noise: np.ndarray | None = None,
                         speaker_id_dict: Dict[str, str] | None = None,
                         start_time: datetime | None = None,
                         make_charts: bool = True) -> Dict[str, Path]:
    """Run the speaker post-time pipeline.  ``predictor``: SpeakerPredictor
    built on the transfer-learned head."""
    if speaker_id_dict is None:
        speaker_id_dict = speaker_id_dict_from_corpus(dirs.corpus)
    logs = {}
    sr = cfg.audio.sample_rate
    win_s = cfg.audio.window_seconds                        # 2.56
    # Without an ambient profile fall back to the 30 dB floor used by the
    # live sessions and standardize_audio — calibrating on silence yields a
    # ~-88 dB threshold and the silent gate never fires.
    vad_thr = (calibrate_threshold(noise, cfg.vad.aggressiveness)
               if noise is not None else 30.0)
    frame_len = int(sr * cfg.vad.frame_ms / 1000)
    vad_box = None
    if cfg.vad.decision == "webrtc":
        # one long-lived detector across every segment of every file, in
        # processing order — the reference's module-level Vad(3) shared by
        # the whole post-time run (record_on_pc.py:33)
        from mmla_audio_tpu.vad.webrtc import VadBox

        vad_box = VadBox(cfg.vad.aggressiveness)

    for f in sorted(dirs.post_whole.glob("*.wav")):
        std = _standardize_file(f, dirs, noise, cfg.denoise.passes_post, cfg)
        sig, _ = read_wav(std)

        # silent detection per 2.56 s segment (VAD-trimmed length < 4000) —
        # one batched device call over all segments of the conversation (a
        # per-segment eager loop pays one dispatch and one sync per segment)
        segs = segment_signal(sig, sr, win_s, win_s)
        silent = set()
        T = frame_count(segs.shape[1], frame_len) if len(segs) else 0
        if len(segs) and T > 0:
            if vad_box is not None:
                # segment decisions are state-sequential (the detector
                # adapts across segments): lax.scan threads the webrtc
                # state through the conversation in order, one CACHED
                # device program per VAD config (+ shape); the final state
                # carries to the next file
                seg_i32 = jnp.asarray(
                    segs[:, : T * frame_len].astype(np.int32))
                scan = _webrtc_seg_scan(cfg.vad.aggressiveness, frame_len,
                                        sr, cfg.vad.ring_frames)
                vad_box.state, kept = scan(vad_box.state, seg_i32)
                kept = np.asarray(kept)
            else:
                frames = segs[:, : T * frame_len].astype(np.float32) \
                    .reshape(len(segs), T, frame_len)
                kept = np.asarray(_energy_seg_counts(cfg.vad.ring_frames)(
                    jnp.asarray(frames),
                    jnp.asarray(vad_thr, jnp.float32)))
            silent = {i for i in range(len(segs))
                      if kept[i] * frame_len
                      < cfg.speaker_feature.silent_samples}
        elif len(segs):
            silent = set(range(len(segs)))

        # whole-file featurization, sliced into max_frames windows — same
        # feature config the predictor was built with (the live path threads
        # cfg.speaker_feature the same way)
        fc = cfg.speaker_feature
        width = 3 * fc.n_cep
        feats = np.asarray(mfcc39(
            jnp.asarray(sig.astype(np.float32)),
            sample_rate=fc.sample_rate, n_fft=fc.n_fft, n_filt=fc.n_filt,
            n_cep=fc.n_cep, preemph=fc.preemph, ceplifter=fc.ceplifter,
            append_energy=fc.append_energy, win_length=fc.win_length,
            hop_length=fc.hop_length, delta_n=fc.delta_n))
        T = feats.shape[0]
        n_slices = -(-T // fc.max_frames)
        feats = np.concatenate(
            [feats,
             np.zeros((n_slices * fc.max_frames - T, width), np.float32)])
        slices = feats.reshape(n_slices, fc.max_frames, width)
        logits = predictor.logits_from_features(jnp.asarray(slices))
        pred_idx = np.argmax(np.asarray(logits), axis=-1)

        log_path = dirs.logs / (f.stem + ".txt")
        log = SessionLog(log_path, kind="speaker", start_index=0, overwrite=True)
        log.ensure_header()
        t = start_time or datetime.today()
        for i in range(n_slices):
            t = t + timedelta(seconds=win_s)                # delta BEFORE row
            # .get fallback like the live sessions: a head wider than the
            # enrollment dict must not KeyError mid-conversation
            name = "silent" if i in silent else \
                speaker_id_dict.get(str(int(pred_idx[i])),
                                    str(int(pred_idx[i])))
            log.append(name, t)
        logs[f.stem] = log_path
        if make_charts:
            visualize_log(log_path, dirs.charts, kind="speaker")
    return logs
