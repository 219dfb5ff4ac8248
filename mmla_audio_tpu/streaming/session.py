"""Live streaming sessions: capture -> one fused device program -> TSV log.

The reference's live loops (`record_on_pc.py:84-177` OD, `:74-155` SI) write
each window to disk 2-3 times (WAV, denoised WAV, PNG) between every stage.
Here the whole per-window decision is ONE jitted program:

    raw int16 window (2.56 s)
      -> /32768 -> stationary denoise (session noise profile)
      -> int16 re-quantization (the WAV write the reference does)
      -> 30 ms framing -> energy VAD -> hysteresis collect -> trim
      -> silent gate (< 4000 samples)
      -> featurize (ZCR image | MFCC39) -> model -> label

Sessions also reproduce the surrounding behavior: 10 s ambient calibration
(threshold + denoise profile + Ambient_Noise.wav artifact), per-session log
under ``experiment/logs/<timestamp>.txt``, optional window recordings under
``experiment/recordings/real-time/<timestamp>/wav``, suspend/resume, and the
speaker registration flow (60 s enrollment clips -> corpus -> on-device
transfer-learn until accuracy >= 0.80 -> identify).
"""

from __future__ import annotations

import json
from datetime import datetime
from pathlib import Path
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from mmla_audio_tpu.analyze.logs import OVERLAP_LABELS, SessionLog
from mmla_audio_tpu.core.config import PipelineConfig
from mmla_audio_tpu.data.wavio import write_wav
from mmla_audio_tpu.ops.denoise import (noise_threshold,
                                        quantize_i16, reduce_noise)
from mmla_audio_tpu.ops.features import overlap_model_input, speaker_feature
from mmla_audio_tpu.utils.experiment import ExperimentDirs, bootstrap
from mmla_audio_tpu.vad import calibrate_threshold, energy_vad, vad_trim
from mmla_audio_tpu.vad.collector import frame_count
from mmla_audio_tpu.vad.webrtc import webrtc_init, webrtc_vad_frames

__all__ = ["session_stamp", "StreamingSession", "OverlapSession",
           "SpeakerSession"]


def session_stamp(now: Optional[datetime] = None) -> str:
    """Reference log/dir naming: str(datetime.now()) with ' '/':' -> '-',
    micros stripped (`record_on_pc.py:103`)."""
    s = str(now or datetime.now())
    if "." in s:          # strip microseconds ([:-7] in the reference)
        s = s[: s.index(".")]
    return s.replace(" ", "-").replace(":", "-")


# canonical PCM16 round-trip lives with the denoise semantics it serves
_quantize_i16 = quantize_i16


def preprocess_window(raw_i16f: jnp.ndarray, noise_thresh: jnp.ndarray,
                      vad_thr, cfg, *, gmm_state=None, webrtc_state=None):
    """THE per-window pre-decision chain, shared by the single-stream
    sessions and the Multiplexer's batched program so the two paths cannot
    diverge: denoise -> int16 re-quantization -> VAD decisions -> hysteresis
    trim.  The per-frame decision is the bit-exact webrtcvad engine
    (``webrtc_state`` — a :class:`~mmla_audio_tpu.vad.webrtc.WebRtcVadState`,
    threaded across windows like the reference's long-lived ``Vad``
    instance) or the calibrated energy detector (neither state passed).
    ``gmm_state`` selects the float GMM approximation — a benchmark probe
    only (benchmarks/vad_latency.py, vad_agreement.py); no serving surface
    passes it.

    Returns ``(trimmed int16-scale float buffer, valid count, new webrtc
    state or None)``; the trimmed buffer is zero beyond the count (vad_trim
    scatters kept frames into a zero buffer)."""
    sr = cfg.audio.sample_rate
    y = raw_i16f / 32768.0
    y = reduce_noise(y, noise_thresh, cfg.denoise, sr=sr,
                     passes=cfg.denoise.passes_live)
    i16 = _quantize_i16(y)
    frame_len = int(sr * cfg.vad.frame_ms / 1000)
    T = frame_count(i16.shape[-1], frame_len)
    state_out = None
    if webrtc_state is not None:
        # Only the collector's T frames (strict `<`, frame_generator) are
        # ever fed to webrtcvad in the reference — the detector state must
        # not see a trailing exact-fit frame.
        decisions, state_out = webrtc_vad_frames(
            i16[: T * frame_len], webrtc_state,
            mode=cfg.vad.aggressiveness, frame_len=frame_len,
            sample_rate=sr)
    elif gmm_state is not None:
        from mmla_audio_tpu.vad.gmm import gmm_vad   # probe-only path

        decisions, _ = gmm_vad(i16, gmm_state,
                               aggressiveness=cfg.vad.aggressiveness,
                               frame_len=frame_len)
        decisions = decisions[:T]
    else:
        frames = i16[: T * frame_len].reshape(T, frame_len)
        decisions = energy_vad(frames, vad_thr)
    trimmed, n_out = vad_trim(i16, jnp.asarray(i16.shape[-1]), decisions,
                              frame_len, cfg.vad.ring_frames)
    return trimmed, n_out, state_out


class StreamingSession:
    """Shared mechanics: calibration, fused window program, logging."""

    kind = "overlap"

    def __init__(self, capture, dirs: ExperimentDirs | str,
                 cfg: PipelineConfig = PipelineConfig(),
                 save_recordings: bool = False,
                 now: Optional[datetime] = None,
                 telemetry=None,
                 gate=None,
                 host_preprocess: bool | str = "auto"):
        # telemetry: analyze.telemetry.TelemetryClient — the reference's
        # (commented-out) Adafruit-IO POST per prediction; no-op when unset.
        # gate: streaming.edge.GateSource — the Pi runners' button-gated
        # suspend/resume state machine (record_on_pi.py:139-159); capture is
        # suspended while the gate is released.  None = always-on.
        # host_preprocess: run denoise + webrtc VAD + trim on the host (CPU
        # backend + native C++ engine) and ship only the trimmed window to
        # the device for features+model.  This is the single-stream
        # low-latency arrangement for the reference-faithful detector: the
        # webrtc filterbank is a sample-serial dependency chain of tiny
        # steps, sub-ms per window on the host
        # (benchmarks/webrtc_profile.py), while batched serving amortizes it
        # across streams and stays fully on-device.  True requires
        # cfg.vad.decision == "webrtc" and the native library; "auto" (the
        # default) takes the split exactly when both hold, and degrades to
        # the on-device engine (bit-identical decisions) where the native
        # engine can't build.  bench.py's b1_* fields time the split.
        self.telemetry = telemetry
        self.gate = gate
        if host_preprocess == "auto":
            from mmla_audio_tpu.vad.native import native_available

            host_preprocess = (cfg.vad.decision == "webrtc"
                               and native_available())
        self.capture = capture
        self.dirs = dirs if isinstance(dirs, ExperimentDirs) else bootstrap(dirs)
        self.cfg = cfg
        self.save_recordings = save_recordings
        stamp = session_stamp(now)
        self.log = SessionLog(self.dirs.logs / f"{stamp}.txt", kind=self.kind,
                              start_index=1)
        self.rec_dir = self.dirs.real_time / stamp / "wav"
        if save_recordings:
            self.rec_dir.mkdir(parents=True, exist_ok=True)
        self.noise_thresh = None
        self.vad_threshold_db = 30.0
        # Bit-exact webrtcvad engine state, threaded across windows like the
        # reference's long-lived module-level Vad(3) instance
        # (record_on_pc.py:33); fused programs take it as an operand and
        # return the updated state.
        self.vad_state = webrtc_init() if cfg.vad.decision == "webrtc" \
            else None
        self._hostpre = None
        if host_preprocess:
            if cfg.vad.decision != "webrtc":
                raise ValueError(
                    "host_preprocess is the low-latency arrangement for the "
                    "webrtc decision; set cfg.vad.decision='webrtc'")
            from mmla_audio_tpu.streaming.hostpre import HostPreprocessor

            self._hostpre = HostPreprocessor(cfg)
        self._count = 0

    # -- calibration ---------------------------------------------------------
    def calibrate(self, seconds: Optional[float] = None) -> None:
        """10 s ambient-noise recording -> denoise profile + VAD threshold +
        Ambient_Noise.wav artifact (`record_on_pc.py:299-322`)."""
        sr = self.cfg.audio.sample_rate
        n = int((seconds or self.cfg.audio.noise_profile_seconds) * sr)
        chunks = []
        got = 0
        while got < n:
            w = self.capture.read_window(min(n - got, sr), timeout=30.0)
            if w is None:
                break
            chunks.append(w)
            got += len(w)
        noise = (np.concatenate(chunks) if chunks
                 else np.zeros(n, np.int16))[:n]
        write_wav(self.dirs.noise_path, noise, sr)
        self.set_noise_profile(noise)

    def set_noise_profile(self, noise_i16: np.ndarray) -> None:
        nf = noise_i16.astype(np.float32) / 32768.0
        self.noise_thresh = noise_threshold(jnp.asarray(nf), self.cfg.denoise)
        self.vad_threshold_db = calibrate_threshold(
            noise_i16, self.cfg.vad.aggressiveness)
        if self._hostpre is not None:
            self._hostpre.set_noise_threshold(self.noise_thresh)

    def _rebuild_fused(self):
        """(Re)create the jitted fused window program; subclasses override.
        Called after (re)calibration when trace-time constants change."""

    # -- fused device program --------------------------------------------------
    def _preprocess(self, raw_i16f: jnp.ndarray, noise_thresh: jnp.ndarray,
                    vad_thr: jnp.ndarray, vad_state=None):
        """denoise -> quantize -> VAD trim.  Returns (trimmed int16-scale
        float buffer, valid count, new webrtc state or None)."""
        return preprocess_window(raw_i16f, noise_thresh, vad_thr, self.cfg,
                                 webrtc_state=vad_state)

    def _host_window(self, window_i16: np.ndarray):
        """Host half of the low-latency split (see ``streaming/hostpre.py``).
        Returns ``(trimmed int16 (n_win,), n_out)``."""
        return self._hostpre.window(window_i16)

    # -- loop -------------------------------------------------------------------
    def _suspend_target(self):
        """The object owning producer suspension: the capture itself when it
        manages its producer thread (CaptureThread), else the raw source."""
        return self.capture if hasattr(self.capture, "suspend") else \
            getattr(self.capture, "source", None)

    def _ensure_capturing(self) -> None:
        """Gate pressed: make sure the capture is producing — resumes a
        capture created suspended (gate released at boot) or parked by an
        earlier gate release.  Shared by the run loop and gated
        registration (both consume windows behind the same gate)."""
        target = self._suspend_target()
        if hasattr(target, "resume"):
            target.resume()

    def run(self, max_windows: Optional[int] = None,
            on_result: Optional[Callable] = None) -> list:
        """Consume windows until EOF/max_windows; returns [(idx, label, ts)]."""
        assert self.noise_thresh is not None, "calibrate() first"
        results = []
        n_win = self.cfg.audio.window_samples
        # CaptureThread owns suspension (the producer thread suspends the
        # source itself — closing a PyAudio stream under a blocked read from
        # this thread kills capture); raw sources fall back to direct calls.
        sus_target = self._suspend_target()
        # honor a capture created suspended (gate released at startup — the
        # Pi boots with the button up): the first gate-pressed tick resumes
        # it instead of deadlocking on an empty ring.  ONLY gated sessions
        # adopt an external suspension — an always-on session (gate=None)
        # must not un-mute a capture an operator parked.
        suspended = self.gate is not None and \
            bool(getattr(sus_target, "suspended", False))
        try:
            while max_windows is None or len(results) < max_windows:
                if self.gate is not None and not self.gate.pressed:
                    if not suspended and hasattr(sus_target, "suspend"):
                        sus_target.suspend()
                    suspended = True
                    if not self.gate.wait_pressed(timeout=0.1):
                        continue
                if suspended:
                    self._ensure_capturing()
                    suspended = False
                window = self.capture.read_window(n_win, timeout=30.0)
                if window is None:
                    err = getattr(self.capture, "error", None)
                    if err is not None:
                        raise RuntimeError(
                            f"capture failed: {err!r}") from err
                    break
                label, prob = self.process_window(window)
                ts = datetime.today()
                idx = self.log.append(label, ts)
                if self.telemetry is not None:
                    self.telemetry.send(label)
                if self.save_recordings:
                    write_wav(self.rec_dir / f"{idx}.wav", window,
                              self.cfg.audio.sample_rate)
                results.append((idx, label, ts))
                if on_result is not None:
                    on_result(idx, label, prob)
        except KeyboardInterrupt:
            pass
        return results

    def process_window(self, window_i16: np.ndarray):
        raise NotImplementedError


class OverlapSession(StreamingSession):
    kind = "overlap"

    def __init__(self, predictor, capture, dirs, **kw):
        super().__init__(capture, dirs, **kw)
        self.predictor = predictor
        self._rebuild_fused()

    def _rebuild_fused(self):
        cfg = self.cfg

        def fused(variables, raw, noise_thresh, vad_thr, vad_state):
            trimmed, n_out, state = self._preprocess(raw, noise_thresh,
                                                     vad_thr, vad_state)
            # trimmed is zero beyond n_out (preprocess_window contract)
            img = overlap_model_input(
                trimmed[: cfg.overlap_feature.n_samples] / 32768.0,
                cfg.overlap_feature)
            logits = self.predictor.apply_model(variables, img[None])
            probs = jax.nn.softmax(logits, axis=-1)[0]
            label = jnp.argmax(probs).astype(jnp.int32)
            silent = n_out < cfg.vad.silent_samples
            return jnp.where(silent, -1, label), probs, n_out, state

        self._fused = jax.jit(fused)

    def process_window(self, window_i16: np.ndarray):
        if self._hostpre is not None:
            trimmed, n_out = self._host_window(window_i16)
            _, probs = self.predictor.predict(
                trimmed[None], np.asarray([n_out], np.int32))
            probs = np.asarray(probs)[0]
            # gate at the SESSION config threshold (the fused path's gate),
            # not the predictor's own silent_threshold — the two arrangements
            # must agree for any non-default gate; argmax(probs) equals the
            # fused path's argmax(softmax(logits))
            label = -1 if n_out < self.cfg.vad.silent_samples \
                else int(np.argmax(probs))
            name = "silent" if label < 0 else OVERLAP_LABELS[str(label)]
            return name, probs
        label, probs, _, state = self._fused(
            self.predictor.variables,
            jnp.asarray(window_i16.astype(np.float32)),
            self.noise_thresh, jnp.asarray(self.vad_threshold_db, jnp.float32),
            self.vad_state)
        if state is not None:
            self.vad_state = state
        label, probs = jax.device_get((label, probs))  # one host fetch
        label = int(label)
        name = "silent" if label < 0 else OVERLAP_LABELS[str(label)]
        return name, probs


class SpeakerSession(StreamingSession):
    kind = "speaker"

    def __init__(self, predictor, capture, dirs,
                 speaker_id_dict: Optional[Dict[str, str]] = None, **kw):
        super().__init__(capture, dirs, **kw)
        self.predictor = predictor
        self.speaker_id_dict = speaker_id_dict or {}
        self._rebuild_fused()

    def process_window(self, window_i16: np.ndarray):
        if self._hostpre is not None:
            trimmed, n_out = self._host_window(window_i16)
            _, probs = self.predictor.predict(
                trimmed[None], np.asarray([n_out], np.int32))
            probs = np.asarray(probs)[0]
            # session-config gate, same as the fused path (argmax of probs
            # equals argmax of logits — sigmoid/softmax are monotonic)
            label = -1 if n_out < self.cfg.speaker_feature.silent_samples \
                else int(np.argmax(probs))
            name = "silent" if label < 0 else \
                self.speaker_id_dict.get(str(label), str(label))
            return name, probs
        label, probs, _, state = self._fused(
            self.predictor.variables,
            jnp.asarray(window_i16.astype(np.float32)),
            self.noise_thresh, jnp.asarray(self.vad_threshold_db, jnp.float32),
            self.vad_state)
        if state is not None:
            self.vad_state = state
        label, probs = jax.device_get((label, probs))  # one host fetch
        label = int(label)
        name = "silent" if label < 0 else \
            self.speaker_id_dict.get(str(label), str(label))
        return name, probs

    # -- registration ------------------------------------------------------------
    def register_speaker(self, name: str,
                         seconds: Optional[float] = None) -> Path:
        """One enrollment: capture ~60 s, denoise + VAD trim, write
        ``experiment/corpus/<name>.wav`` (`record_on_pc.py:299-328`)."""
        assert self.noise_thresh is not None, "calibrate() first"
        sr = self.cfg.audio.sample_rate
        n = int((seconds or self.cfg.audio.enroll_seconds) * sr)
        chunks, got = [], 0
        while got < n:
            w = self.capture.read_window(min(n - got, sr), timeout=60.0)
            if w is None:
                break
            chunks.append(w)
            got += len(w)
        raw = (np.concatenate(chunks) if chunks else np.zeros(n, np.int16))[:n]
        if self._hostpre is not None:
            # host-preprocess sessions keep ONE long-lived detector (the
            # native engine) that sees every frame in capture order —
            # enrollment must not advance a separate device-side state (and
            # must not pay the scan-bound device filterbank the split
            # exists to avoid)
            trimmed_np, n_out = self._host_window(raw)
            out = trimmed_np[: int(n_out)]
        else:
            trimmed, n_out, state = self._preprocess(
                jnp.asarray(raw.astype(np.float32)), self.noise_thresh,
                jnp.asarray(self.vad_threshold_db, jnp.float32),
                self.vad_state)
            if state is not None:
                self.vad_state = state
            out = np.asarray(trimmed[: int(n_out)]).astype(np.int16)
        path = self.dirs.corpus / f"{name}.wav"
        write_wav(path, out, sr)
        return path

    def train_on_registered(self, base_variables, seed: int = 0,
                            epochs_override=None):
        """Featurize the corpus + transfer-learn until the accuracy gate;
        installs the new head into this session's predictor
        (`transfer_learning_on_experiment` + retrain loop)."""
        from mmla_audio_tpu.data.corpus import featurize_corpus
        from mmla_audio_tpu.inference import SpeakerPredictor
        from mmla_audio_tpu.train.checkpoints import (
            save_feature_cache,
            save_variables,
        )
        from mmla_audio_tpu.train.transfer import TransferLearner

        x, y, sid = featurize_corpus(self.dirs.corpus,
                                     cfg=self.cfg.speaker_feature)
        # experiment_feature.npz cache (speaker_identification.py:485-489)
        save_feature_cache(self.dirs.root / "experiment_feature", x, y, sid)
        learner = TransferLearner(base_variables, n_speakers=y.shape[1],
                                  model_cfg=self.cfg.speaker_model,
                                  cfg=self.cfg.transfer)
        variables, acc, losses = learner.fit_until_gate(
            x, y, seed=seed, epochs_override=epochs_override)
        self.speaker_id_dict = sid
        (self.dirs.root / "speaker_id_dict.json").write_text(json.dumps(sid))
        # the reference saves the fine-tuned model to experiment/model
        save_variables(self.dirs.model, variables,
                       {"n_speakers": int(y.shape[1]),
                        "accuracy": float(acc),
                        "speaker_id_dict": sid})
        self.predictor = SpeakerPredictor(
            variables, self.cfg.speaker_model, self.cfg.speaker_feature,
            head_units=y.shape[1], sigmoid_head=True)
        self._rebuild_fused()   # new head -> new fused program
        return acc

    def _rebuild_fused(self):
        cfg = self.cfg

        def fused(variables, raw, noise_thresh, vad_thr, vad_state):
            trimmed, n_out, state = self._preprocess(raw, noise_thresh,
                                                     vad_thr, vad_state)
            feats, _ = speaker_feature(trimmed, n_out, cfg.speaker_feature)
            logits = self.predictor.apply_model(variables, feats[None])
            probs = (jax.nn.sigmoid(logits)[0] if self.predictor.sigmoid_head
                     else jax.nn.softmax(logits, axis=-1)[0])
            label = jnp.argmax(logits[0]).astype(jnp.int32)
            silent = n_out < cfg.speaker_feature.silent_samples
            return jnp.where(silent, -1, label), probs, n_out, state

        self._fused = jax.jit(fused)
