"""Host half of the low-latency preprocessing split (``--host-preprocess``).

CPU denoise -> native webrtcvad decisions -> CPU trim, numerically the same
chain as the fused device program (`inference.preprocess_window`), with the
VAD state living in the long-lived native engine instead of a device
operand.  This is the B=1 serving arrangement: the webrtc filterbank is a
sample-serial dependency chain of tiny steps that the host CPU runs in well
under a millisecond per window (benchmarks/webrtc_profile.py times both
engines), while features+model stay on the device.  Reference contrast: the upstream
pipeline is all-host batch-1 (`record_on_pc.py:130-163`).

Shared by the streaming sessions, `benchmarks/vad_latency.py`, and
`bench.py` so the chain is defined exactly once.
"""

from __future__ import annotations

import numpy as np

import jax

from mmla_audio_tpu.core.config import PipelineConfig
from mmla_audio_tpu.ops.denoise import quantize_i16, reduce_noise
from mmla_audio_tpu.vad.collector import frame_count, vad_trim
from mmla_audio_tpu.vad.native import NativeWebRtcVad, native_available

__all__ = ["HostPreprocessor"]


class HostPreprocessor:
    """One per stream: owns the native detector state and the jitted
    CPU denoise/trim programs.  ``window()`` consumes one raw int16 window
    and returns ``(trimmed int16 (n_win,), n_out)`` ready for
    ``predictor.predict`` (callers apply their own silent gate on
    ``n_out``)."""

    def __init__(self, cfg: PipelineConfig, noise_thresh=None):
        if not native_available():
            raise RuntimeError(
                "host_preprocess requires the native webrtcvad engine "
                "(libmmla_host.so failed to build/load)")
        self.cfg = cfg
        sr = cfg.audio.sample_rate
        self._sr = sr
        self._frame_len = int(sr * cfg.vad.frame_ms / 1000)
        self._vad = NativeWebRtcVad(cfg.vad.aggressiveness)
        self._cpu = jax.devices("cpu")[0]
        self._nt_cpu = None

        def _denoise_chain(raw_i16f, nt):
            y = raw_i16f / 32768.0
            y = reduce_noise(y, nt, cfg.denoise, sr=sr,
                             passes=cfg.denoise.passes_live)
            return quantize_i16(y)

        # placement follows the CPU-committed noise threshold; the raw
        # window arrives as an uncommitted numpy array
        self._denoise = jax.jit(_denoise_chain)
        self._trim = jax.jit(
            lambda i16, n, dec: vad_trim(
                i16, n, dec, self._frame_len, cfg.vad.ring_frames))
        if noise_thresh is not None:
            self.set_noise_threshold(noise_thresh)

    def set_noise_threshold(self, noise_thresh) -> None:
        """CPU-committed copy of the denoise profile so the host chain
        executes on the host backend (placement follows the committed
        operand)."""
        self._nt_cpu = jax.device_put(np.asarray(noise_thresh), self._cpu)

    def window(self, window_i16: np.ndarray):
        assert self._nt_cpu is not None, "set_noise_threshold() first"
        i16 = self._denoise(np.asarray(window_i16, np.float32),
                            self._nt_cpu)
        i16_np = np.asarray(i16).astype(np.int16)
        T = frame_count(len(i16_np), self._frame_len)
        decisions = self._vad.decisions(i16_np[: T * self._frame_len],
                                        frame_len=self._frame_len,
                                        sample_rate=self._sr)
        # pin every operand to the host device: a bare jnp.asarray would
        # place uncommitted data on the DEFAULT (accelerator) device and
        # smuggle device round-trips into the host chain
        trimmed, n_out = self._trim(
            i16, jax.device_put(np.int32(len(i16_np)), self._cpu),
            jax.device_put(decisions, self._cpu))
        return np.asarray(trimmed).astype(np.int16), int(n_out)
