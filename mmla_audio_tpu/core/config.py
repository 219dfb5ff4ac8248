"""Typed configuration for the whole framework.

The reference scatters its operating parameters as module-level constants
(`OverlapDetection/scripts/record_on_pc.py:28-36`, `record_on_pi.py:17-35`,
feature hyper-params as ctor args `overlap_features_generator.py:31-42`,
training hyper-params inline in `overlap_detector.py:399-421` and
`speaker_identification.py:412-447`).  Here every knob lives in one frozen
dataclass tree so that jitted programs can treat them as static arguments.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AudioConfig:
    """Capture-side PCM geometry (reference record_on_pc.py:28-32)."""

    sample_rate: int = 16_000          # Hz
    sample_width: int = 2              # bytes (int16)
    channels: int = 1
    chunk_samples: int = 2_000         # one PyAudio read = 0.125 s
    window_seconds: float = 2.56       # streaming decision window
    noise_profile_seconds: float = 10.0  # ambient-noise calibration clip
    enroll_seconds: float = 60.0       # per-speaker registration clip

    @property
    def window_samples(self) -> int:
        return int(self.window_seconds * self.sample_rate)


@dataclasses.dataclass(frozen=True)
class OverlapFeatureConfig:
    """ZCR-enhanced log-mel image (overlap_features_generator.py:31-42,65-151).

    1.5 s of 16 kHz audio -> 151 STFT frames (25 ms window / 10 ms hop,
    centered) x 128 mels -> 3-channel image: R = per-frame ZCR, G = B =
    1 - minmax(log-mel).  The reference round-trips the image through a uint8
    PNG (`plt.imsave` + `decode_png`) and feeds the model 0..255 float32 with
    the mel axis flipped (origin="lower"); we reproduce that quantization
    on-device (see ops.features.quantize_png_u8).
    """

    sample_rate: int = 16_000
    win_ms: float = 25.0
    hop_ms: float = 10.0
    n_mels: int = 128
    time_dim: int = 150                # hops covered -> time_dim+1 frames
    fmin: float = 0.0
    fmax: Optional[float] = None       # None -> sr/2
    png_quantize: bool = True          # reproduce uint8 PNG round-trip
    flip_mel_axis: bool = True         # reproduce origin="lower" row flip

    @property
    def win_length(self) -> int:
        return int(self.sample_rate * self.win_ms / 1000)   # 400

    @property
    def hop_length(self) -> int:
        return int(self.sample_rate * self.hop_ms / 1000)   # 160

    @property
    def n_samples(self) -> int:
        """Audio consumed per feature: hop * time_dim = 24 000 (1.5 s)."""
        return self.hop_length * self.time_dim

    @property
    def n_frames(self) -> int:
        """Centered STFT frames: 1 + n_samples // hop = 151."""
        return 1 + self.n_samples // self.hop_length

    @property
    def image_shape(self) -> Tuple[int, int, int]:
        return (self.n_mels, self.n_frames, 3)               # (128, 151, 3)


@dataclasses.dataclass(frozen=True)
class SpeakerFeatureConfig:
    """MFCC-13 + delta + delta-delta, 256 frames (speaker_identification.py:141-151,372-398).

    python_speech_features semantics: 25 ms / 10 ms frames, NFFT 512, 26 HTK
    mel filters, DCT-II ortho, ceplifter 22, appendEnergy, preemphasis 0.97,
    rectangular window; operates on raw int16 sample values.
    """

    sample_rate: int = 16_000
    win_ms: float = 25.0
    hop_ms: float = 10.0
    n_fft: int = 512
    n_filt: int = 26
    n_cep: int = 13
    ceplifter: int = 22
    preemph: float = 0.97
    append_energy: bool = True
    delta_n: int = 2
    max_frames: int = 256              # pad/truncate target (~2.56 s)
    silent_samples: int = 4_000        # < 0.25 s post-VAD -> 'silent'

    @property
    def win_length(self) -> int:
        return int(round(self.win_ms / 1000 * self.sample_rate))   # 400

    @property
    def hop_length(self) -> int:
        return int(round(self.hop_ms / 1000 * self.sample_rate))   # 160

    @property
    def feat_dim(self) -> int:
        return self.n_cep * 3                                       # 39

    @property
    def feature_shape(self) -> Tuple[int, int]:
        return (self.max_frames, self.feat_dim)                     # (256, 39)


@dataclasses.dataclass(frozen=True)
class VadConfig:
    """WebRTC-VAD-compatible gating geometry (record_on_pc.py:229-295)."""

    frame_ms: int = 30                 # decision frame
    padding_ms: int = 300              # hysteresis ring buffer
    trigger_ratio: float = 0.9         # >90% voiced -> TRIGGERED
    aggressiveness: int = 3            # maps to threshold preset (Vad(0..3))
    silent_samples: int = 4_000        # post-VAD silence gate (0.25 s)
    # Per-frame decision function: "webrtc" = bit-exact webrtcvad
    # fixed-point engine (vad/webrtc.py — reference-faithful: every gate in
    # the reference flows through webrtcvad.Vad(3), record_on_pc.py:33; state
    # threads across windows), "energy" = calibrated log-RMS threshold (the
    # fast opt-out: agrees with the faithful decision 1.000 on clearly-voiced
    # / clearly-silent windows but only 0.500 on 0-10 dB-SNR window labels —
    # PARITY.md).  B=1 sessions auto-route the detector to the native host
    # engine when it is available (StreamingSession host_preprocess="auto").
    # The float GMM approximation (vad/gmm.py) is a benchmark/reference
    # probe, not a serving option.
    decision: str = "webrtc"

    def __post_init__(self):
        if self.decision not in ("energy", "webrtc"):
            extra = " ('gmm' was demoted to a benchmark probe in round 4; " \
                    "see vad/gmm.py)" if self.decision == "gmm" else ""
            raise ValueError(
                f"VadConfig.decision must be 'energy' or 'webrtc'"
                f"{extra}: {self.decision!r}")

    @property
    def ring_frames(self) -> int:
        return self.padding_ms // self.frame_ms                     # 10


@dataclasses.dataclass(frozen=True)
class DenoiseConfig:
    """Stationary spectral gating (noisereduce semantics; reference applies
    x1 live PC, x3 post-time `audio*`, x4 Pi — record_on_pi.py:100-112)."""

    n_fft: int = 1024
    hop_length: int = 256
    n_std_thresh: float = 1.5
    prop_decrease: float = 1.0
    freq_mask_smooth_hz: float = 500.0
    time_mask_smooth_ms: float = 50.0
    passes_live: int = 1
    passes_post: int = 3
    passes_edge: int = 4
    # Precision of the STFT/ISTFT/smoothing GEMMs (a jax.lax.Precision
    # name).  "highest" is true FP32 and the default: the denoised PCM16
    # waveform then matches a CPU float32 run up to ±1 LSB rounding ties.
    # On an H100 "default" lets float32 dots run in TF32 (about three
    # decimal digits), and "high" is TF32 as well (JAX maps HIGH to TF32 on
    # GPUs that have it), so on this card there is no middle rung.
    # Card vs CPU (chip_smoke.py phase 4, 32 windows, NVIDIA H100 80GB
    # HBM3, 700 W): at "highest" 0.103 % of int16 samples differ, each by
    # 1 LSB; at "default" (TF32) 59.5 % differ, by up to 81 LSB — TF32 is
    # for deployments that consume labels, not waveforms.
    precision: str = "highest"


@dataclasses.dataclass(frozen=True)
class OverlapModelConfig:
    """OverlapResBLSTM (overlap_detector.py:362-390).

    ``input_scale``: multiplier applied to the 0..255 feature image at the
    model boundary.  1.0 matches the reference contract (raw decode_png
    floats); 1/255 dramatically improves trainability from scratch — the
    un-normalized inputs ride the residual identity path into the BiLSTM and
    saturate it, which is why the reference needs tens of thousands of steps
    to move off chance.  Scale is part of the model config so it serializes
    with checkpoints and the serving contract stays explicit.
    """

    input_scale: float = 1.0
    stem_filters: int = 16
    stage_filters: Tuple[int, ...] = (32, 64, 128)
    blocks_per_stage: int = 3
    lstm_units: int = 256
    dropout: float = 0.25
    num_classes: int = 2
    bn_momentum: float = 0.99          # Keras defaults
    bn_eps: float = 1e-3


@dataclasses.dataclass(frozen=True)
class SpeakerModelConfig:
    """SpeakerResBLSTM (speaker_identification.py:168-218)."""

    stem_filters: int = 32
    stem_kernel: int = 4
    stage_filters: Tuple[int, ...] = (32, 64, 128)
    stage_l2: Tuple[float, ...] = (0.0, 0.1, 0.2)
    blocks_per_stage: int = 3
    lstm_units: int = 256
    dropout_trunk: float = 0.25
    dropout_head: float = 0.2
    avg_pool: int = 4
    num_speakers: int = 630            # TIMIT
    bn_momentum: float = 0.99
    bn_eps: float = 1e-3


@dataclasses.dataclass(frozen=True)
class OverlapTrainConfig:
    """Adadelta 1e-3 + cosine annealing 1e-2->1e-4 (overlap_detector.py:399-421)."""

    optimizer: str = "adadelta"
    lr: float = 1e-3
    cosine_t_max: int = 100
    cosine_eta_max: float = 1e-2
    cosine_eta_min: float = 1e-4
    early_stop_patience: int = 10
    epochs: int = 100
    batch_size: int = 32
    weighted_loss: bool = True
    # eval/prediction chunk: bounds per-program activation memory on large
    # held-out folds (a reference-scale 2,520-image fold evaluated as ONE
    # batch allocates ~8 GB of stage-0 feature maps — OOM on a 16 GB chip);
    # splits <= this size keep the historical single-batch program
    eval_batch_size: int = 512


@dataclasses.dataclass(frozen=True)
class SpeakerTrainConfig:
    """Base pretrain RMSprop 1e-4 b32 (speaker_identification.py:241-248)."""

    lr: float = 1e-4
    batch_size: int = 32
    epochs: int = 200
    early_stop_patience: int = 10


@dataclasses.dataclass(frozen=True)
class TransferConfig:
    """Two-phase registration fine-tune (speaker_identification.py:401-477)."""

    phase1_epochs: int = 500
    phase1_batch: int = 16
    phase1_lr: float = 1e-4
    phase2_epochs: int = 20
    phase2_batch: int = 8
    phase2_lr: float = 1e-6
    accuracy_gate: float = 0.80        # retrain-until gate (record_on_pc.py:344-346)
    max_retrain_rounds: int = 5


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout.  Windows are independent, so the primary axis is
    pure data parallelism; `model` stays 1 for these model sizes."""

    data_axis: str = "data"
    model_axis: str = "model"
    data_parallel: int = -1            # -1 -> all devices
    model_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level bundle: everything a session needs."""

    audio: AudioConfig = AudioConfig()
    overlap_feature: OverlapFeatureConfig = OverlapFeatureConfig()
    speaker_feature: SpeakerFeatureConfig = SpeakerFeatureConfig()
    vad: VadConfig = VadConfig()
    denoise: DenoiseConfig = DenoiseConfig()
    overlap_model: OverlapModelConfig = OverlapModelConfig()
    speaker_model: SpeakerModelConfig = SpeakerModelConfig()
    overlap_train: OverlapTrainConfig = OverlapTrainConfig()
    speaker_train: SpeakerTrainConfig = SpeakerTrainConfig()
    transfer: TransferConfig = TransferConfig()
    mesh: MeshConfig = MeshConfig()


DEFAULT = PipelineConfig()
