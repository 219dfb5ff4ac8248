"""mmla_audio_tpu — a streaming audio-analytics framework on one accelerator.

A ground-up rebuild of the capabilities of ``lizaibeim/mmla-audio`` (overlap
detection + speaker identification over rolling conversation windows) for an
NVIDIA GPU: the entire feature + inference + fine-tune path is expressed as
fixed-shape JAX/XLA programs, scaled over device meshes with
``jax.sharding``, and fed by a thin native host runtime (C++ ring buffer +
WAV IO) instead of disk round-trips.

Subpackages
-----------
core       typed configuration (sample rates, window geometry, model dims, mesh)
ops        DSP as GEMMs: STFT/mel/ZCR/MFCC/denoise/normalize (jnp)
vad        voice-activity gating as jittable scans (WebRTC-style hysteresis)
models     plain-JAX models: OverlapResBLSTM (2D) and SpeakerResBLSTM (1D)
train      Optax training: base pretrain, transfer-learn registration loop
parallel   mesh construction + data-parallel sharding of window batches
streaming  host capture shims, native ring buffer, streaming sessions
data       WAV IO, TIMIT ingest, overlap-mixture synthesis, augmentation
analyze    post-time batch pipelines, TSV logs, HTML distribution charts
utils      experiment dir layout, timers, profiling
"""

from mmla_audio_tpu.version import __version__

__all__ = ["__version__"]
