"""Jitted window-to-label inference: the serve layer.

The reference's hot loop writes each 2.56 s window to a WAV, denoises it,
VAD-trims it, writes a PNG, re-reads the PNG, and calls ``model.predict`` at
batch 1 (`record_on_pc.py:114-173`).  Here the entire decision is ONE compiled
XLA program over a fixed-shape device buffer:

    (B, 40960) int16-scale samples + (B,) valid counts
        -> featurize (GEMM DSP) -> model forward -> argmax + silent gate
        -> (B,) int32 labels

Silent windows (< 4000 valid samples post-VAD, `record_on_pc.py:142`,
`speaker_identification.py:375`) get the sentinel class ``SILENT`` so the
whole batch stays data-parallel — no host round-trip per window.

Predictors precompile per batch size; windows are independent, so scaling is
pure data parallelism (see ``parallel``).
"""

from __future__ import annotations


from typing import Any, Dict

import jax
import jax.numpy as jnp
import numpy as np

from mmla_audio_tpu.core.config import (
    OverlapFeatureConfig,
    OverlapModelConfig,
    SpeakerFeatureConfig,
    SpeakerModelConfig,
)
from mmla_audio_tpu.models.overlap import OverlapResBLSTM
from mmla_audio_tpu.models.speaker import SpeakerResBLSTM
from mmla_audio_tpu.ops.features import overlap_model_input, speaker_feature_batch

__all__ = ["SILENT", "OverlapPredictor", "SpeakerPredictor"]

SILENT = -1  # label index for the silent gate (reference logs the string)


def _masked_prefix(buf: jnp.ndarray, n: jnp.ndarray, length: int) -> jnp.ndarray:
    """First ``length`` samples of each row, zero beyond the valid count."""
    pre = buf[..., :length]
    idx = jnp.arange(length)
    return jnp.where(idx < n[..., None], pre, 0.0)


def _policy_apply(model, variables, x, compute_dtype, matmul_precision):
    """Model forward under a predictor's numerics policy: optional bf16
    cast of params+input, optional forced GEMM precision, f32 logits out.
    Every serving path must route model calls through the predictor's
    ``apply_model`` (which calls this) — a direct ``model.apply`` silently
    drops the policy (the bug class: sessions/multiplexer/post-time each
    traced their own apply and ``--precision``/``compute_dtype`` no-opped)."""
    if compute_dtype is not None:
        variables = jax.tree_util.tree_map(
            lambda v: v.astype(compute_dtype)
            if jnp.issubdtype(v.dtype, jnp.floating) else v, variables)
        x = x.astype(compute_dtype)
    if matmul_precision is not None:
        with jax.default_matmul_precision(matmul_precision):
            return model.apply(variables, x).astype(jnp.float32)
    return model.apply(variables, x).astype(jnp.float32)


def _as_device_pcm(buf) -> jnp.ndarray:
    """Accepted input dtypes: int16 PCM passes through untouched (half the
    host->HBM bytes; cast to f32 happens in-program), float32 passes through,
    anything else is cast to float32 host-side."""
    buf = jnp.asarray(buf)
    if buf.dtype not in (jnp.int16, jnp.float32):
        buf = buf.astype(jnp.float32)
    return buf


class OverlapPredictor:
    """Overlap detection over (denoised, VAD-trimmed) windows.

    ``predict(buf, n)``: ``buf (B, >=24000)`` raw PCM samples — int16
    preferred (cheapest transfer) or float32 at int16 scale — with ``n (B,)``
    valid counts -> ``(labels (B,), probs (B, C))`` and label SILENT where
    ``n < 4000``.
    """

    def __init__(self, variables: Dict[str, Any],
                 model_cfg: OverlapModelConfig = OverlapModelConfig(),
                 feat_cfg: OverlapFeatureConfig = OverlapFeatureConfig(),
                 compute_dtype=None,
                 matmul_precision: str | None = "auto",
                 silent_threshold: int = 4000):
        """``compute_dtype=jnp.bfloat16`` runs the model forward in bf16
        (params cast at trace time; DSP stays f32 for feature parity).
        ``matmul_precision="highest"`` forces true-FP32 dots/convs in the
        model trunk; the backend's default lets an H100 run float32 dots and
        convs in TF32.  ``"auto"`` (the default) resolves to the backend's
        default HERE — the overlap trunk is conv-heavy — unlike
        SpeakerPredictor, whose "auto" resolves to "highest".  Against a CPU
        float32 run (chip_smoke.py phase 4, 32 windows, random init, NVIDIA
        H100 80GB HBM3 at 700 W): default — labels 1.0000 agreement, max
        prob drift 7.1e-4; "highest" — 1.0000, 7.3e-5.  PARITY.md has the
        table.
        ``silent_threshold``: post-VAD sample count below which the window
        is SILENT (`record_on_pc.py:142`); pass ``cfg.vad.silent_samples``
        to mirror a tuned session gate."""
        if matmul_precision == "auto":
            matmul_precision = None
        self.model = OverlapResBLSTM(model_cfg)
        self.variables = variables
        self.feat_cfg = feat_cfg
        self.silent_threshold = silent_threshold
        self.compute_dtype = compute_dtype
        self.matmul_precision = matmul_precision
        self._jit = jax.jit(self._forward)

    def _forward(self, variables, buf, n):
        if self.matmul_precision is not None:
            with jax.default_matmul_precision(self.matmul_precision):
                return self._forward_body(variables, buf, n)
        return self._forward_body(variables, buf, n)

    def _forward_body(self, variables, buf, n):
        cfg = self.feat_cfg
        # librosa.load scale: int16 -> [-1, 1)
        y = _masked_prefix(buf.astype(jnp.float32), n, cfg.n_samples) / 32768.0
        img = overlap_model_input(y, cfg)                      # (B, 128, 151, 3)
        logits = self.apply_model(variables, img)
        probs = jax.nn.softmax(logits, axis=-1)
        labels = jnp.argmax(probs, axis=-1).astype(jnp.int32)
        labels = jnp.where(n < self.silent_threshold, SILENT, labels)
        return labels, probs

    def apply_model(self, variables, x):
        """Model forward under this predictor's numerics policy — use this
        (not ``model.apply``) from any fused program built around the
        predictor, or ``compute_dtype``/``matmul_precision`` silently stop
        applying."""
        return _policy_apply(self.model, variables, x,
                             self.compute_dtype, self.matmul_precision)

    def predict(self, buf, n):
        buf = _as_device_pcm(buf)
        n = jnp.asarray(n, jnp.int32)
        if buf.ndim == 1:
            labels, probs = self._jit(self.variables, buf[None], n[None])
            return labels[0], probs[0]
        return self._jit(self.variables, buf, n)

    def lower_fn(self):
        """(fn, variables) pair for AOT compilation / sharding wrappers."""
        return self._forward


class SpeakerPredictor:
    """Speaker identification over (denoised, VAD-trimmed) windows.

    ``predict(buf, n)``: ``buf (B, 40960)`` raw PCM (int16 preferred, or
    float32 at int16 scale), ``n (B,)`` -> ``(labels (B,),
    probs (B, n_speakers))`` with SILENT gate.  Map label -> name via the
    enrollment ``speaker_id_dict``.
    """

    def __init__(self, variables: Dict[str, Any],
                 model_cfg: SpeakerModelConfig = SpeakerModelConfig(),
                 feat_cfg: SpeakerFeatureConfig = SpeakerFeatureConfig(),
                 head_units: int | None = None,
                 sigmoid_head: bool = False,
                 compute_dtype=None,
                 matmul_precision: str | None = "auto"):
        """``matmul_precision``: ``"auto"`` (the default) resolves to
        ``"highest"`` — true-FP32 dots/convs in the trunk, where the
        backend's default may be TF32 (an H100's).  The reference's own
        parity bar is argmax agreement (tfl_convert.py:86-87), and the speaker
        model's 630-way head is the one whose labels move with the
        precision, so the faithful setting is the default here; the overlap
        predictor keeps the backend's default.  Against a CPU float32 run
        (chip_smoke.py phase 4, 32 windows, random init, NVIDIA H100 80GB
        HBM3 at 700 W): "highest" — labels 1.0000, max prob drift 6.1e-9;
        default (TF32) — 1.0000, 1.0e-5.  Pass ``None`` for the backend's
        default (the labels-only throughput knob)."""
        if matmul_precision == "auto":
            matmul_precision = "highest"
        self.model = SpeakerResBLSTM(model_cfg, head_units=head_units)
        self.variables = variables
        self.feat_cfg = feat_cfg
        self.sigmoid_head = sigmoid_head
        self.compute_dtype = compute_dtype
        self.matmul_precision = matmul_precision
        self._jit = jax.jit(self._forward)
        self._logits_jit = jax.jit(
            lambda v, feats: self.apply_model(v, feats))

    def _forward(self, variables, buf, n):
        if self.matmul_precision is not None:
            with jax.default_matmul_precision(self.matmul_precision):
                return self._forward_body(variables, buf, n)
        return self._forward_body(variables, buf, n)

    def _forward_body(self, variables, buf, n):
        cfg = self.feat_cfg
        feats, _ = speaker_feature_batch(buf.astype(jnp.float32), n, cfg)
        logits = self.apply_model(variables, feats)
        # Transfer-learned heads use sigmoid activation
        # (speaker_identification.py:409); argmax is invariant but the
        # probabilities logged differ.
        probs = jax.nn.sigmoid(logits) if self.sigmoid_head else \
            jax.nn.softmax(logits, axis=-1)
        labels = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        labels = jnp.where(n < cfg.silent_samples, SILENT, labels)
        return labels, probs

    def apply_model(self, variables, x):
        """Model forward under this predictor's numerics policy — use this
        (not ``model.apply``) from any fused program built around the
        predictor; see OverlapPredictor.apply_model."""
        return _policy_apply(self.model, variables, x,
                             self.compute_dtype, self.matmul_precision)

    def predict(self, buf, n):
        buf = _as_device_pcm(buf)
        n = jnp.asarray(n, jnp.int32)
        if buf.ndim == 1:
            labels, probs = self._jit(self.variables, buf[None], n[None])
            return labels[0], probs[0]
        return self._jit(self.variables, buf, n)

    def logits_from_features(self, feats):
        """Forward on precomputed (B, 256, 39) features (post-time path
        featurizes whole conversations in one pass and slices)."""
        return self._logits_jit(self.variables, jnp.asarray(feats, jnp.float32))

    def lower_fn(self):
        return self._forward
