"""Overlap detector: ResNet-CNN -> mel-mean -> BiLSTM -> softmax.

Architecture parity with the reference `__ResBLSTM`
(`OverlapDetection/scripts/overlap_detector.py:362-390` with `res_block`
:227-256): Conv2D(16, k1) stem; 3 stages x 3 residual blocks (32/64/128
filters; the first block of each stage downsamples by 2 via a strided 1x1
projection on the shortcut and a MaxPool on the main path; inner convs are
k3 then k(4,1); pre-activation BN+ELU); mean over the 128-mel axis;
Bidirectional LSTM(256); Dropout 0.25; LeakyReLU; Dense softmax.

Input is the PNG-round-tripped feature image: (B, 128, 151, 3) float32 in
0..255 (`record_on_pc.py:156-159`).  Geometry: 128x151 -> 64x76 -> 32x38 ->
16x19 -> mel-mean -> (B, 19, 128) -> BiLSTM -> (B, 512).

Returns logits; apply ``jax.nn.softmax`` (or use the Keras-CCE losses in
``train.losses``, which replicate the reference's probability-space loss).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from mmla_audio_tpu.core.config import OverlapModelConfig
from mmla_audio_tpu.models import layers as L

__all__ = ["OverlapResBLSTM"]


def _block_init(rng, name, c_in, filters, pool):
    """Pre-activation residual block (overlap_detector.py:227-256)."""
    p, s = {}, {}
    if pool:
        p["shortcut"] = L.conv_init(rng, (name, "shortcut"), (1, 1), c_in, filters)
    p["KerasBatchNorm_0"], s["KerasBatchNorm_0"] = L.batch_norm_init(c_in)
    p["Conv_0"] = L.conv_init(rng, (name, "Conv_0"), (3, 3), c_in, filters)
    p["KerasBatchNorm_1"], s["KerasBatchNorm_1"] = L.batch_norm_init(filters)
    p["Conv_1"] = L.conv_init(rng, (name, "Conv_1"), (4, 1), filters, filters)
    return p, s


def _block(p, s, x, pool, train, bn):
    res = L.conv(p["shortcut"], x, strides=2) if pool else x
    out, s0 = L.batch_norm(p["KerasBatchNorm_0"], s["KerasBatchNorm_0"], x, train, *bn)
    out = L.conv(p["Conv_0"], jax.nn.elu(out))
    out, s1 = L.batch_norm(p["KerasBatchNorm_1"], s["KerasBatchNorm_1"], out, train, *bn)
    out = L.conv(p["Conv_1"], jax.nn.elu(out))
    if pool:
        out = L.max_pool(out, 2, 2)
    return res + out, {"KerasBatchNorm_0": s0, "KerasBatchNorm_1": s1}


@dataclasses.dataclass(frozen=True)
class OverlapResBLSTM:
    cfg: OverlapModelConfig = OverlapModelConfig()

    def _blocks(self):
        for stage, f in enumerate(self.cfg.stage_filters):
            for block in range(self.cfg.blocks_per_stage):
                yield f"stage{stage}_block{block}", f, block == 0

    def init_variables(self, rng, batch: int = 1, input_shape=(128, 151, 3)):
        """``{"params", "batch_stats"}`` for inputs ``(batch, *input_shape)``
        (the batch does not change any shape; it is kept for callers)."""
        cfg = self.cfg
        params = {"stem": L.conv_init(rng, ("stem",), (1, 1), input_shape[-1],
                                      cfg.stem_filters)}
        stats = {}
        c = cfg.stem_filters
        for name, f, pool in self._blocks():
            params[name], stats[name] = _block_init(rng, name, c, f, pool)
            c = f
        params["BiLSTM_0"] = L.bilstm_init(rng, ("BiLSTM_0",), c, cfg.lstm_units)
        params["head"] = L.dense_init(rng, ("head",), 2 * cfg.lstm_units,
                                      cfg.num_classes)
        return {"params": params, "batch_stats": stats}

    def _forward(self, params, stats, x, train, rng):
        cfg = self.cfg
        bn = (cfg.bn_momentum, cfg.bn_eps)
        if cfg.input_scale != 1.0:
            x = x * cfg.input_scale
        net = L.conv(params["stem"], x)
        new_stats = {}
        for name, _, pool in self._blocks():
            net, new_stats[name] = _block(params[name], stats[name], net, pool,
                                          train, bn)
        net = jnp.mean(net, axis=1)                    # mel-axis mean -> (B, T, C)
        net = L.bilstm(params["BiLSTM_0"], net)        # (B, 512)
        net = L.dropout(net, cfg.dropout, rng, ("Dropout_0",))
        net = L.leaky_relu(net)
        return L.dense(params["head"], net), new_stats

    def apply(self, variables, x, train: bool = False, rngs=None, mutable=()):
        """Logits ``(B, num_classes)``; ``train=True`` uses batch statistics
        and dropout from ``rngs["dropout"]``.  With ``mutable`` the result is
        ``(logits, {"batch_stats": updated})``."""
        return L.apply_variables(self._forward, variables, x, train, rngs, mutable)
