"""Speaker identifier: 1D ResNet -> AvgPool -> BiLSTM -> Dense(630).

Architecture parity with the reference `res_model`
(`SpeakerIdentification/scripts/speaker_identification.py:168-218`):
Conv1D(32, k4) stem; 3 stages x 3 `res_unit` (32/64/128; the first unit of a
stage MaxPools the main path and projects the shortcut with a strided 1x1;
deeper stages add l2 0.1/0.2 on inner convs); BN+ReLU+Dropout 0.25;
AveragePooling1D(4, valid); BiLSTM(256); Dropout 0.2; Dense(630, softmax).

Geometry: (B, 256, 39) -> 128 -> 64 -> 32 frames -> AvgPool(4) -> (B, 8, 128)
-> BiLSTM -> (B, 512) -> logits(630).

The model is split into ``trunk`` + ``head`` so registration transfer-learning
(`speaker_identification.py:401-477`: slice at layers[-2], freeze, new
Dense(n_speakers, sigmoid)) maps to: reuse trunk params frozen, fresh head.

L2 regularization is part of the *loss* in Keras; ``l2_penalty`` computes the
same penalty from the param tree (coefficients recorded per conv path).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import jax
import jax.numpy as jnp

from mmla_audio_tpu.core.config import SpeakerModelConfig
from mmla_audio_tpu.models import layers as L

__all__ = ["SpeakerResBLSTM", "l2_penalty"]


def _unit_init(rng, path, c_in, filters, pool):
    """res_unit (speaker_identification.py:168-190)."""
    p, s = {}, {}
    if pool:
        p["shortcut"] = L.conv_init(rng, path + ("shortcut",), (1,), c_in, filters)
    p["KerasBatchNorm_0"], s["KerasBatchNorm_0"] = L.batch_norm_init(c_in)
    p["conv_a"] = L.conv_init(rng, path + ("conv_a",), (3,), c_in, filters)
    p["KerasBatchNorm_1"], s["KerasBatchNorm_1"] = L.batch_norm_init(filters)
    p["conv_b"] = L.conv_init(rng, path + ("conv_b",), (3,), filters, filters)
    return p, s


def _unit(p, s, x, pool, train, bn):
    """Note the asymmetry vs the 2D block: when pooling, the *main path input*
    is MaxPooled before BN and the shortcut is a strided 1x1 of the original
    input."""
    res = x
    if pool:
        x = L.max_pool(x, 2, 2)
        res = L.conv(p["shortcut"], res, strides=2)
    out, s0 = L.batch_norm(p["KerasBatchNorm_0"], s["KerasBatchNorm_0"], x, train, *bn)
    out = L.conv(p["conv_a"], jax.nn.relu(out))
    out, s1 = L.batch_norm(p["KerasBatchNorm_1"], s["KerasBatchNorm_1"], out, train, *bn)
    out = L.conv(p["conv_b"], jax.nn.relu(out))
    return res + out, {"KerasBatchNorm_0": s0, "KerasBatchNorm_1": s1}


@dataclasses.dataclass(frozen=True)
class SpeakerResBLSTM:
    """Trunk + Dense head.  ``head_units=None`` -> cfg.num_speakers (TIMIT
    630, softmax in loss); transfer-learned models use a fresh smaller head
    with sigmoid activation applied by the caller/loss.

    The trunk is everything up to (and including) the post-BiLSTM dropout —
    the ``layers[-2]`` slice point of the reference transfer learner."""

    cfg: SpeakerModelConfig = SpeakerModelConfig()
    head_units: int | None = None

    def _units(self):
        for stage, f in enumerate(self.cfg.stage_filters):
            for block in range(self.cfg.blocks_per_stage):
                yield f"stage{stage}_unit{block}", f, block == 0

    def init_variables(self, rng, batch: int = 1, input_shape=(256, 39)):
        """``{"params", "batch_stats"}`` for inputs ``(batch, *input_shape)``
        (the batch does not change any shape; it is kept for callers)."""
        cfg = self.cfg
        trunk = {"stem": L.conv_init(rng, ("trunk", "stem"), (cfg.stem_kernel,),
                                     input_shape[-1], cfg.stem_filters)}
        stats = {}
        c = cfg.stem_filters
        for name, f, pool in self._units():
            trunk[name], stats[name] = _unit_init(rng, ("trunk", name), c, f, pool)
            c = f
        trunk["KerasBatchNorm_0"], stats["KerasBatchNorm_0"] = L.batch_norm_init(c)
        trunk["BiLSTM_0"] = L.bilstm_init(rng, ("trunk", "BiLSTM_0"), c,
                                          cfg.lstm_units)
        head = L.dense_init(rng, ("head",), 2 * cfg.lstm_units,
                            self.head_units or cfg.num_speakers)
        return {"params": {"trunk": trunk, "head": head},
                "batch_stats": {"trunk": stats}}

    def _forward(self, params, stats, x, train, rng):
        cfg = self.cfg
        bn = (cfg.bn_momentum, cfg.bn_eps)
        p, s = params["trunk"], stats["trunk"]
        new = {}
        net = L.conv(p["stem"], x)
        # L2 on the inner convs of non-pooled units (stages 1/2) is applied in
        # the loss by ``l2_penalty`` below — Keras regularizers live in the
        # loss, not the layer, so the unit itself carries no l2 state.
        for name, _, pool in self._units():
            net, new[name] = _unit(p[name], s[name], net, pool, train, bn)
        net, new["KerasBatchNorm_0"] = L.batch_norm(
            p["KerasBatchNorm_0"], s["KerasBatchNorm_0"], net, train, *bn)
        net = jax.nn.relu(net)
        net = L.dropout(net, cfg.dropout_trunk, rng, ("trunk", "Dropout_0"))
        # Keras AveragePooling1D(4): valid padding, stride = pool size.
        net = L.avg_pool(net, cfg.avg_pool)
        net = L.bilstm(p["BiLSTM_0"], net)                       # (B, 512)
        net = L.dropout(net, cfg.dropout_head, rng, ("trunk", "Dropout_1"))
        return L.dense(params["head"], net), {"trunk": new}

    def apply(self, variables, x, train: bool = False, rngs=None, mutable=()):
        """Logits ``(B, head units)``; ``train=True`` uses batch statistics
        and dropout from ``rngs["dropout"]``.  With ``mutable`` the result is
        ``(logits, {"batch_stats": updated})``."""
        return L.apply_variables(self._forward, variables, x, train, rngs, mutable)


def l2_penalty(params: Dict[str, Any], cfg: SpeakerModelConfig = SpeakerModelConfig()
               ) -> jnp.ndarray:
    """Keras kernel_regularizer l2 penalty: sum over the regularized convs of
    ``coeff * sum(kernel**2)`` (speaker_identification.py:176-187: inner convs
    of non-pooled units in stages 1/2, coeffs 0.1/0.2)."""
    total = jnp.asarray(0.0, jnp.float32)
    trunk = params.get("trunk", params)
    for stage, l2c in enumerate(cfg.stage_l2):
        if l2c <= 0:
            continue
        for block in range(1, cfg.blocks_per_stage):
            unit = trunk[f"stage{stage}_unit{block}"]
            for conv in ("conv_a", "conv_b"):
                k = unit[conv]["kernel"]
                total = total + l2c * jnp.sum(jnp.square(k))
    return total
