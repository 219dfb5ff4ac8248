"""Keras weight import: reference-trained models -> mmla_audio_tpu params.

The reference ships TIMIT-trained Keras SavedModels (weight blobs stripped in
this mount, but users of the original repo have them).  Keras
``model.get_weights()`` returns a flat list of arrays in layer-creation
order; per layer: Conv [kernel(HWIO), bias], BatchNorm [gamma, beta,
moving_mean, moving_var], Bidirectional(LSTM) [fwd_kernel(C,4H),
fwd_recurrent(H,4H), fwd_bias(4H), bwd_kernel, bwd_recurrent, bwd_bias]
(gate order i,f,c,o — identical to models.layers.lstm), Dense [kernel, bias].
Conv kernels are HWIO in both frameworks, so no transposition is needed;
this module only re-nests the flat list into the model variable tree.

Layer order is Keras's topological graph order, recovered from the shapes in
the SHIPPED checkpoint indexes (the ground truth, not the builder source):
`OverlapDetection/timit/models/timit2.0/variables/variables.index` gives, per
pooled block, BN, conv3x3, BN, conv4x1, **shortcut last** (layers 1-5 of
stage 0), and `SpeakerIdentification/timit/model/variables/variables.index`
gives, per pooled unit, BN, conv_a, BN, **shortcut**, conv_b (layers 1-5);
non-pooled blocks/units are BN, conv, BN, conv.  Model tails: overlap =
BiLSTM, Dense; speaker = final BN, BiLSTM, Dense.

Validated by round-trip tests and by shape-parity against the real
checkpoint indexes (tests/test_tfbundle.py).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from mmla_audio_tpu.core.config import OverlapModelConfig, SpeakerModelConfig

__all__ = [
    "overlap_variables_from_keras",
    "overlap_variables_to_keras",
    "speaker_variables_from_keras",
    "speaker_variables_to_keras",
    "load_checkpoint_variables",
]


class _Cursor:
    def __init__(self, flat: List[np.ndarray]):
        self.flat = flat
        self.i = 0

    def take(self, n: int) -> List[np.ndarray]:
        out = self.flat[self.i: self.i + n]
        if len(out) != n:
            raise ValueError(
                f"ran out of weights at index {self.i} of {len(self.flat)} — "
                "the checkpoint does not match the model config (pass the "
                "cfg the checkpoint was trained with)")
        self.i += n
        return out

    def done(self):
        if self.i != len(self.flat):
            raise ValueError(
                f"{len(self.flat) - self.i} unconsumed weights — the "
                "checkpoint does not match the model config (pass the cfg "
                "the checkpoint was trained with)")


def _conv(c: _Cursor) -> Dict[str, np.ndarray]:
    k, b = c.take(2)
    return {"kernel": np.asarray(k), "bias": np.asarray(b)}


def _bn(c: _Cursor):
    g, b, mean, var = c.take(4)
    return ({"scale": np.asarray(g), "bias": np.asarray(b)},
            {"mean": np.asarray(mean), "var": np.asarray(var)})


def _lstm(c: _Cursor) -> Dict[str, np.ndarray]:
    k, r, b = c.take(3)
    return {"kernel": np.asarray(k), "recurrent_kernel": np.asarray(r),
            "bias": np.asarray(b)}


def _bilstm(c: _Cursor) -> Dict[str, Any]:
    return {"forward": _lstm(c), "backward": _lstm(c)}


def _block2d(c: _Cursor, pool: bool):
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    p0, s0 = _bn(c)
    params["KerasBatchNorm_0"] = {"BatchNorm_0": p0}
    stats["KerasBatchNorm_0"] = {"BatchNorm_0": s0}
    params["Conv_0"] = _conv(c)
    p1, s1 = _bn(c)
    params["KerasBatchNorm_1"] = {"BatchNorm_0": p1}
    stats["KerasBatchNorm_1"] = {"BatchNorm_0": s1}
    params["Conv_1"] = _conv(c)
    if pool:
        params["shortcut"] = _conv(c)   # shortcut conv is LAST in graph order
    return params, stats


def overlap_variables_from_keras(flat: List[np.ndarray],
                                 cfg: OverlapModelConfig = OverlapModelConfig()
                                 ) -> Dict[str, Any]:
    """Flat Keras get_weights() list -> {'params', 'batch_stats'}."""
    c = _Cursor(list(flat))
    params: Dict[str, Any] = {"stem": _conv(c)}
    stats: Dict[str, Any] = {}
    for stage in range(len(cfg.stage_filters)):
        for block in range(cfg.blocks_per_stage):
            p, s = _block2d(c, pool=(block == 0))
            params[f"stage{stage}_block{block}"] = p
            stats[f"stage{stage}_block{block}"] = s
    params["BiLSTM_0"] = _bilstm(c)
    params["head"] = _conv(c)        # Dense: kernel + bias
    c.done()
    return {"params": params, "batch_stats": stats}


def _emit_conv(out, p):
    out.extend([np.asarray(p["kernel"]), np.asarray(p["bias"])])


def _emit_bn(out, p, s):
    out.extend([np.asarray(p["scale"]), np.asarray(p["bias"]),
                np.asarray(s["mean"]), np.asarray(s["var"])])


def _emit_bilstm(out, p):
    for d in ("forward", "backward"):
        out.extend([np.asarray(p[d]["kernel"]),
                    np.asarray(p[d]["recurrent_kernel"]),
                    np.asarray(p[d]["bias"])])


def overlap_variables_to_keras(variables: Dict[str, Any],
                               cfg: OverlapModelConfig = OverlapModelConfig()
                               ) -> List[np.ndarray]:
    """Inverse mapping (for export / round-trip testing)."""
    p = variables["params"]
    s = variables["batch_stats"]
    out: List[np.ndarray] = []
    _emit_conv(out, p["stem"])
    for stage in range(len(cfg.stage_filters)):
        for block in range(cfg.blocks_per_stage):
            bp = p[f"stage{stage}_block{block}"]
            bs = s[f"stage{stage}_block{block}"]
            _emit_bn(out, bp["KerasBatchNorm_0"]["BatchNorm_0"],
                     bs["KerasBatchNorm_0"]["BatchNorm_0"])
            _emit_conv(out, bp["Conv_0"])
            _emit_bn(out, bp["KerasBatchNorm_1"]["BatchNorm_0"],
                     bs["KerasBatchNorm_1"]["BatchNorm_0"])
            _emit_conv(out, bp["Conv_1"])
            if block == 0:
                _emit_conv(out, bp["shortcut"])
    _emit_bilstm(out, p["BiLSTM_0"])
    _emit_conv(out, p["head"])
    return out


def _unit1d(c: _Cursor, pool: bool):
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    p0, s0 = _bn(c)
    params["KerasBatchNorm_0"] = {"BatchNorm_0": p0}
    stats["KerasBatchNorm_0"] = {"BatchNorm_0": s0}
    params["conv_a"] = _conv(c)
    p1, s1 = _bn(c)
    params["KerasBatchNorm_1"] = {"BatchNorm_0": p1}
    stats["KerasBatchNorm_1"] = {"BatchNorm_0": s1}
    if pool:
        params["shortcut"] = _conv(c)   # shortcut sits between BN and conv_b
    params["conv_b"] = _conv(c)
    return params, stats


def speaker_variables_from_keras(flat: List[np.ndarray],
                                 cfg: SpeakerModelConfig = SpeakerModelConfig(),
                                 head_units: int | None = None
                                 ) -> Dict[str, Any]:
    c = _Cursor(list(flat))
    trunk: Dict[str, Any] = {"stem": _conv(c)}
    tstats: Dict[str, Any] = {}
    for stage in range(len(cfg.stage_filters)):
        for unit in range(cfg.blocks_per_stage):
            p, s = _unit1d(c, pool=(unit == 0))
            trunk[f"stage{stage}_unit{unit}"] = p
            tstats[f"stage{stage}_unit{unit}"] = s
    pf, sf = _bn(c)
    trunk["KerasBatchNorm_0"] = {"BatchNorm_0": pf}
    tstats["KerasBatchNorm_0"] = {"BatchNorm_0": sf}
    trunk["BiLSTM_0"] = _bilstm(c)
    head = _conv(c)
    if head_units is not None and head["kernel"].shape[-1] != head_units:
        # validate rather than silently ignore: a mismatch would otherwise
        # surface only at model apply time
        raise ValueError(
            f"head_units={head_units} does not match the checkpoint head "
            f"({head['kernel'].shape[-1]} units)")
    c.done()
    return {"params": {"trunk": trunk, "head": head},
            "batch_stats": {"trunk": tstats}}


def speaker_variables_to_keras(variables: Dict[str, Any],
                               cfg: SpeakerModelConfig = SpeakerModelConfig()
                               ) -> List[np.ndarray]:
    p = variables["params"]["trunk"]
    s = variables["batch_stats"]["trunk"]
    out: List[np.ndarray] = []
    _emit_conv(out, p["stem"])
    for stage in range(len(cfg.stage_filters)):
        for unit in range(cfg.blocks_per_stage):
            up = p[f"stage{stage}_unit{unit}"]
            us = s[f"stage{stage}_unit{unit}"]
            _emit_bn(out, up["KerasBatchNorm_0"]["BatchNorm_0"],
                     us["KerasBatchNorm_0"]["BatchNorm_0"])
            _emit_conv(out, up["conv_a"])
            _emit_bn(out, up["KerasBatchNorm_1"]["BatchNorm_0"],
                     us["KerasBatchNorm_1"]["BatchNorm_0"])
            if unit == 0:
                _emit_conv(out, up["shortcut"])
            _emit_conv(out, up["conv_b"])
    _emit_bn(out, p["KerasBatchNorm_0"]["BatchNorm_0"],
             s["KerasBatchNorm_0"]["BatchNorm_0"])
    _emit_bilstm(out, p["BiLSTM_0"])
    _emit_conv(out, variables["params"]["head"])
    return out


def load_checkpoint_variables(path, kind: str = "auto", *,
                              cfg=None, verify_crc: bool = False
                              ) -> Dict[str, Any]:
    """Load a reference-trained TF SavedModel checkpoint end-to-end.

    ``path`` may be a SavedModel directory (containing ``variables/``), the
    ``variables`` directory itself, or the bundle prefix
    (``.../variables/variables``).  No TensorFlow involved: the bundle is
    parsed by :mod:`mmla_audio_tpu.tfbundle`, ordered like
    ``model.get_weights()``, and re-nested into the model variable tree.

        variables = load_checkpoint_variables(
            "path/to/OverlapDetection/timit/models/timit2.0")

    ``kind`` is ``'overlap'``, ``'speaker'`` or ``'auto'`` (sniffed from the
    stem kernel rank: Conv2D HWIO = overlap, Conv1D WIO = speaker).
    """
    from pathlib import Path

    from mmla_audio_tpu.tfbundle import keras_weight_list, read_bundle

    p = Path(path)
    if (p / "variables" / "variables.index").exists():
        prefix = p / "variables" / "variables"
    elif (p / "variables.index").exists():
        prefix = p / "variables"
    else:
        prefix = p
    tensors = read_bundle(prefix, verify_crc=verify_crc)
    flat = keras_weight_list(tensors)
    if not flat:
        raise ValueError(f"{path}: no model weights found in checkpoint")
    if kind == "auto":
        kind = "overlap" if flat[0].ndim == 4 else "speaker"
    if kind == "overlap":
        return overlap_variables_from_keras(
            flat, cfg or OverlapModelConfig())
    if kind == "speaker":
        return speaker_variables_from_keras(
            flat, cfg or SpeakerModelConfig())
    raise ValueError(f"kind must be 'overlap', 'speaker' or 'auto': {kind!r}")
