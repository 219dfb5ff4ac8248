"""Registration fine-tune latency: the BASELINE north-star flow.

The reference's speaker registration runs Keras ``fit`` for 500 + 20 epochs
at batch 16/8 on the enrolled corpus — minutes of wall clock per
registration attempt (and the acc >= 0.80 gate can demand several attempts).
Here the entire two-phase fine-tune is two ``lax.scan`` programs on the device;
this benchmark measures one full attempt (500 + 20 epochs, reference
hyperparameters) on a realistic enrolled corpus: 3 speakers x ~23 windows
(60 s each).

Usage: python benchmarks/transfer_bench.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import json
import time

import numpy as np


def main():
    import jax

    from mmla_audio_tpu.core.config import SpeakerModelConfig, TransferConfig
    from mmla_audio_tpu.models.speaker import SpeakerResBLSTM
    from mmla_audio_tpu.train.transfer import TransferLearner

    cfg = SpeakerModelConfig()
    base = SpeakerResBLSTM(cfg)
    base_vars = base.init_variables(jax.random.PRNGKey(0))

    rng = np.random.RandomState(0)
    n_speakers, windows_each = 3, 23
    x = rng.randn(n_speakers * windows_each, 256, 39).astype(np.float32)
    for c in range(n_speakers):
        x[c * windows_each:(c + 1) * windows_each, :, c * 12:(c + 1) * 12] += 2.0
    y = np.zeros((len(x), n_speakers), np.float32)
    for c in range(n_speakers):
        y[c * windows_each:(c + 1) * windows_each, c] = 1.0

    learner = TransferLearner(base_vars, n_speakers, model_cfg=cfg,
                              cfg=TransferConfig())

    t0 = time.perf_counter()
    variables, acc, losses = learner.fit_once(x, y, seed=0)
    t_first = time.perf_counter() - t0          # includes compile

    t0 = time.perf_counter()
    variables, acc, losses = learner.fit_once(x, y, seed=1)
    t_steady = time.perf_counter() - t0         # retrain attempt (cached)

    print(json.dumps({
        "metric": "registration_finetune_seconds",
        "value": round(t_steady, 2),
        "unit": "s per 520-epoch attempt",
        "first_attempt_incl_compile_s": round(t_first, 2),
        "val_acc": round(float(acc), 3),
        "corpus_windows": len(x),
        "device": str(jax.devices()[0]),
    }))


if __name__ == "__main__":
    main()
