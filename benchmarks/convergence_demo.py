"""Full-pipeline convergence demo: synthetic corpus -> reference training
recipe -> held-out accuracy, on the device, wall-clock included.

This is the `overlap-train` flow (OverlapTrainer.train: stratified 5-fold
fold-0 split, cal_weighted_penalty class weights, Adadelta + cosine
annealing + early stopping, scanned epochs) at the FULL model size on a
synthetic single-vs-overlapped corpus built with the same mixture
synthesizer the `synth-corpus` CLI uses.  Only deviation from the reference
contract: ``input_scale=1/255`` (documented in OverlapModelConfig — raw
0..255 images saturate the BiLSTM via the residual identity path and need
tens of thousands of steps to move off chance; the scale is part of the
serialized model config, so serving stays consistent with the checkpoint).

Run live:  python benchmarks/convergence_demo.py [--windows N] [--epochs E]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def synth_speech_i16(n, seed):
    """Harmonic-stack speech-alike (same generator family as tests)."""
    rng = np.random.RandomState(seed)
    t = np.arange(n) / 16000.0
    f0 = 85 + 95 * rng.rand()
    sig = sum(np.sin(2 * np.pi * f0 * k * t + rng.rand() * 2 * np.pi) / k
              for k in range(1, 10))
    sig *= 0.4 * (1.0 + np.sin(2 * np.pi * (2.0 + 3.0 * rng.rand()) * t))
    sig = sig * 5000 + rng.randn(n) * 150
    return np.clip(sig, -32767, 32767).astype(np.int16)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=2048,
                    help="windows per class")
    ap.add_argument("--epochs", type=int, default=40)
    ap.add_argument("--patience", type=int, default=30,
                    help="early-stop patience: the Keras-default BN momentum "
                         "(0.99) means running stats lag batch stats by "
                         "~100s of steps, so val accuracy moves late; the "
                         "reference default (10) stops too early at this "
                         "corpus size")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from mmla_audio_tpu.core.config import (
        OverlapModelConfig,
        OverlapTrainConfig,
    )
    from mmla_audio_tpu.data.synth import make_mixture
    from mmla_audio_tpu.ops.features import overlap_model_input
    from mmla_audio_tpu.train.overlap_trainer import OverlapTrainer

    rng = np.random.RandomState(0)
    npc = args.windows

    print(f"[demo] synthesizing {2 * npc} windows ...",
          file=sys.stderr, flush=True)
    buf = np.zeros((2 * npc, 24000), np.float32)
    for i in range(npc):
        s = synth_speech_i16(24000, seed=1000 + i)
        buf[i, :len(s)] = s
        parts = [synth_speech_i16(30000, seed=10_000 + 3 * i + j)
                 for j in range(2 + (i % 3))]       # 2-4 concurrent speakers
        m = make_mixture(parts, rng)[:24000]
        buf[npc + i, :len(m)] = m
    y = np.zeros((2 * npc, 2), np.float32)
    y[:npc, 0] = 1.0
    y[npc:, 1] = 1.0

    print("[demo] featurizing on device (batched) ...",
          file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    feats = []
    featurize = jax.jit(overlap_model_input)
    for i in range(0, len(buf), 256):
        feats.append(featurize(jnp.asarray(buf[i:i + 256] / 32768.0)))
    # stays device-resident: Trainer.fit pads/masks jax.Arrays on device,
    # so the ~1 GB feature tensor never round-trips through the host
    feats = jnp.concatenate(feats)
    _ = np.asarray(feats[-1, -1, -1])   # host fetch: the featurization has finished
    t_feat = time.perf_counter() - t0
    print(f"[demo] features {feats.shape} in {t_feat:.1f} s",
          file=sys.stderr, flush=True)

    mcfg = OverlapModelConfig(input_scale=1 / 255.0)
    tcfg = OverlapTrainConfig(epochs=args.epochs,
                              early_stop_patience=args.patience)
    ot = OverlapTrainer(mcfg, tcfg)
    t0 = time.perf_counter()
    state, history, (x_test, y_test) = ot.train(
        feats, y, weighted=True, seed=0, verbose=True)
    t_train = time.perf_counter() - t0

    ev = ot.evaluation(state, x_test, y_test)
    out = {
        "device": str(jax.devices()[0]),
        "n_windows": int(2 * npc),
        "epochs_run": len(history["loss"]),
        "train_wall_s": round(t_train, 1),
        "featurize_wall_s": round(t_feat, 1),
        "final_train_acc": round(float(history["acc"][-1]), 4),
        "best_val_acc": round(float(max(history["val_acc"])), 4),
        "final_val_acc": round(float(history["val_acc"][-1]), 4),
        "confusion": np.asarray(ev["confusion"]).tolist(),
        "recall": np.round(np.asarray(ev["recall"]), 4).tolist(),
        "precision": np.round(np.asarray(ev["precision"]), 4).tolist(),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
