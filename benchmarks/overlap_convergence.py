"""Overlap-detector reference-scale convergence proof.

The overlap analog of ``speaker_convergence.py``: the reference's FULL
L9+L4 workflow at its true scale, on device, wall-clock included —

  corpus     6,300 synthetic mixtures through the real corpus synthesizer
             (``data.synth.synthesize_corpus``: 2/3/4/5-speaker schedule at
             the reference's 3150/5040/5985 thresholds, pydub-overlay
             semantics; `data_augmentation.py:37-76`) + 6,300 single-speaker
             segments (one per TIMIT-layout clip, `:79-99`) from a 630-voice
             x 10-clip synthetic pool — the reference's exact 12,600-image
             composition
  features   batched on-device ZCR/log-mel images (PNG-quantized), chunked
             int16 uploads
  training   ``OverlapTrainer.train`` — sklearn-exact stratified fold 0,
             **pyramid augmentation on**, cal_weighted_penalty class
             weights, Adadelta + cosine annealing + early stopping
             (`overlap_detector.py:424-459`)
  eval       confusion matrix / recall / precision / accuracy on the
             held-out fold (`evaluation`, :513-543)

On the reference's own composition the classes are balanced (6,300 vs
6,300), so ``augment_images``' duplication ratio ``round(max/count - 1)``
is 0 *in the reference too* — the ladder is a no-op there and exists for
imbalanced corpora (e.g. MULTISIMO eval sets).  To prove the ladder at
scale on device, ``--singles-frac 1/3`` (phase 2 default) drops 2/3 of the
singles: ratio = round(6300/2100 - 1) = 2, so every surviving single is
duplicated twice through 1- and 2-round pyrDown/pyrUp blurs before
training — the exact `overlap_detector.py:142-225` path, at corpus scale.

Run live:  python benchmarks/overlap_convergence.py
           [--mixtures N] [--singles-frac F] [--epochs E] [--skip-balanced]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import numpy as np

from speaker_convergence import speaker_voice, synth_utterance

SR = 16000
SEG = 24000            # 1.5 s feature segment (OverlapFeatureConfig)
CLIP = 36000           # 2.25 s source "utterance" (TIMIT clips run longer
                       # than the 1.5 s canvas, so overlays always truncate)


def _clip(speaker: int, sample: int) -> np.ndarray:
    """One int16 clip of the synthetic TIMIT-layout pool (630 x 10)."""
    w = synth_utterance(speaker_voice(speaker), CLIP,
                        5_000_011 + 7919 * speaker + sample)
    return np.clip(np.rint(w), -32768, 32767).astype(np.int16)


def build_corpus(n_mixtures: int, singles_frac: float, seed: int = 0):
    """Returns (int16 windows (N, SEG), one-hot labels (N, 2)): singles
    first (class 0), mixtures after (class 1)."""
    from mmla_audio_tpu.data.synth import synthesize_corpus

    n_speakers, cps = 630, 10
    n_singles = int(round(n_mixtures * singles_frac))
    buf = np.zeros((n_singles + n_mixtures, SEG), np.int16)
    # memoize the whole pool (6300 int16 clips = ~450 MB host): every clip
    # is synthesized at most once across singles AND mixture draws
    cache = {}

    def clip(sp, sm):
        key = (sp, sm)
        if key not in cache:
            cache[key] = _clip(sp, sm)
        return cache[key]

    # singles: one segment per pool clip, in layout order, like the
    # reference's labels.csv sweep (subsampled evenly for singles_frac < 1)
    order = np.linspace(0, n_speakers * cps - 1, n_singles).astype(int)
    for r, k in enumerate(order):
        s = clip(k // cps, k % cps)[:SEG]
        buf[r, : len(s)] = s

    def sink(i, mix):
        m = mix[:SEG]
        buf[n_singles + i, : len(m)] = m

    def loader(sp, sm):
        return clip(sp, sm), f"spk{sp}"

    synthesize_corpus(loader, n_mixtures=n_mixtures, n_speakers=n_speakers,
                      clips_per_speaker=cps, seed=seed, sr=SR, sink=sink)
    y = np.zeros((len(buf), 2), np.float32)
    y[:n_singles, 0] = 1.0
    y[n_singles:, 1] = 1.0
    return buf, y


def featurize_corpus(buf_i16: np.ndarray, chunk: int = 256):
    """Chunked batched on-device featurization; int16 uploads (half the
    host-to-device bytes), features stay device-resident."""
    import jax
    import jax.numpy as jnp

    from mmla_audio_tpu.ops.features import overlap_model_input

    featurize = jax.jit(lambda w: overlap_model_input(
        w.astype(jnp.float32) / 32768.0))
    outs = []
    for i in range(0, len(buf_i16), chunk):
        part = buf_i16[i: i + chunk]
        short = chunk - len(part)
        if short:
            part = np.concatenate([part, part[-1:].repeat(short, 0)])
        outs.append(featurize(jnp.asarray(part))[: chunk - short])
    feats = jnp.concatenate(outs) if len(outs) > 1 else outs[0]
    _ = np.asarray(feats[-1, -1, -1, -1])     # host fetch: work finished
    return feats


def run_phase(tag, n_mixtures, singles_frac, epochs, patience, seed=0,
              small_model=False):
    import jax

    from mmla_audio_tpu.core.config import (OverlapModelConfig,
                                            OverlapTrainConfig)
    from mmla_audio_tpu.train.overlap_trainer import OverlapTrainer

    print(f"[ovl:{tag}] synthesizing {n_mixtures} mixtures + "
          f"{int(round(n_mixtures * singles_frac))} singles ...",
          file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    buf, y = build_corpus(n_mixtures, singles_frac, seed=seed)
    t_synth = time.perf_counter() - t0
    print(f"[ovl:{tag}] corpus {buf.shape} in {t_synth:.1f} s; "
          f"featurizing on device ...", file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    feats = featurize_corpus(buf)
    t_feat = time.perf_counter() - t0
    print(f"[ovl:{tag}] features {feats.shape} in {t_feat:.1f} s; "
          f"training (full recipe, augmented=True) ...",
          file=sys.stderr, flush=True)

    mcfg = OverlapModelConfig(input_scale=1 / 255.0)
    if small_model:            # CPU plumbing smoke only, never the device proof
        mcfg = OverlapModelConfig(input_scale=1 / 255.0,
                                  stage_filters=(4, 4, 8), lstm_units=8)
    tcfg = OverlapTrainConfig(epochs=epochs, early_stop_patience=patience)
    ot = OverlapTrainer(mcfg, tcfg)
    t0 = time.perf_counter()
    state, history, (x_test, y_test) = ot.train(
        feats, y, weighted=True, augmented=True, seed=0, verbose=True)
    t_train = time.perf_counter() - t0
    ev = ot.evaluation(state, x_test, y_test)
    return {
        "n_windows": int(len(buf)),
        "n_mixtures": int(n_mixtures),
        "n_singles": int(len(buf) - n_mixtures),
        "epochs_run": len(history["loss"]),
        "synth_wall_s": round(t_synth, 1),
        "featurize_wall_s": round(t_feat, 1),
        "train_wall_s": round(t_train, 1),
        "final_train_acc": round(float(history["acc"][-1]), 4),
        "best_val_acc": round(float(max(history["val_acc"])), 4),
        "final_val_acc": round(float(history["val_acc"][-1]), 4),
        "heldout_accuracy": round(float(ev["accuracy"]), 4),
        "confusion": np.asarray(ev["confusion"]).tolist(),
        # a never-predicted class yields NaN precision; null keeps the
        # output strict JSON
        "recall": [None if not np.isfinite(v) else round(float(v), 4)
                   for v in np.asarray(ev["recall"])],
        "precision": [None if not np.isfinite(v) else round(float(v), 4)
                      for v in np.asarray(ev["precision"])],
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mixtures", type=int, default=6300)
    ap.add_argument("--singles-frac", type=float, default=1.0,
                    help="singles per mixture for the balanced phase")
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--patience", type=int, default=10)
    ap.add_argument("--skip-balanced", action="store_true")
    ap.add_argument("--skip-augmented", action="store_true",
                    help="skip the imbalanced (ladder-firing) phase")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--small-model", action="store_true",
                    help="tiny trunk for CPU plumbing smoke tests")
    ap.add_argument("--out", default=None,
                    help="also write the JSON result here")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    out = {"metric": "overlap_convergence", "device": str(jax.devices()[0])}
    if not args.skip_balanced:
        out["balanced"] = run_phase("balanced", args.mixtures,
                                    args.singles_frac, args.epochs,
                                    args.patience,
                                    small_model=args.small_model)
    if not args.skip_augmented:
        # 1/3 singles -> duplication ratio round(3-1)=2: the pyramid ladder
        # fires with 1- and 2-round blurs across ~2,100 images on device
        out["augmented_imbalanced"] = run_phase(
            "imbalanced", args.mixtures, 1.0 / 3.0, args.epochs,
            args.patience, small_model=args.small_model)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
