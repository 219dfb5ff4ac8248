"""Speaker pipeline end-to-end convergence proof.

The speaker analog of ``convergence_demo.py``: the full reference flow —
base-model pretrain on a many-speaker corpus, then the registration
(transfer-learning) path through the acc>=0.80 gate, then identify accuracy
on held-out windows — at full model size on the device, wall-clock included.

Corpus: >=64 distinct synthetic "speakers", each a persistent vocal
identity (fundamental, per-speaker harmonic envelope, AM cadence) with
per-utterance variation (phase, f0 wobble, noise), MFCC-39 featurized
exactly like the serving path.  Enrollment uses 4 NEW speakers never seen
in pretraining — the reference's actual deployment story
(`speaker_identification.py:401-503`: TIMIT-pretrained trunk, fresh
sigmoid head on the enrolled corpus, phase-1 frozen / phase-2 unfrozen).

Run live:  python benchmarks/speaker_convergence.py
           [--speakers N] [--windows W] [--epochs E]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

SR = 16000
N_WIN = 40960          # 2.56 s identify window


def speaker_voice(speaker_seed: int):
    """Persistent per-speaker vocal identity."""
    rng = np.random.RandomState(100_000 + speaker_seed)
    return {
        "f0": 80.0 + 180.0 * rng.rand(),
        "harm": rng.rand(12) / np.arange(1, 13),     # spectral envelope
        "am": 1.5 + 4.0 * rng.rand(),                # syllable cadence
        "tilt": 0.5 + rng.rand(),
    }


def synth_utterance(voice, n: int, utter_seed: int) -> np.ndarray:
    """One utterance of this speaker: fixed identity, varying realization."""
    rng = np.random.RandomState(utter_seed)
    t = np.arange(n) / SR
    f0 = voice["f0"] * (1.0 + 0.04 * np.sin(2 * np.pi * rng.uniform(0.5, 2) * t)
                        + 0.02 * rng.randn())
    phase = np.cumsum(2 * np.pi * f0 / SR)
    sig = sum(a * np.sin((k + 1) * phase + rng.rand() * 2 * np.pi)
              for k, a in enumerate(voice["harm"]))
    env = (1.0 + np.sin(2 * np.pi * voice["am"] * t
                        + rng.rand() * 2 * np.pi)) ** voice["tilt"]
    sig = sig * env * 3000 + rng.randn(n) * 120
    return np.clip(sig, -32767, 32767).astype(np.float32)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--speakers", type=int, default=64,
                    help="pretraining speakers")
    ap.add_argument("--windows", type=int, default=12,
                    help="pretrain windows per speaker")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--enroll", type=int, default=4,
                    help="new speakers enrolled at registration")
    ap.add_argument("--enroll-windows", type=int, default=23,
                    help="enrollment windows/speaker (~60 s clip sliced "
                         "into 256-frame segments, the reference geometry)")
    ap.add_argument("--test-windows", type=int, default=12)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from mmla_audio_tpu.core.config import (SpeakerFeatureConfig,
                                            SpeakerModelConfig,
                                            SpeakerTrainConfig,
                                            TransferConfig)
    from mmla_audio_tpu.models.speaker import SpeakerResBLSTM, l2_penalty
    from mmla_audio_tpu.ops.features import speaker_feature
    from mmla_audio_tpu.train import (Trainer,
                                      keras_categorical_crossentropy,
                                      rmsprop)
    from mmla_audio_tpu.train.transfer import TransferLearner

    fcfg = SpeakerFeatureConfig()

    featurize = jax.jit(jax.vmap(lambda w: speaker_feature(
        w, jnp.asarray(N_WIN), fcfg)[0]))

    def features_for_all(speaker_seeds, n_windows, base_seed, chunk=1024):
        # chunked batched device calls ACROSS speakers (a per-speaker loop
        # at 630 speakers pays a device round-trip 630 times; a per-window
        # loop, 7560 times).  The final partial chunk is padded to the chunk shape so
        # the featurizer compiles exactly once.
        # utter seeds: base_seed selects a DISJOINT namespace (1_000_003 is
        # prime and not ~= any reachable 7919*ds + dw), so pretrain (1),
        # enrollment (2) and held-out test (3) utterances can never be
        # bit-identical — with a plain additive base, test window w equaled
        # enrollment window w+1 exactly and "held-out" accuracy was
        # training accuracy.
        # int16 upload: the wavs are int16-scale PCM (the serving path's
        # actual dtype); shipping them as int16 halves the H2D bytes, which
        # matters at reference scale (630 x 12 windows = 1.2 GB as f32).
        # Cast back to f32 on device.
        wavs = np.stack([
            synth_utterance(speaker_voice(s), N_WIN,
                            1_000_003 * base_seed + 7919 * s + w)
            for s in speaker_seeds for w in range(n_windows)])
        # round like the serving path's PCM16 quantization (quantize_i16
        # rounds; a bare astype truncates toward zero — ±1 LSB mismatch)
        wavs = np.clip(np.rint(wavs), -32768, 32767).astype(np.int16)
        outs = []
        for i in range(0, len(wavs), chunk):
            part = wavs[i: i + chunk]
            short = chunk - len(part)
            if short:
                part = np.concatenate([part, part[-1:].repeat(short, 0)])
            feats = featurize(jnp.asarray(part).astype(jnp.float32))
            outs.append(feats[: chunk - short])
        # stays DEVICE-resident: Trainer.fit pads/masks jax.Arrays on device;
        # a host round-trip of the 630-speaker feature tensor (~300 MB) would
        # buy nothing.
        return jnp.concatenate(outs) if len(outs) > 1 else outs[0]

    # ---- base pretrain corpus --------------------------------------------
    ns, npw = args.speakers, args.windows
    print(f"[spk] featurizing {ns} speakers x {npw} windows ...",
          file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    x = features_for_all(range(ns), npw, base_seed=1)
    # one-hot built on device from a (ns*npw,) int vector: the host-built
    # 630-speaker one-hot is 19 MB of H2D for 30 kB of information
    y = jax.nn.one_hot(jnp.repeat(jnp.arange(ns), npw), ns,
                       dtype=jnp.float32)
    # stratified holdout: last 2 windows/speaker for validation
    val_mask = np.zeros(len(x), bool)
    for s in range(ns):
        val_mask[s * npw + npw - 2: (s + 1) * npw] = True
    t_feat = time.perf_counter() - t0
    print(f"[spk] corpus {x.shape} in {t_feat:.1f} s",
          file=sys.stderr, flush=True)

    # ---- base pretrain (the reference recipe: RMSprop 1e-4, b32, CCE +
    # l2 penalty, early stop) ----------------------------------------------
    mcfg = SpeakerModelConfig(num_speakers=ns)
    tcfg = SpeakerTrainConfig()
    model = SpeakerResBLSTM(mcfg)
    variables = model.init_variables(jax.random.PRNGKey(0))
    trainer = Trainer(model, rmsprop(tcfg.lr),
                      keras_categorical_crossentropy,
                      extra_penalty_fn=lambda p: l2_penalty(p, mcfg))
    state = trainer.init_state(variables)
    t0 = time.perf_counter()
    state, history = trainer.fit(
        state, x[~val_mask], y[~val_mask], epochs=args.epochs,
        batch_size=tcfg.batch_size,
        early_stop_patience=tcfg.early_stop_patience,
        x_val=x[val_mask], y_val=y[val_mask], verbose=True)
    t_pretrain = time.perf_counter() - t0
    base_val_acc = float(max(history["val_acc"]))
    print(f"[spk] pretrain {len(history['loss'])} epochs in "
          f"{t_pretrain:.0f} s, val acc {base_val_acc:.3f}",
          file=sys.stderr, flush=True)

    # ---- registration: 4 NEW speakers through the acc>=0.80 gate ---------
    enroll_ids = [10_000 + e for e in range(args.enroll)]
    xe = features_for_all(enroll_ids, args.enroll_windows, base_seed=2)
    ye = np.zeros((len(xe), args.enroll), np.float32)
    for e in range(args.enroll):
        ye[e * args.enroll_windows:(e + 1) * args.enroll_windows, e] = 1.0

    learner = TransferLearner(trainer.variables_of(state),
                              n_speakers=args.enroll, model_cfg=mcfg,
                              cfg=TransferConfig())
    t0 = time.perf_counter()
    head_vars, gate_acc, _ = learner.fit_until_gate(xe, ye, seed=0)
    t_register = time.perf_counter() - t0
    print(f"[spk] registration gate acc {float(gate_acc):.3f} in "
          f"{t_register:.1f} s", file=sys.stderr, flush=True)

    # ---- identify accuracy on held-out windows of the enrolled 4 ---------
    from mmla_audio_tpu.inference import SpeakerPredictor

    xt = features_for_all(enroll_ids, args.test_windows, base_seed=3)
    yt = np.repeat(np.arange(args.enroll), args.test_windows)
    predictor = SpeakerPredictor(head_vars, mcfg, fcfg,
                                 head_units=args.enroll, sigmoid_head=True)
    logits = predictor.apply_model(head_vars, jnp.asarray(xt))
    pred = np.asarray(jnp.argmax(logits, axis=-1))
    identify_acc = float((pred == yt).mean())
    print(f"[spk] identify acc on held-out windows: {identify_acc:.3f}",
          file=sys.stderr, flush=True)

    print(json.dumps({
        "metric": "speaker_convergence",
        "device": str(jax.devices()[0]),
        "pretrain_speakers": ns,
        "pretrain_windows": int(len(x)),
        "pretrain_epochs_run": len(history["loss"]),
        "pretrain_val_acc": round(base_val_acc, 4),
        "pretrain_wall_s": round(t_pretrain, 1),
        "featurize_wall_s": round(t_feat, 1),
        "enroll_speakers": args.enroll,
        "registration_gate_acc": round(float(gate_acc), 4),
        "registration_wall_s": round(t_register, 1),
        "identify_acc_heldout": round(identify_acc, 4),
        "identify_windows": int(len(xt)),
    }))


if __name__ == "__main__":
    main()
