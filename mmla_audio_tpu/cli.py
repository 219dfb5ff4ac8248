"""Command-line entry points (the reference's scripts, unified).

    python -m mmla_audio_tpu.cli setup --root experiment
    python -m mmla_audio_tpu.cli overlap-live   [--fake] [--windows N]
    python -m mmla_audio_tpu.cli speaker-live   [--fake] [--register NAME ...]
    python -m mmla_audio_tpu.cli overlap-post   --root experiment
    python -m mmla_audio_tpu.cli speaker-post   --root experiment
    python -m mmla_audio_tpu.cli overlap-run    -f clip.wav [--ckpt DIR]
    python -m mmla_audio_tpu.cli synth-corpus   --wav-dir D --out-dir O
    python -m mmla_audio_tpu.cli charts         --root experiment

Maps to: `record_on_pc.py main()` (both subsystems), the post-processing
scripts, `overlap_detector_run.py` (offline file runner with timings),
`data_augmentation.py`, `setup.py`, and the distribution visualizers.
``--fake`` substitutes the deterministic PCM source so every flow runs
headless (the reference required a live microphone).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np


def _setup_compile_cache(args):
    """Turn the persistent XLA compilation cache on before any program
    compiles, so a restarted runner skips compilation: ``--compile-cache
    DIR|off``, else ``$JAX_COMPILATION_CACHE_DIR``, else
    ``<checkout>/.jax_cache`` (see ``utils.compile_cache``)."""
    from mmla_audio_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache(getattr(args, "compile_cache", None))


def _matmul_precision(args):
    """--precision highest -> full-FP32 dots/convs in the model trunk
    (labels that match a CPU run); 'default' -> each predictor's per-model
    default (overlap: the backend's default, TF32 on an H100; speaker:
    highest — see inference.py); 'fast' -> the backend's default
    everywhere (the labels-only throughput knob)."""
    prec = getattr(args, "precision", "default")
    return {"default": "auto", "fast": None}.get(prec, prec)


def _predictor_overlap(ckpt, cfg, matmul_precision="auto"):
    import jax

    from mmla_audio_tpu.inference import OverlapPredictor
    from mmla_audio_tpu.models.overlap import OverlapResBLSTM
    from mmla_audio_tpu.train.checkpoints import load_variables

    model = OverlapResBLSTM(cfg.overlap_model)
    template = model.init_variables(jax.random.PRNGKey(0))
    variables = load_variables(ckpt, template) if ckpt else template
    if not ckpt:
        print("[WARN] no --ckpt given: using random-init weights")
    return OverlapPredictor(variables, cfg.overlap_model, cfg.overlap_feature,
                            matmul_precision=matmul_precision)


def _predictor_speaker(ckpt, cfg, head_units=None, sigmoid=False,
                       matmul_precision="auto"):
    import jax

    from mmla_audio_tpu.inference import SpeakerPredictor
    from mmla_audio_tpu.models.speaker import SpeakerResBLSTM

    from mmla_audio_tpu.train.checkpoints import load_variables

    model = SpeakerResBLSTM(cfg.speaker_model, head_units=head_units)
    template = model.init_variables(jax.random.PRNGKey(0))
    variables = load_variables(ckpt, template) if ckpt else template
    if not ckpt:
        print("[WARN] no --ckpt given: using random-init weights")
    return SpeakerPredictor(variables, cfg.speaker_model, cfg.speaker_feature,
                            head_units=head_units, sigmoid_head=sigmoid,
                            matmul_precision=matmul_precision)


def _capture(args, cfg):
    from mmla_audio_tpu.streaming.capture import (
        CaptureThread,
        FakePCMSource,
        PyAudioSource,
    )

    if args.fake:
        src = FakePCMSource(cfg.audio, seed=args.seed,
                            realtime=args.realtime)
    else:
        src = PyAudioSource(cfg.audio)
    return CaptureThread(src, cfg.audio).start()


def cmd_setup(args):
    from mmla_audio_tpu.utils.experiment import bootstrap

    dirs = bootstrap(args.root)
    print(f"[INFO] experiment tree ready under {dirs.root}")


def _live_cfg(args):
    """PipelineConfig honoring --vad (live, post-time, and offline runs)."""
    import dataclasses

    from mmla_audio_tpu.core.config import PipelineConfig, VadConfig

    cfg = PipelineConfig()
    decision = getattr(args, "vad", None)
    if decision:
        cfg = dataclasses.replace(cfg, vad=VadConfig(decision=decision))
    return cfg


def _host_preprocess(args):
    """tri-state --host-preprocess: flag True, --no-host-preprocess False,
    absent -> the session's "auto" routing (native host engine exactly when
    the decision is webrtc and the engine is available)."""
    v = getattr(args, "host_preprocess", None)
    return "auto" if v is None else v


def _print_arrangement(sess):
    where = ("host: denoise + native webrtc VAD + trim; features + model on "
             "the device" if sess._hostpre is not None else
             "device: denoise + webrtc VAD + trim + features + model")
    print(f"[INFO] window program on the {where}")


def cmd_overlap_live(args):
    from mmla_audio_tpu.streaming.edge import EdgeOverlapSession
    from mmla_audio_tpu.streaming.session import OverlapSession

    if args.edge and getattr(args, "host_preprocess", False):
        raise SystemExit(
            "--host-preprocess is not supported with --edge (the edge "
            "pipeline is fully on-device; see streaming/edge.py)")
    cfg = _live_cfg(args)
    pred = _predictor_overlap(
        args.ckpt, cfg, matmul_precision=_matmul_precision(args))
    cap = _capture(args, cfg)
    if args.edge:
        # Pi-variant: x4 denoise + SSIM silence gate (record_on_pi.py)
        sess = EdgeOverlapSession(pred, cap, args.root, cfg=cfg,
                                  save_recordings=args.save_recordings)
    else:
        sess = OverlapSession(pred, cap, args.root, cfg=cfg,
                              save_recordings=args.save_recordings,
                              host_preprocess=_host_preprocess(args))
        _print_arrangement(sess)
    cal_s = args.calibrate_seconds or cfg.audio.noise_profile_seconds
    print(f"[INFO] calibrating ambient noise ({cal_s:.0f}s)...")
    sess.calibrate(args.calibrate_seconds)
    print("[INFO] model loaded: start predicting...")

    def show(idx, label, prob):
        print(f"[INFO] window {idx}: {label}  (probs {np.round(prob, 3)})")

    sess.run(max_windows=args.windows, on_result=show)
    cap.stop()
    print(f"[INFO] log: {sess.log.path}")


def cmd_speaker_live(args):
    from mmla_audio_tpu.streaming.edge import EdgeSpeakerSession
    from mmla_audio_tpu.streaming.session import SpeakerSession

    if getattr(args, "edge", False) and getattr(args, "host_preprocess",
                                                False):
        raise SystemExit(
            "--host-preprocess is not supported with --edge (the edge "
            "pipeline is fully on-device; see streaming/edge.py)")
    cfg = _live_cfg(args)
    pred = _predictor_speaker(
        args.ckpt, cfg, matmul_precision=_matmul_precision(args))
    cap = _capture(args, cfg)
    if getattr(args, "edge", False):
        # Pi-variant: gate-driven capture, AOT identify loop, timestamp-free
        # log (SI record_on_pi.py)
        sess = EdgeSpeakerSession(pred, cap, args.root, cfg=cfg,
                                  save_recordings=args.save_recordings)
    else:
        sess = SpeakerSession(pred, cap, args.root, cfg=cfg,
                              save_recordings=args.save_recordings,
                              host_preprocess=_host_preprocess(args))
        _print_arrangement(sess)
    print("[INFO] calibrating ambient noise...")
    sess.calibrate(args.calibrate_seconds)

    if args.register:
        import jax

        from mmla_audio_tpu.models.speaker import SpeakerResBLSTM
        from mmla_audio_tpu.train.checkpoints import load_variables

        for name in args.register:
            print(f"[INFO] registering '{name}' "
                  f"({args.enroll_seconds or cfg.audio.enroll_seconds:.0f}s)...")
            sess.register_speaker(name, seconds=args.enroll_seconds)
        model = SpeakerResBLSTM(cfg.speaker_model)
        template = model.init_variables(jax.random.PRNGKey(0))
        base = load_variables(args.ckpt, template) if args.ckpt else template
        print("[INFO] transfer-learning on registered corpus (on device)...")
        override = None
        if args.phase1_epochs is not None or args.phase2_epochs is not None:
            override = (args.phase1_epochs or cfg.transfer.phase1_epochs,
                        args.phase2_epochs if args.phase2_epochs is not None
                        else cfg.transfer.phase2_epochs)
        acc = sess.train_on_registered(base, epochs_override=override)
        gate = cfg.transfer.accuracy_gate
        print(f"[INFO] registration accuracy: {acc:.3f} (gate {gate:.2f}: "
              f"{'passed' if acc >= gate else 'not met, best round kept'})")

    def show(idx, label, prob):
        print(f"[INFO] window {idx}: {label}")

    sess.run(max_windows=args.windows, on_result=show)
    cap.stop()
    print(f"[INFO] log: {sess.log.path}")


def cmd_overlap_post(args):
    from mmla_audio_tpu.analyze.post_time import overlap_post_analyze
    from mmla_audio_tpu.data.wavio import read_wav
    from mmla_audio_tpu.utils.experiment import bootstrap

    cfg = _live_cfg(args)
    dirs = bootstrap(args.root)
    noise = read_wav(dirs.noise_path)[0] if dirs.noise_path.exists() else None
    pred = _predictor_overlap(
        args.ckpt, cfg, matmul_precision=_matmul_precision(args))
    logs = overlap_post_analyze(dirs, pred, cfg=cfg, noise=noise)
    for name, log in logs.items():
        print(f"[INFO] {name}: {log}")


def cmd_speaker_post(args):
    from mmla_audio_tpu.analyze.post_time import speaker_post_analyze
    from mmla_audio_tpu.data.wavio import read_wav
    from mmla_audio_tpu.utils.experiment import bootstrap

    cfg = _live_cfg(args)
    dirs = bootstrap(args.root)
    noise = read_wav(dirs.noise_path)[0] if dirs.noise_path.exists() else None
    n_speakers = len(list(dirs.corpus.glob("*.wav"))) or None
    pred = _predictor_speaker(args.ckpt, cfg, head_units=n_speakers,
                              sigmoid=n_speakers is not None,
                              matmul_precision=_matmul_precision(args))
    logs = speaker_post_analyze(dirs, pred, cfg=cfg, noise=noise)
    for name, log in logs.items():
        print(f"[INFO] {name}: {log}")


def cmd_overlap_run(args):
    """overlap_detector_run.py: offline file(s) with timings + AOT parity."""
    import jax
    import jax.numpy as jnp

    from mmla_audio_tpu.core.config import PipelineConfig
    from mmla_audio_tpu.data.wavio import read_wav
    from mmla_audio_tpu.export import aot_compile, parity_check
    from mmla_audio_tpu.utils.timers import StageTimer

    if not args.file and not args.dir:
        raise SystemExit("overlap-run: pass -f FILE or --dir DIR")
    cfg = PipelineConfig()
    paths = [Path(args.file)] if args.file else \
        sorted(Path(args.dir).glob("*.wav"))
    if not paths:
        raise SystemExit(f"overlap-run: no .wav files under {args.dir}")
    timer = StageTimer()
    with timer.stage("model_load"):
        pred = _predictor_overlap(
            args.ckpt, cfg, matmul_precision=_matmul_precision(args))

    bufs, counts = [], []
    with timer.stage("wav_load"):
        for p in paths:
            sig, _ = read_wav(p)
            buf = np.zeros(cfg.audio.window_samples, np.int16)
            k = min(len(sig), len(buf))
            buf[:k] = sig[:k]
            bufs.append(buf)
            counts.append(k)
    bufs = np.stack(bufs)                 # int16 ships at half the bytes
    counts = np.asarray(counts, np.int32)

    with timer.stage("predict_compile_and_run"):
        labels, probs = pred.predict(bufs, counts)
        labels = np.asarray(labels)
    with timer.stage("predict_steady"):
        labels2, _ = pred.predict(bufs, counts)
        np.asarray(labels2)

    if args.parity:
        fwd = pred.lower_fn()
        compiled = aot_compile(fwd, pred.variables, jnp.asarray(bufs),
                               jnp.asarray(counts))
        parity_check(lambda v, b, n: fwd(v, b, n)[1],
                     lambda v, b, n: compiled(v, b, n)[1],
                     (pred.variables, jnp.asarray(bufs), jnp.asarray(counts)))
        print("[INFO] AOT parity check passed")

    from mmla_audio_tpu.analyze.logs import OVERLAP_LABELS
    for p, lab in zip(paths, labels):
        name = "silent" if lab < 0 else OVERLAP_LABELS[str(int(lab))]
        print(f"[RESULT] {p.name}: {name}")
    for stage, s in timer.summary().items():
        print(f"[TIME] {stage}: {s['mean_ms']:.1f} ms")


def cmd_synth_corpus(args):
    from mmla_audio_tpu.data.synth import synthesize_corpus
    from mmla_audio_tpu.data.timit import TimitCatalog

    catalog = TimitCatalog.from_flat_dir(args.wav_dir) if not args.labels_csv \
        else TimitCatalog.from_labels_csv(args.labels_csv, args.wav_dir)
    plan = synthesize_corpus(
        catalog.clip_loader, n_mixtures=args.n_mixtures,
        n_speakers=catalog.n_speakers, out_dir=args.out_dir, seed=args.seed)
    import csv as _csv
    with open(Path(args.out_dir) / "augmented_labels.csv", "w", newline="") as f:
        w = _csv.writer(f)
        w.writerow(["index", "speaker_ids", "overlap_degree"])
        for e in plan:
            w.writerow([e.index, "_".join(e.speaker_ids), e.label])
    print(f"[INFO] wrote {len(plan)} mixtures to {args.out_dir}")


def cmd_overlap_train(args):
    """Train the overlap detector from WAV directories (singles + mixtures):
    featurize on device, stratified split, weighted CCE + Adadelta + cosine."""
    import jax.numpy as jnp

    from mmla_audio_tpu.core.config import OverlapTrainConfig
    from mmla_audio_tpu.data.wavio import read_wav
    from mmla_audio_tpu.ops.features import overlap_model_input
    from mmla_audio_tpu.train.overlap_trainer import OverlapTrainer

    xs, ys = [], []
    for label, d in ((0, args.single_dir), (1, args.overlap_dir)):
        for p in sorted(Path(d).glob("*.wav")):
            sig, _ = read_wav(p)
            xs.append(sig[:24000].astype(np.float32) / 32768.0)
            ys.append(label)
    buf = np.zeros((len(xs), 24000), np.float32)
    for i, x in enumerate(xs):
        buf[i, :len(x)] = x[:24000]
    feats = np.asarray(overlap_model_input(jnp.asarray(buf)))
    y = np.zeros((len(ys), 2), np.float32)
    y[np.arange(len(ys)), ys] = 1.0

    trainer = OverlapTrainer(train_cfg=OverlapTrainConfig(
        epochs=args.epochs, batch_size=args.batch_size))
    state, history, (x_test, y_test) = trainer.train(
        feats, y, weighted=True, augmented=args.augmented,
        checkpoint_dir=args.out, verbose=True)
    ev = trainer.evaluation(state, x_test, y_test)
    print(f"[RESULT] test accuracy: {ev['accuracy']:.4f}")
    print(f"[RESULT] confusion:\n{ev['confusion']}")
    if args.out:
        print(f"[INFO] best checkpoint at {args.out}")


def cmd_speaker_pretrain(args):
    """Base speaker model pretrain (TIMIT): RMSprop 1e-4, batch 32."""
    import jax

    from mmla_audio_tpu.core.config import PipelineConfig
    from mmla_audio_tpu.data.corpus import featurize_clips
    from mmla_audio_tpu.data.timit import TimitCatalog
    from mmla_audio_tpu.models.speaker import SpeakerResBLSTM, l2_penalty
    from mmla_audio_tpu.train import (
        Trainer,
        keras_categorical_crossentropy,
        rmsprop,
    )
    from mmla_audio_tpu.train.checkpoints import save_variables

    cfg = PipelineConfig()
    catalog = TimitCatalog.from_flat_dir(args.wav_dir) if not args.labels_csv \
        else TimitCatalog.from_labels_csv(args.labels_csv, args.wav_dir)
    clips, labels = [], []
    for sid, sig, sr in catalog.iter_clips():
        clips.append(sig)
        labels.append(sid)
    x, y, sid_dict = featurize_clips(clips, labels,
                                     dim=cfg.speaker_model.num_speakers)
    model = SpeakerResBLSTM(cfg.speaker_model)
    variables = model.init_variables(jax.random.PRNGKey(args.seed))
    trainer = Trainer(model, rmsprop(cfg.speaker_train.lr),
                      keras_categorical_crossentropy,
                      extra_penalty_fn=lambda p: l2_penalty(p, cfg.speaker_model))
    state = trainer.init_state(variables)
    state, history = trainer.fit(
        state, x, y, epochs=args.epochs or cfg.speaker_train.epochs,
        batch_size=cfg.speaker_train.batch_size,
        early_stop_patience=cfg.speaker_train.early_stop_patience,
        x_val=x, y_val=y, verbose=True)
    save_variables(args.out, trainer.variables_of(state),
                   {"speakers": sid_dict})
    print(f"[INFO] saved base model to {args.out}")


def cmd_charts(args):
    from mmla_audio_tpu.analyze.charts import visualize_all
    from mmla_audio_tpu.utils.experiment import ExperimentDirs

    dirs = ExperimentDirs(args.root)
    outs = visualize_all(dirs.logs, dirs.charts, kind=args.kind)
    for o in outs:
        print(f"[INFO] {o}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mmla_audio_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def cache_flag(p):
        p.add_argument("--compile-cache", default=None, metavar="DIR|off",
                       help="persistent XLA compilation cache directory, "
                            "or 'off'.  Default: $JAX_COMPILATION_CACHE_DIR "
                            "if set, else <checkout>/.jax_cache")

    def common(p, live=False, vad=True):
        p.add_argument("--root", default="experiment")
        p.add_argument("--ckpt", default=None)
        cache_flag(p)
        p.add_argument("--precision", choices=["default", "highest", "fast"],
                       default="default",
                       help="precision of the model trunk's float32 dots "
                            "and convs.  'default': per model (overlap: the "
                            "backend's default, which may be TF32 on a GPU; "
                            "speaker: highest).  'highest' forces true FP32 "
                            "everywhere; 'fast' leaves every model at the "
                            "backend's default (TF32 on an H100).  See "
                            "benchmarks/gpu_cpu_parity.py")
        if vad:
            # not on overlap-run: the reference's offline file runner has no
            # VAD (overlap_detector_run.py; silent gate is raw length only)
            p.add_argument("--vad", choices=["energy", "webrtc"],
                           default=None,
                           help="per-frame VAD decision.  Default: webrtc — "
                                "the bit-exact reference-faithful engine "
                                "(B=1 sessions auto-route it to the native "
                                "host engine when available).  'energy' is "
                                "the fast opt-out (agrees only 0.500 on "
                                "0-10 dB-SNR window labels, PARITY.md)")
        if live:
            p.add_argument("--fake", action="store_true",
                           help="deterministic PCM source instead of microphone")
            p.add_argument("--seed", type=int, default=0)
            p.add_argument("--realtime", action="store_true")
            p.add_argument("--windows", type=int, default=None)
            p.add_argument("--calibrate-seconds", type=float, default=None)
            p.add_argument("--save-recordings", action="store_true")
            p.add_argument("--host-preprocess", dest="host_preprocess",
                           action="store_true", default=None,
                           help="force the host split: denoise + webrtc VAD "
                                "on the host (native C++ engine), only the "
                                "trimmed window to the device.  Default "
                                "auto: taken exactly when the decision is "
                                "webrtc and the native engine is available "
                                "(the single-stream low-latency "
                                "arrangement); --no-host-preprocess forces "
                                "the fully on-device program")
            p.add_argument("--no-host-preprocess", dest="host_preprocess",
                           action="store_false", help=argparse.SUPPRESS)

    p = sub.add_parser("setup")
    p.add_argument("--root", default="experiment")
    p.set_defaults(fn=cmd_setup)

    p = sub.add_parser("overlap-live")
    common(p, live=True)
    p.add_argument("--edge", action="store_true",
                   help="Pi-variant pipeline: x4 denoise + SSIM silence gate")
    p.set_defaults(fn=cmd_overlap_live)

    p = sub.add_parser("speaker-live")
    common(p, live=True)
    p.add_argument("--register", nargs="*", default=None)
    p.add_argument("--enroll-seconds", type=float, default=None)
    p.add_argument("--phase1-epochs", type=int, default=None)
    p.add_argument("--phase2-epochs", type=int, default=None)
    p.add_argument("--edge", action="store_true",
                   help="Pi-variant: gated capture, AOT identify loop, "
                        "timestamp-free log")
    p.set_defaults(fn=cmd_speaker_live)

    p = sub.add_parser("overlap-post")
    common(p)
    p.set_defaults(fn=cmd_overlap_post)

    p = sub.add_parser("speaker-post")
    common(p)
    p.set_defaults(fn=cmd_speaker_post)

    p = sub.add_parser("overlap-run")
    common(p, vad=False)
    p.add_argument("-f", "--file", default=None)
    p.add_argument("-dir", "--dir", default=None)
    p.add_argument("--parity", action="store_true")
    p.set_defaults(fn=cmd_overlap_run)

    p = sub.add_parser("synth-corpus")
    p.add_argument("--wav-dir", required=True)
    p.add_argument("--labels-csv", default=None)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--n-mixtures", type=int, default=6300)
    p.add_argument("--seed", type=int, default=0)
    cache_flag(p)
    p.set_defaults(fn=cmd_synth_corpus)

    p = sub.add_parser("overlap-train")
    p.add_argument("--single-dir", required=True)
    p.add_argument("--overlap-dir", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--augmented", action="store_true")
    cache_flag(p)
    p.set_defaults(fn=cmd_overlap_train)

    p = sub.add_parser("speaker-pretrain")
    p.add_argument("--wav-dir", required=True)
    p.add_argument("--labels-csv", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    cache_flag(p)
    p.set_defaults(fn=cmd_speaker_pretrain)

    p = sub.add_parser("charts")
    p.add_argument("--root", default="experiment")
    p.add_argument("--kind", default="overlap", choices=["overlap", "speaker"])
    cache_flag(p)
    p.set_defaults(fn=cmd_charts)

    args = ap.parse_args(argv)
    _setup_compile_cache(args)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
