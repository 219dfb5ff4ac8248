"""Bring-up check of the whole system on one NVIDIA GPU, in one process.

    python chip_smoke.py               # one card: phases 0-4
    python chip_smoke.py --four-cards  # four cards: phase 0 + the mesh path

Phases (each prints its compile and run seconds; the first failure stops
the script with a non-zero exit code):

0. device: refuse anything but a GPU; print the card's name and power
   limit, the JAX version and ``XLA_FLAGS``.
1. full-width serve programs at b512: ``OverlapPredictor`` and
   ``SpeakerPredictor`` (each plain XLA featurizer also timed alone), both full serve
   chains (denoise -> webrtc VAD -> trim -> features -> model), and the
   webrtc engine with the unroll ladder and without it.
2. live path: the ``Multiplexer`` for both kinds (64 streams, 4 windows
   each), then ``cli.main`` for ``overlap-live`` (VAD on the card and the
   default routing) and ``speaker-live --register`` (the on-device
   registration fine-tune at full width).
3. training: ``Trainer`` steps of the full-width overlap model at b32.
4. the same jnp code on the host CPU backend, compared within the stated
   tolerances; webrtc decisions against the native C++ engine.
5. (``--four-cards``) ``DataParallel`` serving, the mesh-sharded webrtc
   ``Multiplexer`` with stream churn, and a speaker ``Trainer.fit(mesh=)``,
   each compared with the same run on one card.

The last stdout line is ``{"ok": true, "device": {...}}``.  Weights are
random, from fixed seeds; inputs are the deterministic speech-like source.
"""

import argparse
import contextlib
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np

BATCH = 512           # serve-program batch (phases 1 and 5)
COMPARE_BATCH = 32    # windows compared with the CPU backend (phase 4)
TRAIN_BATCH = 32
N_STREAMS = 64
WINDOWS = 4
N_SAMPLES = 40960     # one 2.56 s window at 16 kHz

# Phase 4 tolerances, card vs host CPU backend (both float32; stated in
# CHANGES.md and PARITY.md beside the measured values).
DENOISE_MAX_LSB = 1           # int16 denoised waveform, Precision.HIGHEST
DENOISE_MAX_SHARE = 0.002     # share of samples that may differ
IMAGE_MIN_SAME = 0.999        # uint8 overlap image: share of equal pixels
IMAGE_MAX_DIFF = 1
MFCC_REL_TOL = 1e-3           # max |gpu - cpu| / max |cpu| over MFCC39
PROB_TOL_HIGHEST = 1e-4       # predictor probabilities, "highest"
PROB_TOL_MESH = 1e-5          # four cards vs one, "highest"
LOSS_REL_TOL_MESH = 1e-4


def say(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


@contextlib.contextmanager
def phase(name):
    say(f"== {name}")
    t0 = time.perf_counter()
    yield
    say(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)")


def timed(name, fn, *args, reps=5):
    """Compile ``fn`` for ``args``, run it once (returned) and time ``reps``
    more runs to completion; prints compile seconds and the median run."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - t0)
    run_s = float(np.median(times))
    say(f"[{name}] compile {compile_s:.2f} s, run {run_s * 1e3:.3f} ms "
        f"(median of {reps})")
    return out, compiled, run_s


def windows(batch, seed=0):
    """(batch, N_SAMPLES) int16 speech-like windows, one source per row."""
    from mmla_audio_tpu.streaming.capture import FakePCMSource

    return np.stack([FakePCMSource(seed=seed + i).read(N_SAMPLES)
                     for i in range(batch)])


# -- phase 1 ---------------------------------------------------------------------

def phase_serve(ctx):
    import jax
    import jax.numpy as jnp

    import bench
    from mmla_audio_tpu.core.config import OverlapFeatureConfig, SpeakerFeatureConfig
    from mmla_audio_tpu.inference import OverlapPredictor, SpeakerPredictor
    from mmla_audio_tpu.models.overlap import OverlapResBLSTM
    from mmla_audio_tpu.models.speaker import SpeakerResBLSTM
    from mmla_audio_tpu.ops.features import overlap_model_input, speaker_feature_batch
    from mmla_audio_tpu.vad import webrtc

    x16 = windows(BATCH)
    buf = jnp.asarray(x16)
    n = jnp.full((BATCH,), N_SAMPLES, jnp.int32)
    ov_vars = OverlapResBLSTM().init_variables(jax.random.PRNGKey(0))
    sp_vars = SpeakerResBLSTM().init_variables(jax.random.PRNGKey(1))
    ctx.update(x16=x16, ov_vars=ov_vars, sp_vars=sp_vars)

    for name, pred, variables, classes in (
            ("overlap predictor b512", OverlapPredictor(ov_vars), ov_vars, 2),
            ("speaker predictor b512", SpeakerPredictor(sp_vars), sp_vars,
             630)):
        (labels, probs), compiled, _ = timed(name, pred.lower_fn(),
                                             variables, buf, n)
        say(f"[{name}] memory_analysis: {compiled.memory_analysis()}")
        check(labels.shape == (BATCH,) and probs.shape == (BATCH, classes),
              f"{name}: shapes {labels.shape} {probs.shape}")
        check(bool(jnp.isfinite(probs).all()), f"{name}: non-finite probs")
        check(bool(((labels >= -1) & (labels < classes)).all()),
              f"{name}: labels out of range")

    fcfg = OverlapFeatureConfig()

    def featurize(buf, n):
        y = jnp.where(jnp.arange(fcfg.n_samples) < n[:, None],
                      buf[:, :fcfg.n_samples].astype(jnp.float32), 0.0)
        return overlap_model_input(y / 32768.0, fcfg)

    img, _, _ = timed("overlap_model_input b512 (plain XLA featurizer)",
                      featurize, buf, n)
    check(img.shape == (BATCH,) + fcfg.image_shape, f"image {img.shape}")
    ctx["images"] = img
    scfg = SpeakerFeatureConfig()
    mfcc, _, _ = timed("speaker_feature_batch b512 (plain XLA MFCC39)",
                       lambda b, n: speaker_feature_batch(
                           b.astype(jnp.float32), n, scfg)[0], buf, n)
    check(mfcc.shape == (BATCH,) + scfg.feature_shape, f"mfcc {mfcc.shape}")

    fbuf = buf.astype(jnp.float32)
    for name, fwd, variables, classes in (
            ("overlap serve chain b512 (denoise -> webrtc VAD -> trim -> "
             "features -> model)",
             bench.overlap_serve_chain(OverlapPredictor(ov_vars), batch=BATCH),
             ov_vars, 2),
            ("speaker serve chain b512 (denoise -> webrtc VAD -> trim -> "
             "MFCC39 -> model)",
             bench.speaker_serve_chain(SpeakerPredictor(sp_vars), batch=BATCH),
             sp_vars, 630)):
        (labels, logits), _, _ = timed(name, fwd, variables, fbuf, n)
        check(labels.shape == (BATCH,) and logits.shape == (BATCH, classes),
              f"{name}: shapes")
        check(bool(jnp.isfinite(logits).all()), f"{name}: non-finite logits")
        say(f"[{name}] silent windows: {int((labels == -1).sum())}/{BATCH}")

    frames = N_SAMPLES // 480

    def engine(x):
        return jax.vmap(lambda w: webrtc.webrtc_vad_frames(
            w[: frames * 480], webrtc.webrtc_init(), mode=3)[0])(x)

    x32 = jnp.asarray(x16, jnp.int32)
    ladder = webrtc.UNROLL_LADDER
    dec, _, t_ladder = timed(f"webrtc engine b512, unroll ladder {ladder}",
                             engine, x32)
    webrtc.UNROLL_LADDER = ()     # read at trace time: trace a new function
    try:
        dec_flat, _, t_flat = timed("webrtc engine b512, no unroll",
                                    lambda x: engine(x), x32)
    finally:
        webrtc.UNROLL_LADDER = ladder
    check(bool((dec == dec_flat).all()), "unroll changed webrtc decisions")
    say(f"[webrtc engine] ladder {ladder}: {t_ladder * 1e3:.3f} ms, no "
        f"unroll: {t_flat * 1e3:.3f} ms; decisions bit-identical")
    ctx["webrtc_decisions"] = np.asarray(dec)


# -- phase 2 ---------------------------------------------------------------------

def run_multiplexer(pred, kind, root, n_streams=N_STREAMS, windows_each=WINDOWS,
                    mesh=None, churn=False):
    """Serve ``n_streams`` prefilled streams of ``windows_each`` windows to
    exhaustion; checks that every window was decided and logged.  Returns
    (seconds, {stream: [label, ...]})."""
    from mmla_audio_tpu.streaming.capture import FakePCMSource, PrefilledCapture
    from mmla_audio_tpu.streaming.multiplex import Multiplexer

    noise = (np.random.RandomState(1).randn(160000) * 20).astype(np.int16)
    mux = Multiplexer(pred, root, kind=kind, bucket=n_streams, mesh=mesh)
    for s in range(n_streams):
        pcm = FakePCMSource(seed=s).read(windows_each * N_SAMPLES)
        mux.add_stream(f"s{s}", PrefilledCapture(pcm), noise)
    t0 = time.perf_counter()
    decided = mux.run_until_exhausted()
    expected = n_streams * windows_each
    streams = list(mux.streams)
    if churn:
        # retire one finished conversation and serve a new one on its row
        retired = mux.streams[0]
        mux.remove_stream(retired)
        late = mux.add_stream("late", PrefilledCapture(
            FakePCMSource(seed=10_000).read(windows_each * N_SAMPLES)), noise)
        check(late.index == retired.index, "churn did not recycle the row")
        decided += mux.run_until_exhausted()
        expected += windows_each
        streams.append(late)
    seconds = time.perf_counter() - t0
    check(decided == expected, f"{kind} multiplexer decided {decided} of "
          f"{expected} windows")
    labels = {}
    for st in streams:
        check(len(st.results) == windows_each,
              f"{st.name}: {len(st.results)} results")
        rows = Path(st.log.path).read_text().splitlines()
        check(len(rows) == windows_each + 1,
              f"{st.log.path}: {len(rows)} lines, want header + "
              f"{windows_each}")
        labels[st.name] = [r[1] for r in st.results]
    return seconds, labels


def phase_live(ctx):
    from mmla_audio_tpu import cli
    from mmla_audio_tpu.inference import OverlapPredictor, SpeakerPredictor
    from mmla_audio_tpu.utils.experiment import ExperimentDirs

    for kind, pred in (("overlap", OverlapPredictor(ctx["ov_vars"])),
                       ("speaker", SpeakerPredictor(ctx["sp_vars"]))):
        runs = []
        for _ in ("cold", "warm"):
            with tempfile.TemporaryDirectory() as root:
                seconds, _ = run_multiplexer(pred, kind, root)
            runs.append(seconds)
        say(f"[multiplexer {kind}] {N_STREAMS} streams x {WINDOWS} windows, "
            f"webrtc: cold {runs[0]:.2f} s (compile ~{runs[0] - runs[1]:.2f} "
            f"s), warm {runs[1]:.2f} s; every window decided and logged")

    def live(argv):
        with tempfile.TemporaryDirectory() as root:
            t0 = time.perf_counter()
            cli.main(argv + ["--root", root])
            logs = sorted(ExperimentDirs(root).logs.glob("*.txt"))
            check(len(logs) == 1, f"{argv[0]}: logs {logs}")
            rows = logs[-1].read_text().splitlines()
            check(len(rows) == WINDOWS + 1, f"{logs[-1]}: {len(rows)} lines")
            say(f"[cli {' '.join(argv)}] {time.perf_counter() - t0:.1f} s "
                f"(compile included), {WINDOWS} windows logged")

    live(["overlap-live", "--fake", "--windows", str(WINDOWS),
          "--no-host-preprocess"])
    live(["overlap-live", "--fake", "--windows", str(WINDOWS)])
    live(["speaker-live", "--fake", "--windows", str(WINDOWS),
          "--register", "alice", "bob", "--enroll-seconds", "30",
          "--phase1-epochs", "40", "--phase2-epochs", "2"])


# -- phase 3 ---------------------------------------------------------------------

def phase_train(ctx):
    import jax
    import jax.numpy as jnp

    from mmla_audio_tpu.models.overlap import OverlapResBLSTM
    from mmla_audio_tpu.train import Trainer, adadelta, keras_categorical_crossentropy

    x = ctx["images"][: 3 * TRAIN_BATCH]
    y = jax.nn.one_hot(jnp.arange(x.shape[0]) % 2, 2)
    trainer = Trainer(OverlapResBLSTM(), adadelta(1e-2),
                      keras_categorical_crossentropy)
    state = trainer.init_state(ctx["ov_vars"])
    before, _ = trainer.evaluate(state, x[:TRAIN_BATCH], y[:TRAIN_BATCH])
    secs = []
    for epoch in range(2):
        t0 = time.perf_counter()
        state, hist = trainer.fit(state, x, y, epochs=1,
                                  batch_size=TRAIN_BATCH,
                                  rng=jax.random.PRNGKey(epoch))
        secs.append(time.perf_counter() - t0)
        check(np.isfinite(hist["loss"]).all(), f"loss {hist['loss']}")
        say(f"[train overlap b{TRAIN_BATCH}] epoch {epoch}: 3 steps, loss "
            f"{hist['loss'][0]:.6f}, {secs[-1]:.2f} s")
    after, _ = trainer.evaluate(state, x[:TRAIN_BATCH], y[:TRAIN_BATCH])
    check(np.isfinite(after) and after != before,
          f"eval loss did not change: {before} -> {after}")
    say(f"[train overlap b{TRAIN_BATCH}] compile ~{secs[0] - secs[1]:.2f} s, "
        f"step {secs[1] / 3 * 1e3:.1f} ms; eval loss {before:.6f} -> "
        f"{after:.6f}")


# -- phase 4 ---------------------------------------------------------------------

def phase_compare(ctx):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from mmla_audio_tpu.core.config import PipelineConfig
    from mmla_audio_tpu.inference import OverlapPredictor, SpeakerPredictor
    from mmla_audio_tpu.ops.denoise import noise_threshold, quantize_i16, reduce_noise
    from mmla_audio_tpu.ops.features import overlap_model_input, speaker_feature_batch
    from mmla_audio_tpu.vad.native import NativeWebRtcVad

    cfg = PipelineConfig()
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    B = COMPARE_BATCH
    x16 = ctx["x16"][:B]
    n = np.full((B,), N_SAMPLES, np.int32)
    say(f"[compare] {B} windows at full width; card {gpu.device_kind} vs "
        f"host CPU backend, float32 on both")

    frames = N_SAMPLES // 480
    native = np.stack([NativeWebRtcVad(3).decisions(w[: frames * 480])
                       for w in x16])
    dev = ctx["webrtc_decisions"][:B]
    check(native.shape == dev.shape and bool((native == dev).all()),
          f"webrtc decisions differ from the native engine in "
          f"{int((native != dev).sum())} of {native.size} frames")
    say(f"[compare webrtc] {native.size} frame decisions bit-identical to "
        f"the native C++ engine (tolerance: none)")

    def both(fn, *args):
        """fn on the card and on the CPU, the arguments committed to each."""
        f = jax.jit(fn)
        return [np.asarray(f(*jax.device_put(args, d))) for d in (gpu, cpu)]

    noise = (np.random.RandomState(1).randn(160000) * 20).astype(np.int16)

    def denoise(x, noise, dcfg=cfg.denoise):
        nt = noise_threshold(noise.astype(jnp.float32) / 32768.0, dcfg)
        y = jax.vmap(lambda r: reduce_noise(r / 32768.0, nt, dcfg))(
            x.astype(jnp.float32))
        return quantize_i16(y)

    g, c = both(denoise, x16, noise)
    d = np.abs(g.astype(np.int32) - c.astype(np.int32))
    share = float((d > 0).mean())
    say(f"[compare denoise] int16 waveform at precision "
        f"{cfg.denoise.precision}: max |diff| {int(d.max())} LSB on "
        f"{share:.5%} of samples (tolerance <= {DENOISE_MAX_LSB} LSB on "
        f"<= {DENOISE_MAX_SHARE:.1%})")
    check(d.max() <= DENOISE_MAX_LSB and share <= DENOISE_MAX_SHARE,
          "denoise outside tolerance")
    tf32 = dataclasses.replace(cfg.denoise, precision="default")
    g32 = np.asarray(jax.jit(lambda x, n: denoise(x, n, tf32))(
        *jax.device_put((x16, noise), gpu)))
    d = np.abs(g32.astype(np.int32) - c.astype(np.int32))
    say(f"[compare denoise] at precision default (TF32 on the card, "
        f"measured, no tolerance): max |diff| {int(d.max())} LSB on "
        f"{float((d > 0).mean()):.5%} of samples")

    fcfg = cfg.overlap_feature
    g, c = both(lambda x: overlap_model_input(
        x[:, :fcfg.n_samples].astype(jnp.float32) / 32768.0, fcfg), x16)
    d = np.abs(g - c)
    same = float((d == 0).mean())
    say(f"[compare overlap image] uint8 pixels identical {same:.5%}, max "
        f"|diff| {d.max():g} (tolerance >= {IMAGE_MIN_SAME:.1%} identical, "
        f"max {IMAGE_MAX_DIFF})")
    check(same >= IMAGE_MIN_SAME and d.max() <= IMAGE_MAX_DIFF,
          "overlap image outside tolerance")

    g, c = both(lambda x, n: speaker_feature_batch(
        x.astype(jnp.float32), n, cfg.speaker_feature)[0], x16, n)
    rel = float(np.abs(g - c).max() / np.abs(c).max())
    say(f"[compare mfcc39] max |diff| / max |cpu| = {rel:.3e} (tolerance "
        f"{MFCC_REL_TOL:g})")
    check(rel <= MFCC_REL_TOL, "MFCC39 outside tolerance")

    for name, make, variables in (
            ("overlap", OverlapPredictor, ctx["ov_vars"]),
            ("speaker", SpeakerPredictor, ctx["sp_vars"])):
        for precision in ("highest", None):
            fwd = jax.jit(make(variables, matmul_precision=precision)
                          .lower_fn())
            (gl, gp), (cl, cp) = [
                [np.asarray(a) for a in fwd(*jax.device_put(
                    (variables, x16, n), d))] for d in (gpu, cpu)]
            agree = float((gl == cl).mean())
            drift = float(np.abs(gp - cp).max())
            label = "highest (FP32)" if precision else "default (TF32 on the card)"
            say(f"[compare {name} predictor, {label}] label agreement "
                f"{agree:.4f}, max |prob diff| {drift:.3e}")
            if precision == "highest":
                check(agree == 1.0 and drift <= PROB_TOL_HIGHEST,
                      f"{name} predictor outside tolerance (labels identical, "
                      f"probs within {PROB_TOL_HIGHEST:g})")


# -- phase 5 ---------------------------------------------------------------------

def phase_four_cards(ctx):
    import jax

    from mmla_audio_tpu.inference import OverlapPredictor
    from mmla_audio_tpu.models.overlap import OverlapResBLSTM
    from mmla_audio_tpu.models.speaker import SpeakerResBLSTM, l2_penalty
    from mmla_audio_tpu.parallel import DataParallel, make_mesh
    from mmla_audio_tpu.train import Trainer, keras_categorical_crossentropy, rmsprop

    devices = jax.devices()
    check(len(devices) >= 4, f"--four-cards needs 4 cards, have {len(devices)}")
    mesh = make_mesh(n_data=4, devices=devices[:4])
    one = devices[0]
    ov_vars = OverlapResBLSTM().init_variables(jax.random.PRNGKey(0))
    pred = OverlapPredictor(ov_vars, matmul_precision="highest")
    buf = windows(BATCH)
    n = np.full((BATCH,), N_SAMPLES, np.int32)

    fwd = pred.lower_fn()
    (l1, p1), _, t1 = timed("overlap predictor b512, one card", fwd,
                            *jax.device_put((ov_vars, buf, n), one))
    dp = DataParallel(fwd, mesh)
    t0 = time.perf_counter()
    l4, p4 = jax.block_until_ready(dp(ov_vars, buf, n))
    compile_s = time.perf_counter() - t0
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        jax.block_until_ready(dp(ov_vars, buf, n))
        times.append(time.perf_counter() - t0)
    drift = float(np.abs(np.asarray(p4) - np.asarray(p1)).max())
    say(f"[DataParallel overlap b512, 4 cards] compile {compile_s:.2f} s, run "
        f"{np.median(times) * 1e3:.3f} ms (one card {t1 * 1e3:.3f} ms); "
        f"labels identical: {bool((np.asarray(l4) == np.asarray(l1)).all())}, "
        f"max |prob diff| {drift:.3e} (tolerance {PROB_TOL_MESH:g})")
    check(bool((np.asarray(l4) == np.asarray(l1)).all())
          and drift <= PROB_TOL_MESH, "DataParallel outside tolerance")

    results = {}
    for name, m in (("one card", None), ("4-card mesh", mesh)):
        with tempfile.TemporaryDirectory() as root:
            seconds, labels = run_multiplexer(pred, "overlap", root, mesh=m,
                                              churn=True)
        results[name] = labels
        say(f"[multiplexer webrtc + churn, {name}] {seconds:.2f} s "
            f"(compile included), {sum(map(len, labels.values()))} windows")
    check(results["one card"] == results["4-card mesh"],
          "mesh multiplexer labels differ from one card")
    say("[multiplexer] mesh labels identical to one card, every stream")

    model = SpeakerResBLSTM()
    rng = np.random.RandomState(0)
    x = rng.randn(4 * TRAIN_BATCH, 256, 39).astype(np.float32)
    y = np.eye(630, dtype=np.float32)[rng.randint(0, 630, len(x))]
    losses = {}
    for name, m in (("one card", None), ("4-card mesh", mesh)):
        trainer = Trainer(model, rmsprop(1e-4), keras_categorical_crossentropy,
                          extra_penalty_fn=l2_penalty)
        with jax.default_matmul_precision("highest"):
            state = trainer.init_state(
                model.init_variables(jax.random.PRNGKey(1)))
            t0 = time.perf_counter()
            state, hist = trainer.fit(state, x, y, epochs=2,
                                      batch_size=TRAIN_BATCH, mesh=m)
        losses[name] = np.asarray(hist["loss"])
        say(f"[speaker Trainer.fit, {name}] 2 epochs x 4 steps of b"
            f"{TRAIN_BATCH}: losses {losses[name].tolist()}, "
            f"{time.perf_counter() - t0:.2f} s (compile included)")
    rel = float(np.abs(losses["4-card mesh"] - losses["one card"]).max()
                / np.abs(losses["one card"]).max())
    say(f"[speaker Trainer.fit] mesh vs one card: max relative loss diff "
        f"{rel:.3e} (tolerance {LOSS_REL_TOL_MESH:g})")
    check(rel <= LOSS_REL_TOL_MESH, "mesh training outside tolerance")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the data-parallel path on a 4-card mesh "
                         "and its one-card comparison")
    args = ap.parse_args(argv)

    import jax

    from mmla_audio_tpu.utils.compile_cache import enable_compile_cache
    from mmla_audio_tpu.utils.device import gpu_name_and_power_limit, require_gpu

    with phase("phase 0: device"):
        dev = require_gpu()
        say(f"nvidia-smi name, power.limit: {gpu_name_and_power_limit()}")
        say(f"jax {jax.__version__}; devices {jax.devices()}; "
            f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
        say(f"compile cache: {enable_compile_cache()}")

    ctx = {}
    if args.four_cards:
        with phase("phase 5: four cards"):
            phase_four_cards(ctx)
    else:
        with phase("phase 1: serve programs at b512"):
            phase_serve(ctx)
        with phase("phase 2: live path"):
            phase_live(ctx)
        with phase("phase 3: training"):
            phase_train(ctx)
        with phase("phase 4: comparison with the CPU backend"):
            phase_compare(ctx)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
