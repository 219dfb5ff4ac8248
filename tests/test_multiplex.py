"""Multi-stream multiplexer: batching across concurrent sessions."""

import numpy as np
import jax

from tests.conftest import synth_speech_i16

from mmla_audio_tpu.analyze.logs import parse_log
from mmla_audio_tpu.inference import OverlapPredictor, SpeakerPredictor
from mmla_audio_tpu.models.overlap import OverlapResBLSTM
from mmla_audio_tpu.models.speaker import SpeakerResBLSTM
from mmla_audio_tpu.parallel import make_mesh
from mmla_audio_tpu.streaming.capture import ArraySource, CaptureThread
from mmla_audio_tpu.streaming.multiplex import Multiplexer
from mmla_audio_tpu.streaming.session import OverlapSession


def _noise(seed=0, amp=15):
    return (np.random.RandomState(seed).randn(160000) * amp).astype(np.int16)


def _make_mux(tmp_path, n_streams=3, windows_each=2, mesh=None, bucket=4):
    pred = OverlapPredictor(
        OverlapResBLSTM().init_variables(jax.random.PRNGKey(0)))
    mux = Multiplexer(pred, tmp_path / "experiment", kind="overlap",
                      bucket=bucket, mesh=mesh)
    caps = []
    for s in range(n_streams):
        audio = np.concatenate(
            [synth_speech_i16(40960, seed=s * 10 + w)
             for w in range(windows_each)])
        cap = CaptureThread(ArraySource(audio)).start()
        caps.append(cap)
        mux.add_stream(f"conv{s}", cap, _noise(seed=s))
    return mux, caps


def test_phase_counters_account_host_side_cost(tmp_path):
    """First-class phase accounting (bench's live_*_host_side_ms source):
    every resolved window accrues gather/stage/dispatch/fetch/log time, and
    host_side_seconds() = gather + stage + resolve_log exactly."""
    mux, caps = _make_mux(tmp_path, n_streams=3, windows_each=2)
    total = mux.run_until_exhausted()
    for c in caps:
        c.stop()
    assert total == 6 and mux.windows_resolved == 6
    p = mux.phase_seconds
    assert all(v > 0.0 for v in p.values()), p
    assert mux.host_side_seconds() == \
        p["gather"] + p["stage"] + p["resolve_log"]
    mux.reset_phase_counters()
    assert mux.windows_resolved == 0
    assert all(v == 0.0 for v in mux.phase_seconds.values())


def test_multiplexer_overlap_streams(tmp_path):
    mux, caps = _make_mux(tmp_path, n_streams=3, windows_each=2)
    total = mux.run_until_exhausted()
    for c in caps:
        c.stop()
    assert total == 6
    for stream in mux.streams:
        assert len(stream.results) == 2
        rows = parse_log(stream.log.path)
        assert [r[0] for r in rows] == [1, 2]
        assert all(r[1] in ("non-overlapped", "overlapped", "silent")
                   for r in rows)
    logs = list((tmp_path / "experiment" / "logs").glob("*.txt"))
    assert len(logs) == 3


def test_multiplexer_matches_single_session_labels(tmp_path):
    """Batched multiplexed decisions == the single-stream session decisions
    for the same audio and noise profile."""
    variables = OverlapResBLSTM().init_variables(jax.random.PRNGKey(0))
    pred = OverlapPredictor(variables)
    audio = np.concatenate([synth_speech_i16(40960, seed=7),
                            np.zeros(40960, np.int16)])
    noise = _noise(seed=3)

    cap1 = CaptureThread(ArraySource(audio)).start()
    sess = OverlapSession(pred, cap1, tmp_path / "exp_single")
    sess.set_noise_profile(noise)
    single = [r[1] for r in sess.run(max_windows=2)]
    cap1.stop()

    mux = Multiplexer(pred, tmp_path / "exp_mux", kind="overlap", bucket=2)
    cap2 = CaptureThread(ArraySource(audio)).start()
    stream = mux.add_stream("a", cap2, noise)
    mux.run_until_exhausted()
    cap2.stop()
    muxed = [r[1] for r in stream.results]
    assert muxed == single


def test_multiplexer_on_mesh(tmp_path):
    mesh = make_mesh()
    mux, caps = _make_mux(tmp_path, n_streams=4, windows_each=1, mesh=mesh,
                          bucket=8)
    total = mux.run_until_exhausted()
    for c in caps:
        c.stop()
    assert total == 4


def test_multiplexer_speaker_kind(tmp_path):
    pred = SpeakerPredictor(
        SpeakerResBLSTM(head_units=2).init_variables(jax.random.PRNGKey(1)),
        head_units=2, sigmoid_head=True)
    mux = Multiplexer(pred, tmp_path / "experiment", kind="speaker", bucket=2)
    audio = synth_speech_i16(40960, seed=9)
    cap = CaptureThread(ArraySource(audio)).start()
    stream = mux.add_stream("s", cap, _noise(seed=1),
                            label_names={"0": "alice", "1": "bob"})
    total = mux.run_until_exhausted()
    cap.stop()
    assert total == 1
    assert stream.results[0][1] in ("alice", "bob", "silent")


def test_bucket_ladder_and_nonblocking(tmp_path):
    """A stream with no data never stalls the tick; ready counts round up to
    the smallest sufficient bucket."""
    import time

    import jax

    from mmla_audio_tpu.core.config import PipelineConfig
    from mmla_audio_tpu.inference import OverlapPredictor
    from mmla_audio_tpu.models.overlap import OverlapResBLSTM
    from mmla_audio_tpu.streaming.capture import ArraySource, CaptureThread

    cfg = PipelineConfig()
    pred = OverlapPredictor(
        OverlapResBLSTM().init_variables(jax.random.PRNGKey(0)))
    mux = Multiplexer(pred, tmp_path / "experiment", kind="overlap",
                      buckets=(2, 4), cfg=cfg)
    n_win = cfg.audio.window_samples
    rng = np.random.RandomState(0)

    dispatched = []
    orig = mux._dispatch_staged

    def spy():
        ready, labels = orig()
        dispatched.append((len(ready), labels.shape[0]))
        return ready, labels

    mux._dispatch_staged = spy

    noise = (rng.randn(160000) * 20).astype(np.int16)
    # three live streams + one permanently empty (never exhausted) stream
    for s in range(3):
        cap = CaptureThread(ArraySource(
            (rng.randn(n_win) * 3000).astype(np.int16))).start()
        mux.add_stream(f"s{s}", cap, noise)

    class _Starved:
        exhausted = False

        def read(self, n):
            time.sleep(0.01)
            return np.zeros(0, np.int16)

    starved_cap = CaptureThread(_Starved()).start()
    mux.add_stream("starved", starved_cap, noise)

    time.sleep(0.3)          # let rings fill
    mux.tick()
    n = mux.flush()
    assert n == 3
    # 3 ready -> padded to bucket 4 (smallest sufficient)
    assert dispatched[0] == (3, 4)
    # the starved stream cost a poll, not a timeout: the GATHER phase (the
    # first-class counter — dispatch/compile excluded) must show no
    # 2 s/stream blocking waits
    assert mux.phase_seconds["gather"] < 2.0

    # second round: a fresh stream is the only one with data -> bucket 2
    cap_new = CaptureThread(ArraySource(
        (rng.randn(n_win) * 3000).astype(np.int16))).start()
    mux.add_stream("late", cap_new, noise)
    time.sleep(0.2)
    mux.tick()
    mux.flush()
    assert dispatched[-1] == (1, 2)
    for s in mux.streams:
        s.capture.stop()


def test_round_robin_fairness(tmp_path):
    """With more ready streams than the bucket, rotation serves all of them
    across consecutive ticks."""
    import jax

    from mmla_audio_tpu.core.config import PipelineConfig
    from mmla_audio_tpu.inference import OverlapPredictor
    from mmla_audio_tpu.models.overlap import OverlapResBLSTM
    from mmla_audio_tpu.streaming.capture import ArraySource, CaptureThread

    cfg = PipelineConfig()
    pred = OverlapPredictor(
        OverlapResBLSTM().init_variables(jax.random.PRNGKey(0)))
    mux = Multiplexer(pred, tmp_path / "experiment", kind="overlap",
                      buckets=(2,), cfg=cfg)
    n_win = cfg.audio.window_samples
    rng = np.random.RandomState(1)
    noise = (rng.randn(160000) * 20).astype(np.int16)
    for s in range(4):      # 4 streams, bucket 2 -> two ticks per round
        cap = CaptureThread(ArraySource(
            np.tile((rng.randn(n_win) * 3000).astype(np.int16), 2))).start()
        mux.add_stream(f"s{s}", cap, noise)
    total = mux.run_until_exhausted()
    assert total == 8
    assert all(len(s.results) == 2 for s in mux.streams), \
        [(s.name, len(s.results)) for s in mux.streams]
    for s in mux.streams:
        s.capture.stop()


def test_min_fill_accumulates_then_stall_drains(tmp_path):
    """With min_fill, a partial gather is held, not padded out; a tick with
    no new arrivals drains it (so light traffic still decides in ~one
    tick)."""
    import time

    from mmla_audio_tpu.core.config import PipelineConfig

    cfg = PipelineConfig()
    pred = OverlapPredictor(
        OverlapResBLSTM().init_variables(jax.random.PRNGKey(0)))
    mux = Multiplexer(pred, tmp_path / "experiment", kind="overlap",
                      buckets=(4,), min_fill=0.75, cfg=cfg)
    dispatched = []
    orig = mux._dispatch_staged

    def spy():
        ready, labels = orig()
        dispatched.append(len(ready))
        return ready, labels

    mux._dispatch_staged = spy
    n_win = cfg.audio.window_samples
    rng = np.random.RandomState(0)
    noise = (rng.randn(160000) * 20).astype(np.int16)
    for s in range(2):
        cap = CaptureThread(ArraySource(
            (rng.randn(n_win) * 3000).astype(np.int16))).start()
        mux.add_stream(f"s{s}", cap, noise)
    time.sleep(0.3)                    # both rings full
    mux.tick()
    # 2 ready < 0.75*4=3: held, not dispatched
    assert dispatched == [] and len(mux._pending) == 2
    mux.tick()                         # nothing new -> stall drain
    assert dispatched == [2]
    assert mux.flush() == 2
    for s in mux.streams:
        s.capture.stop()


def test_min_fill_run_until_exhausted_decides_everything(tmp_path):
    """min_fill must never strand windows at end of streams."""
    mux, caps = _make_mux(tmp_path, n_streams=3, windows_each=2)
    mux.min_fill = 1.0                 # strictest setting
    total = mux.run_until_exhausted()
    for c in caps:
        c.stop()
    assert total == 6
    assert all(len(s.results) == 2 for s in mux.streams)


def test_multiplexer_webrtc_vad_matches_single_session(tmp_path):
    """VadConfig(decision='webrtc'): the batched program gathers/scatters
    per-stream detector rows from the stacked device state; labels AND the
    threaded webrtcvad adaptation must match the single-stream session
    window-for-window (sequential-state contract across ticks)."""
    import dataclasses

    from mmla_audio_tpu.core.config import PipelineConfig, VadConfig

    cfg = dataclasses.replace(PipelineConfig(),
                              vad=VadConfig(decision="webrtc"))
    variables = OverlapResBLSTM().init_variables(jax.random.PRNGKey(0))
    pred = OverlapPredictor(variables)
    audios = [np.concatenate([synth_speech_i16(40960, seed=s * 3 + w)
                              for w in range(3)]) for s in range(2)]
    noises = [_noise(seed=s) for s in range(2)]

    singles = []
    states = []
    for s in range(2):
        cap = CaptureThread(ArraySource(audios[s])).start()
        # the DEVICE fused path is the subject (its threaded vad_state is
        # compared against the stacked mux rows below) — pin it so the
        # "auto" routing doesn't take the native host split
        sess = OverlapSession(pred, cap, tmp_path / f"exp_single{s}",
                              cfg=cfg, host_preprocess=False)
        sess.set_noise_profile(noises[s])
        singles.append([r[1] for r in sess.run(max_windows=3)])
        states.append(sess.vad_state)
        cap.stop()

    mux = Multiplexer(pred, tmp_path / "exp_mux", kind="overlap", bucket=2,
                      cfg=cfg)
    caps = []
    for s in range(2):
        cap = CaptureThread(ArraySource(audios[s])).start()
        caps.append(cap)
        mux.add_stream(f"s{s}", cap, noises[s])
    mux.run_until_exhausted()
    for c in caps:
        c.stop()

    for s, stream in enumerate(mux.streams):
        assert [r[1] for r in stream.results] == singles[s]
        # the stacked device state row equals the session's threaded state
        row = jax.tree_util.tree_map(lambda a: np.asarray(a)[stream.index],
                                     mux._webrtc_states)
        for a, b in zip(jax.tree_util.tree_leaves(row),
                        jax.tree_util.tree_leaves(states[s])):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_remove_stream_recycles_rows_bit_exactly(tmp_path):
    """Conversation churn stays bounded: retiring finished streams and adding
    new ones reuses their slots AND their stacked webrtc-state rows (reset to
    a fresh Vad init) — a long-lived host serving arriving/ending
    conversations holds its high-water stream count instead of leaking a
    streams-list slot + gather row + detector-state row per conversation.
    The recycled-row stream's decisions must be bit-identical to the same
    audio served by a fresh multiplexer (fresh-``Vad``-instance semantics)."""
    audio_b = np.concatenate([synth_speech_i16(40960, seed=77),
                              synth_speech_i16(40960, seed=78)])
    noise = _noise(seed=3)

    pred = OverlapPredictor(
        OverlapResBLSTM().init_variables(jax.random.PRNGKey(0)))
    mux_ref = Multiplexer(pred, tmp_path / "exp_ref", kind="overlap", bucket=2)
    assert mux_ref.cfg.vad.decision == "webrtc"
    cap = CaptureThread(ArraySource(audio_b)).start()
    s_ref = mux_ref.add_stream("ref", cap, noise)
    mux_ref.run_until_exhausted()
    cap.stop()
    ref = [r[1] for r in s_ref.results]
    assert len(ref) == 2

    mux, caps = _make_mux(tmp_path, n_streams=2, windows_each=2, bucket=2)
    mux.run_until_exhausted()
    old = list(mux.streams)
    for s in old:
        mux.remove_stream(s)
        mux.remove_stream(s)                    # idempotent
    cap_b = CaptureThread(ArraySource(audio_b)).start()
    late = mux.add_stream("late", cap_b, noise)
    assert late.index == old[0].index           # slot recycled...
    assert len(mux.streams) == 2                # ...not appended
    assert mux.retired == [old[0]] and mux._retiring == [old[1]]
    mux.run_until_exhausted()
    cap_b.stop()
    for c in caps:
        c.stop()
    assert mux._webrtc_n <= 2                   # stacked state stayed bounded
    assert [r[1] for r in late.results] == ref  # fresh-Vad semantics on reuse
    assert len(old[0].results) == 2             # retired results intact


def test_remove_stream_defers_row_reuse_while_pending(tmp_path):
    """A retiring stream's row must NOT be recycled while one of its windows
    is still pending/in flight: the dispatched batch scatters that stream's
    updated detector state back to its row, which would corrupt a new
    stream's freshly-reset state."""
    import time

    mux, caps = _make_mux(tmp_path, n_streams=2, windows_each=1, bucket=4)
    mux.min_fill = 1.0                          # hold gathered rows pending
    n_win = mux.cfg.audio.window_samples
    for s in mux.streams:                       # wait for the rings to fill
        for _ in range(1000):
            if s.capture.ring.available >= n_win:
                break
            time.sleep(0.005)
    mux.tick()                                  # gather both; no dispatch
    s0 = mux.streams[0]
    assert s0 in mux._pending
    mux.remove_stream(s0)
    cap = CaptureThread(ArraySource(synth_speech_i16(40960, seed=99))).start()
    late = mux.add_stream("late", cap, _noise(seed=9))
    assert late.index == 2                      # appended: row 0 still unsafe
    total = mux.run_until_exhausted()
    assert total == 3                           # s0's pending window resolved
    assert len(s0.results) == 1                 # ...into the retired stream
    cap2 = CaptureThread(
        ArraySource(synth_speech_i16(40960, seed=100))).start()
    late2 = mux.add_stream("late2", cap2, _noise(seed=10))
    assert late2.index == s0.index              # now safe to recycle
    for c in caps:
        c.stop()
    cap.stop()
    cap2.stop()


def test_churn_soak_state_stays_at_high_water(tmp_path):
    """Three generations of conversations through one multiplexer: state
    (streams list, stacked detector rows) holds at the high-water count and
    every window of every generation resolves exactly once."""
    pred = OverlapPredictor(
        OverlapResBLSTM().init_variables(jax.random.PRNGKey(0)))
    mux = Multiplexer(pred, tmp_path / "experiment", kind="overlap", bucket=4)
    noise = _noise(seed=3)
    all_streams, caps = [], []

    def admit(tag, n):
        for i in range(n):
            cap = CaptureThread(ArraySource(
                synth_speech_i16(40960, seed=hash((tag, i)) % 1000))).start()
            caps.append(cap)
            all_streams.append(mux.add_stream(f"{tag}{i}", cap, noise))

    admit("g0_", 4)
    for gen in range(1, 4):
        assert mux.run_until_exhausted() == 4
        for s in list(mux.streams):
            mux.remove_stream(s)
        admit(f"g{gen}_", 4)
        assert len(mux.streams) == 4            # slots recycled, not grown
    assert mux.run_until_exhausted() == 4
    for c in caps:
        c.stop()
    assert mux._webrtc_n <= 4                   # detector rows at high water
    assert len(mux.retired) + len(mux._retiring) == 12
    assert all(len(s.results) == 1 for s in all_streams)


def test_churn_soak_host_objects_bounded(tmp_path):
    """The retention policy bounds HOST object growth, not just device
    rows: with remove_stream(archive=False) + results_cap, a multi-
    generation churn holds `retired` empty, `_retiring` at most one
    generation deep, and every live stream's in-memory results tail at the
    cap — while the TSV logs keep the complete record (otherwise
    Stream.results grows one tuple per window forever and `retired` archives
    every finished conversation)."""
    pred = OverlapPredictor(
        OverlapResBLSTM().init_variables(jax.random.PRNGKey(0)))
    mux = Multiplexer(pred, tmp_path / "experiment", kind="overlap",
                      bucket=4, results_cap=2)
    noise = _noise(seed=3)
    caps, log_paths = [], []
    windows_each = 3                            # > results_cap

    def admit(tag, n):
        for i in range(n):
            audio = np.concatenate(
                [synth_speech_i16(40960, seed=hash((tag, i, w)) % 1000)
                 for w in range(windows_each)])
            cap = CaptureThread(ArraySource(audio)).start()
            caps.append(cap)
            s = mux.add_stream(f"{tag}{i}", cap, noise)
            log_paths.append(s.log.path)

    admit("h0_", 4)
    for gen in range(1, 4):
        assert mux.run_until_exhausted() == 4 * windows_each
        for s in list(mux.streams):
            mux.remove_stream(s, archive=False)
        admit(f"h{gen}_", 4)
        assert len(mux.streams) == 4            # slots recycled, not grown
        # dropped-at-recycle policy: no archived Stream objects accrete,
        # and at most the not-yet-recycled generation is still retiring
        assert len(mux.retired) == 0
        assert len(mux._retiring) <= 4
    assert mux.run_until_exhausted() == 4 * windows_each
    for c in caps:
        c.stop()
    # results tails bounded at the cap even though each stream resolved
    # windows_each > cap windows...
    assert all(len(s.results) == 2 for s in mux.streams)
    # ...while every window of every generation landed in its TSV log
    assert len(log_paths) == 16
    for p in log_paths:
        assert len(parse_log(p)) == windows_each
    # idempotence: re-removing an already-dropped stream is a no-op
    s0 = mux.streams[0]
    mux.remove_stream(s0, archive=False)
    mux.remove_stream(s0)                       # archive flag must not flip
    assert s0.archive is False and len(mux.retired) == 0


def test_calibration_cache_shared_profile_computed_once(tmp_path, monkeypatch):
    """Fleets of streams typically share one ambient profile; the per-band
    noise threshold is a device round-trip per derivation, so add_stream
    caches calibration by CONTENT digest:
    same bytes -> one derivation (even via a mutated-then-restored buffer),
    different bytes -> fresh derivation, cache bounded FIFO."""
    import mmla_audio_tpu.streaming.multiplex as mx

    calls = []
    real = mx.noise_threshold
    monkeypatch.setattr(mx, "noise_threshold",
                        lambda nf, cfg: calls.append(1) or real(nf, cfg))
    pred = OverlapPredictor(
        OverlapResBLSTM().init_variables(jax.random.PRNGKey(0)))
    mux = Multiplexer(pred, tmp_path / "experiment", kind="overlap", bucket=4)
    noise_a, noise_b = _noise(seed=1), _noise(seed=2)

    caps = [CaptureThread(ArraySource(synth_speech_i16(40960, seed=s))).start()
            for s in range(4)]
    s0 = mux.add_stream("a0", caps[0], noise_a)
    s1 = mux.add_stream("a1", caps[1], noise_a.copy())   # same content
    assert len(calls) == 1                               # one derivation
    assert s1.vad_threshold_db == s0.vad_threshold_db
    np.testing.assert_array_equal(s1.noise_thresh, s0.noise_thresh)
    s2 = mux.add_stream("b0", caps[2], noise_b)          # different content
    assert len(calls) == 2
    assert not np.array_equal(s2.noise_thresh, s0.noise_thresh)
    mux.add_stream("a2", caps[3], noise_a)               # still cached
    assert len(calls) == 2
    # bound: the cache evicts FIFO past 256 distinct profiles
    assert len(mux._calib_cache) == 2
    mux._calib_cache = {bytes([i % 256, i // 256]): None for i in range(256)}
    cap = CaptureThread(ArraySource(synth_speech_i16(40960, seed=9))).start()
    caps.append(cap)
    mux.add_stream("c0", cap, noise_b)
    assert len(mux._calib_cache) == 256
    for c in caps:
        c.stop()


def test_python_fallback_gather_matches_native(tmp_path):
    """When a stream's capture has no native SPSC ring (toolchain-less
    install, raw source), the per-stream Python poll loop must produce the
    SAME decisions as the native batch gather for the same audio."""

    class _WindowCapture:
        """Minimal ring-less capture: hands out whole queued windows."""

        def __init__(self, windows):
            self._w = list(windows)
            self.source = self

        @property
        def exhausted(self):
            return not self._w

        def read_window(self, n_samples, timeout=0.0):
            if not self._w:
                return None
            w = self._w.pop(0)
            assert len(w) == n_samples
            return w

        def stop(self):
            pass

    pred = OverlapPredictor(
        OverlapResBLSTM().init_variables(jax.random.PRNGKey(0)))
    noise = _noise(seed=3)
    audio = [synth_speech_i16(40960, seed=s) for s in range(3)]

    # native path (CaptureThread -> NativeRingBuffer -> BatchGather)
    mux_n = Multiplexer(pred, tmp_path / "nat", kind="overlap", bucket=4)
    caps = [CaptureThread(ArraySource(a)).start() for a in audio]
    streams_n = [mux_n.add_stream(f"n{s}", c, noise)
                 for s, c in enumerate(caps)]
    assert mux_n.run_until_exhausted() == 3
    for c in caps:
        c.stop()
    assert mux_n._batch_gather is not None          # really the native path

    # fallback path (ring-less captures force the Python poll loop)
    mux_p = Multiplexer(pred, tmp_path / "py", kind="overlap", bucket=4)
    streams_p = [mux_p.add_stream(f"p{s}", _WindowCapture([a]), noise)
                 for s, a in enumerate(audio)]
    assert mux_p.run_until_exhausted() == 3
    assert mux_p._batch_gather is None              # really the fallback
    for sn, sp in zip(streams_n, streams_p):
        assert [r[1] for r in sn.results] == [r[1] for r in sp.results]


def test_multiplexer_energy_mode_speaker_on_mesh(tmp_path):
    """The energy opt-out decision through the mesh-sharded DataParallel
    batch program, speaker kind without label_names (numeric labels) — the
    non-webrtc corner of the serving matrix."""
    import dataclasses

    from mmla_audio_tpu.core.config import PipelineConfig, VadConfig

    cfg = dataclasses.replace(PipelineConfig(),
                              vad=VadConfig(decision="energy"))
    pred = SpeakerPredictor(
        SpeakerResBLSTM(head_units=2).init_variables(jax.random.PRNGKey(1)),
        head_units=2, sigmoid_head=True)
    mux = Multiplexer(pred, tmp_path / "experiment", kind="speaker",
                      bucket=8, cfg=cfg, mesh=make_mesh())
    assert not mux._use_webrtc
    caps = []
    for s in range(2):
        cap = CaptureThread(
            ArraySource(synth_speech_i16(40960, seed=20 + s))).start()
        caps.append(cap)
        mux.add_stream(f"s{s}", cap, _noise(seed=1))
    assert mux.run_until_exhausted() == 2
    for c in caps:
        c.stop()
    for s in mux.streams:
        assert len(s.results) == 1
        assert s.results[0][1] in ("0", "1", "silent")   # numeric fallthrough
