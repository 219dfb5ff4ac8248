"""Multi-stream serving: many live conversations, one device program.

The device batch path decides many windows per second, but only if windows
from concurrent sessions are batched; the reference architecture (one
process, one stream, batch 1) cannot use that headroom.  What a deployment
sustains end-to-end is the streams x RTF curve that ``bench.py`` measures
host-inclusive (``live_rtf_*_streams``).  ``Multiplexer``
owns k streams, each with its own capture ring, session log, and noise
profile; every tick it gathers whichever streams have a full 2.56 s window
ready, stacks them (padding the batch to a fixed bucket size so XLA reuses
one compiled program), runs the fused denoise->VAD->featurize->predict
batch once, and demuxes labels back to the per-stream logs.

This is pure data parallelism over the batch axis, so the same program runs
sharded over a mesh via ``parallel.DataParallel`` when more than one chip is
available (pass ``mesh=``).

Throughput mechanics (sized for hundreds of concurrent streams per host):

* **Non-blocking gather.** Each tick polls every stream's ring buffer
  directly (`ring.pop` returns None without blocking); a stalled stream
  costs one poll, never a timeout wait.  Gathering starts at a rotating
  offset so no stream starves when more are ready than fit a bucket.
* **Bucket ladder.** ``buckets`` is an ascending tuple of batch sizes; each
  tick pads the ready set up to the smallest sufficient bucket.  XLA caches
  one compiled program per bucket, so padding waste is bounded by the ladder
  spacing instead of always paying the largest batch.
* **One-tick pipeline.** The device batch is dispatched asynchronously and
  its labels are resolved on the NEXT tick, after that tick's gather+dispatch
  — host staging and device compute overlap instead of serializing.
"""

from __future__ import annotations

import time
from datetime import datetime
from typing import Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mmla_audio_tpu.analyze.logs import OVERLAP_LABELS, SessionLog
from mmla_audio_tpu.core.config import PipelineConfig
from mmla_audio_tpu.ops.denoise import noise_threshold
from mmla_audio_tpu.ops.features import overlap_model_input, speaker_feature_batch
from mmla_audio_tpu.streaming.session import preprocess_window
from mmla_audio_tpu.utils.experiment import ExperimentDirs, bootstrap

__all__ = ["Stream", "Multiplexer"]


class Stream:
    """One conversation: capture thread + log + calibration state.

    ``results`` keeps the most recent ``results_cap`` (index, label,
    timestamp) tuples (None = unbounded).  The TSV ``log`` is always the
    complete record; ``results`` is the in-memory tail for live consumers,
    so a cap loses nothing durable."""

    def __init__(self, name: str, capture, log: SessionLog,
                 noise_thresh, vad_threshold_db: float,
                 label_names: Optional[Dict[str, str]] = None,
                 index: int = 0, results_cap: Optional[int] = None):
        from collections import deque

        self.name = name
        self.capture = capture
        self.log = log
        self.noise_thresh = noise_thresh
        self.vad_threshold_db = vad_threshold_db
        self.label_names = label_names
        self.index = index                  # row in the stacked webrtc state
        self.results = deque(maxlen=results_cap) if results_cap else []
        self.done = False
        self.retiring = False               # remove_stream called
        self.archive = True                 # keep the Stream in .retired


class Multiplexer:
    """Batch windows across streams into one fused program per tick.

    ``kind``: 'overlap' or 'speaker'.  ``bucket`` fixes a single compiled
    batch size; ``buckets`` gives the ascending ladder of batch sizes (each
    tick rounds the ready count up to the smallest sufficient bucket; one
    compiled program is cached per bucket).  Padded rows are masked — one
    window of wasted compute each, bounded by the ladder spacing.

    Host-state retention policy (a week-long 1,000-stream host must stay
    bounded — the TSV logs on disk are always the complete record):

    * ``results_cap`` bounds every stream's in-memory ``results`` tail to
      the most recent N decisions (None = unbounded, the historical
      default; logged-only deployments want a small cap).
    * ``remove_stream(stream, archive=False)`` drops a finished
      conversation's Stream object once its row is recycled instead of
      archiving it in ``retired`` — otherwise ``retired`` accretes one
      full Stream (with its results tail) per finished conversation.
    """

    def __init__(self, predictor, dirs: ExperimentDirs | str, *,
                 kind: str = "overlap", bucket: int | None = None,
                 buckets: Sequence[int] = (8, 64),
                 min_fill: float | None = None,
                 max_pending_ticks: int = 4,
                 results_cap: int | None = None,
                 cfg: PipelineConfig = PipelineConfig(), mesh=None):
        self.predictor = predictor
        self.dirs = dirs if isinstance(dirs, ExperimentDirs) else bootstrap(dirs)
        self.kind = kind
        if bucket is not None:
            buckets = (bucket,)
        self.buckets = tuple(sorted(int(b) for b in buckets))
        assert self.buckets and all(b > 0 for b in self.buckets)
        self.bucket = self.buckets[-1]          # max gather per tick
        # Minimum batch-fill fraction before dispatching.  At high stream
        # counts, ring fills stagger (threaded capture), so an eager dispatch
        # pads mostly-empty buckets — measured 4x per-window cost at 256
        # streams.  With min_fill, ready windows accumulate across ticks and
        # dispatch fires when the top bucket is min_fill full, a tick
        # gathers nothing new (arrival stall / end of streams), or the
        # oldest pending window has waited ``max_pending_ticks`` ticks (the
        # latency cap under light-but-steady traffic).  ``None`` = auto:
        # 0.75 once the stream count reaches the top bucket, else eager —
        # the measured 3.6x win at 256 streams without hurting small setups.
        self.min_fill = min_fill
        assert min_fill is None or 0.0 <= min_fill <= 1.0
        self.max_pending_ticks = int(max_pending_ticks)
        self.results_cap = results_cap
        self._calib_cache: Dict[bytes, tuple] = {}
        self.cfg = cfg
        self.mesh = mesh
        self.streams: List[Stream] = []
        # Conversation churn is the steady state of a long-lived serving
        # host (the reference's sessions start and END, record_on_pc.py's
        # KeyboardInterrupt path) — without retirement every finished
        # conversation would leak a streams-list slot, a native-gather ring
        # row, and a stacked webrtc-state row forever.  remove_stream()
        # moves a finished stream to `_retiring`; add_stream() recycles its
        # row (slot + detector-state row reset to a fresh Vad init) once no
        # window of it is still pending/in-flight, archiving the old Stream
        # (results/log intact) in `retired`.
        self.retired: List[Stream] = []
        self._retiring: List[Stream] = []
        # Bit-exact webrtcvad mode: every stream's detector state lives as
        # one row of a device-resident stacked WebRtcVadState; the batched
        # program gathers the dispatched rows by index, runs the engine, and
        # scatters the updated rows back — states never leave the device and
        # sequential ordering is enforced by the data dependency on the
        # stacked array.
        self._use_webrtc = cfg.vad.decision == "webrtc"
        self._webrtc_states = None
        self._webrtc_n = 0
        self._rr = 0                            # round-robin gather offset
        self._inflight = None                   # (ready streams, labels)
        # Host staging: gathered windows land DIRECTLY in rows of one
        # (top_bucket, n_win) int16 matrix (the native batch gather memcpys
        # straight from the rings; int16 halves the host->device bytes vs
        # the old float32 staging — the program casts on device).  Dispatch
        # sends a zero-copy row-slice view sized to the smallest sufficient
        # bucket.  TWO buffers, flipped per dispatch: the one-tick pipeline
        # keeps one batch in flight whose host->device transfer may still be
        # asynchronous — writing the same numpy buffer would corrupt it
        # (observed as timing-dependent wrong labels under host load).
        n_win = cfg.audio.window_samples
        self._fill = [np.zeros((self.bucket, n_win), np.int16)
                      for _ in range(2)]
        self._flip = 0
        # calibration staging needs the SAME double buffering as the window
        # matrix: jnp.asarray of a numpy buffer can be zero-copy on some
        # backends, so rows of an in-flight batch must never be rewritten
        self._nts = None                        # 2 x (top_bucket, …) lazily
        self._vts = [np.zeros((self.bucket,), np.float32) for _ in range(2)]
        self._pending_streams: List[Stream] = []
        self._pending_ticks = 0
        self._batch_gather = None               # native gather (lazy)
        self._gather_dirty = True
        # First-class phase accounting: the serving claim ("host-side cost
        # per window") must be a measured artifact every bench run, not a
        # prose derivation.  Split per tick:
        #   gather        ring polls + window pops into the staging rows
        #   stage         padding/zeroing + per-row calibration staging
        #   dispatch      jnp.asarray (H2D entry) + async program launch
        #   resolve_fetch blocking device fetch of the previous labels
        #   resolve_log   per-stream TSV log appends
        # Host-side-only cost = gather + stage + resolve_log (what a
        # co-located deployment pays on the host per window; dispatch/fetch
        # ride the interconnect).  Two perf_counter calls per phase per
        # tick — noise next to ms-scale ticks.
        self.phase_seconds = {"gather": 0.0, "stage": 0.0, "dispatch": 0.0,
                              "resolve_fetch": 0.0, "resolve_log": 0.0}
        self.windows_resolved = 0
        self._build_program()

    def reset_phase_counters(self) -> None:
        for k in self.phase_seconds:
            self.phase_seconds[k] = 0.0
        self.windows_resolved = 0

    def host_side_seconds(self) -> float:
        """Host-only time accumulated since the last reset: gather + stage +
        log appends (dispatch H2D and the blocking label fetch excluded)."""
        p = self.phase_seconds
        return p["gather"] + p["stage"] + p["resolve_log"]

    @property
    def _pending(self) -> List[Stream]:
        # back-compat alias (tests/benchmarks peeked at the pending list)
        return self._pending_streams

    def _build_program(self):
        cfg = self.cfg
        use_speaker = self.kind == "speaker"
        use_webrtc = self._use_webrtc

        def head(variables, trimmed, n_out):
            if use_speaker:
                feats, _ = speaker_feature_batch(trimmed, n_out,
                                                 cfg.speaker_feature)
                logits = self.predictor.apply_model(variables, feats)
                silent = n_out < cfg.speaker_feature.silent_samples
            else:
                # trimmed is zero beyond n_out (preprocess_window contract)
                img = overlap_model_input(
                    trimmed[:, : cfg.overlap_feature.n_samples] / 32768.0,
                    cfg.overlap_feature)
                logits = self.predictor.apply_model(variables, img)
                silent = n_out < cfg.vad.silent_samples
            labels = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            return jnp.where(silent, -1, labels)

        def batch_fn(variables, raws, noise_threshs, vad_thrs):
            # same chain as the single-stream sessions (preprocess_window),
            # vmapped.  raws arrive int16 (half the H2D bytes); cast on
            # device.
            raws = raws.astype(jnp.float32)
            trimmed, n_out, _ = jax.vmap(
                lambda r, nt, vt: preprocess_window(r, nt, vt, cfg))(
                    raws, noise_threshs, vad_thrs)
            return head(variables, trimmed, n_out)

        def batch_fn_webrtc(variables, raws, noise_threshs, vad_thrs,
                            all_states, idx):
            # Gather the dispatched streams' detector rows (padded rows pass
            # an out-of-range index: the gather clamps — harmless, their
            # labels are discarded — and the scatter drops them).
            raws = raws.astype(jnp.float32)
            states = jax.tree_util.tree_map(lambda a: a[idx], all_states)
            trimmed, n_out, new_states = jax.vmap(
                lambda r, nt, vt, st: preprocess_window(
                    r, nt, vt, cfg, webrtc_state=st))(
                    raws, noise_threshs, vad_thrs, states)
            all_states = jax.tree_util.tree_map(
                lambda a, n: a.at[idx].set(n, mode="drop"),
                all_states, new_states)
            return head(variables, trimmed, n_out), all_states

        fn = batch_fn_webrtc if use_webrtc else batch_fn
        if self.mesh is not None:
            if use_webrtc:
                from mmla_audio_tpu.parallel import (replicate_tree,
                                                     shard_batch)

                jitted = jax.jit(fn)

                def program(variables, raws, nts, vts, all_states, idx):
                    # batch args shard on `data`; the stacked state (stream
                    # axis, not batch axis) replicates like the parameters
                    variables = replicate_tree(variables, self.mesh)
                    all_states = replicate_tree(all_states, self.mesh)
                    raws, nts, vts, idx = (shard_batch(x, self.mesh)
                                           for x in (raws, nts, vts, idx))
                    return jitted(variables, raws, nts, vts, all_states, idx)

                self._program = program
            else:
                from mmla_audio_tpu.parallel import DataParallel

                self._program = DataParallel(fn, self.mesh)
        else:
            self._program = jax.jit(fn)

    def _calibrate(self, noise_clip_i16: np.ndarray):
        """(noise_thresh, vad_threshold_db) for an ambient clip, cached by
        content digest: fleets of streams typically share one ambient
        profile, and the per-band threshold is a device round-trip per
        stream — admitting 1,024 streams paid 1,024 identical device calls
        before this cache.  The digest hashes the
        raw bytes (~50 us for a 10 s clip), so callers that reuse OR
        mutate-and-reuse a buffer both get correct results."""
        import hashlib

        from mmla_audio_tpu.vad import calibrate_threshold

        key = hashlib.sha1(noise_clip_i16.tobytes()).digest()
        hit = self._calib_cache.get(key)
        if hit is None:
            nf = noise_clip_i16.astype(np.float32) / 32768.0
            hit = (np.asarray(noise_threshold(jnp.asarray(nf),
                                              self.cfg.denoise)),
                   calibrate_threshold(noise_clip_i16,
                                       self.cfg.vad.aggressiveness))
            # bounded like every other host-side structure (the retention
            # policy above): distinct ambient profiles evict FIFO past 256
            # entries — re-deriving an evicted profile is just the original
            # cost, never a correctness issue
            if len(self._calib_cache) >= 256:
                self._calib_cache.pop(next(iter(self._calib_cache)))
            self._calib_cache[key] = hit
        return hit

    # -- stream management --------------------------------------------------------
    def add_stream(self, name: str, capture, noise_clip_i16: np.ndarray,
                   label_names: Optional[Dict[str, str]] = None,
                   now: Optional[datetime] = None) -> Stream:
        from mmla_audio_tpu.streaming.session import session_stamp

        log = SessionLog(self.dirs.logs / f"{session_stamp(now)}-{name}.txt",
                         kind=self.kind, start_index=1)
        noise_thresh, vad_db = self._calibrate(noise_clip_i16)
        row = self._claim_retired_row()
        stream = Stream(
            name, capture, log,
            noise_thresh=noise_thresh,
            vad_threshold_db=vad_db,
            label_names=label_names,
            index=len(self.streams) if row is None else row,
            results_cap=self.results_cap)
        if row is None:
            self.streams.append(stream)
        else:
            self.streams[row] = stream
            self._reset_webrtc_row(row)
        self._gather_dirty = True
        return stream

    def remove_stream(self, stream: Stream, close_log: bool = True,
                      archive: bool = True) -> None:
        """Retire a finished conversation.  The stream stops being gathered
        immediately; its slot (streams-list position, native-gather ring row,
        stacked webrtc-state row) is recycled by a future ``add_stream`` once
        no window of it is still pending or in flight — so a long-lived host
        serving arriving/ending conversations stays at its high-water stream
        count instead of growing without bound.  The Stream object (results,
        log path) stays valid; any in-flight window of it still resolves to
        its log.  ``archive=False`` additionally drops the Stream object at
        recycle time instead of keeping it in ``retired`` — the bounded-host
        policy for high-churn deployments where the TSV log is the record
        (the class docstring's retention policy).  The capture is the
        caller's to stop (the Multiplexer never owns producer threads).
        Idempotent (the first call's ``archive`` wins)."""
        if stream.retiring:
            return
        stream.retiring = True
        stream.archive = archive
        self._mark_done(stream)
        if close_log:
            stream.log.close()
        self._retiring.append(stream)
        self._gather_dirty = True

    def _claim_retired_row(self) -> Optional[int]:
        """Pop a recyclable row: a retiring stream none of whose windows are
        pending or in an unresolved dispatched batch (their webrtc-state
        scatter must land BEFORE the row is reset for the new stream).
        Archives or drops the Stream per its ``remove_stream`` policy."""
        inflight = self._inflight[0] if self._inflight is not None else ()
        for i, s in enumerate(self._retiring):
            if s not in self._pending_streams and s not in inflight:
                self._retiring.pop(i)
                if s.archive:
                    self.retired.append(s)
                return s.index
        return None

    def _reset_webrtc_row(self, row: int) -> None:
        """Fresh WebRtcVad_InitCore state for a recycled row (a new stream
        must behave exactly like a new ``Vad`` instance; rows at or past the
        current stacked length are covered by the next _ensure call)."""
        if self._webrtc_states is None or row >= self._webrtc_n:
            return
        from mmla_audio_tpu.vad.webrtc import webrtc_init

        fresh = webrtc_init((1,))
        self._webrtc_states = jax.tree_util.tree_map(
            lambda a, f: a.at[row].set(f[0]), self._webrtc_states, fresh)

    def _ensure_webrtc_states(self):
        """Grow the stacked device-side detector state to cover every
        stream (new streams start from WebRtcVad_InitCore, like a fresh
        ``Vad`` instance; existing adapted rows are preserved)."""
        from mmla_audio_tpu.vad.webrtc import webrtc_init

        n = len(self.streams)
        if self._webrtc_states is None:
            self._webrtc_states = webrtc_init((n,))
        elif self._webrtc_n < n:
            fresh = webrtc_init((n - self._webrtc_n,))
            self._webrtc_states = jax.tree_util.tree_map(
                lambda a, b: jnp.concatenate([a, b], axis=0),
                self._webrtc_states, fresh)
        self._webrtc_n = n

    def _label_name(self, stream: Stream, label: int) -> str:
        if label < 0:
            return "silent"
        if stream.label_names is not None:
            return stream.label_names.get(str(label), str(label))
        if self.kind == "overlap":
            return OVERLAP_LABELS[str(label)]
        return str(label)

    # -- serving loop ----------------------------------------------------------------
    def _ensure_gather(self):
        """(Re)build the native batch gather when the stream set changed.
        Falls back to the per-stream Python poll loop when any stream's ring
        is not the native SPSC ring (toolchain-less installs, raw sources)."""
        if not self._gather_dirty:
            return
        self._gather_dirty = False
        self._batch_gather = None
        try:
            from mmla_audio_tpu.streaming.native import (BatchGather,
                                                         NativeRingBuffer)

            rings = [getattr(s.capture, "ring", None) for s in self.streams]
            if rings and all(isinstance(r, NativeRingBuffer) for r in rings):
                self._batch_gather = BatchGather(rings)
                for s in self.streams:
                    self._batch_gather.set_active(s.index, not s.done)
        except (RuntimeError, ImportError):
            self._batch_gather = None
        if self._nts is None and self.streams:
            nt_shape = np.shape(self.streams[0].noise_thresh)
            self._nts = [np.zeros((self.bucket,) + nt_shape, np.float32)
                         for _ in range(2)]

    def _mark_done(self, stream: Stream) -> None:
        stream.done = True
        if self._batch_gather is not None:
            self._batch_gather.set_active(stream.index, False)

    def _sweep_done(self) -> None:
        """Flag streams whose producer drained with less than a window left
        (run on empty gathers — the only time it can change liveness)."""
        n_win = self.cfg.audio.window_samples
        for stream in self.streams:
            if stream.done:
                continue
            ring = getattr(stream.capture, "ring", None)
            # `drained` (producer pushed its final chunk) not
            # `source.exhausted` (which flips true BEFORE the last push and
            # would drop a complete buffered window)
            if ring is not None:
                if getattr(stream.capture, "drained", False) \
                        and ring.available < n_win:
                    ring.clear()
                    self._mark_done(stream)
            elif getattr(stream.capture.source, "exhausted", False):
                self._mark_done(stream)

    def _gather(self, limit: Optional[int] = None) -> List[Stream]:
        """Poll every stream once, non-blocking, starting at the rotating
        offset; gathered windows are written straight into rows
        ``[len(pending):]`` of the current fill buffer (native path: one
        ``rb_pop_batch`` call).  Returns the streams appended."""
        t0 = time.perf_counter()
        self._ensure_gather()
        n_win = self.cfg.audio.window_samples
        n = len(self.streams)
        limit = self.bucket if limit is None else limit
        if n == 0 or limit <= 0:
            return []
        buf = self._fill[self._flip]
        k0 = len(self._pending_streams)
        gathered: List[Stream] = []

        if self._batch_gather is not None:
            # webrtc busy-guard: a stream must not contribute two windows to
            # one batch (sequential detector state) — mask pending streams
            if self._use_webrtc:
                for s in self._pending_streams:
                    self._batch_gather.set_active(s.index, False)
            idx = self._batch_gather.pop_into(buf, k0, self._rr, limit, n_win)
            if self._use_webrtc:
                for s in self._pending_streams:
                    if not s.done:
                        self._batch_gather.set_active(s.index, True)
            nts, vts = self._nts[self._flip], self._vts[self._flip]
            for r, si in enumerate(idx):
                stream = self.streams[int(si)]
                gathered.append(stream)
                nts[k0 + r] = stream.noise_thresh
                vts[k0 + r] = stream.vad_threshold_db
            if not len(idx):
                self._sweep_done()
        else:
            busy = {id(s) for s in self._pending_streams} \
                if self._use_webrtc else ()
            for k in range(n):
                if len(gathered) >= limit:
                    break
                stream = self.streams[(self._rr + k) % n]
                if stream.done or id(stream) in busy:
                    continue
                ring = getattr(stream.capture, "ring", None)
                window = ring.pop(n_win) if ring is not None \
                    else stream.capture.read_window(n_win, timeout=0.0)
                if window is None:
                    continue
                r = k0 + len(gathered)
                buf[r] = window
                self._nts[self._flip][r] = stream.noise_thresh
                self._vts[self._flip][r] = stream.vad_threshold_db
                gathered.append(stream)
            if not gathered:
                self._sweep_done()
        self._rr = (self._rr + 1) % n
        self.phase_seconds["gather"] += time.perf_counter() - t0
        return gathered

    def _dispatch_staged(self):
        """Launch the staged pending rows as one device batch (async):
        zero-copy row-slice of the fill buffer into the smallest sufficient
        bucket, then flip buffers.  Returns (ready streams, device labels)."""
        t0 = time.perf_counter()
        ready = self._pending_streams
        k = len(ready)
        bucket = next((b for b in self.buckets if b >= k), self.bucket)
        buf = self._fill[self._flip]
        buf[k: bucket] = 0
        self._vts[self._flip][k: bucket] = 0.0
        if self._nts is not None:
            self._nts[self._flip][k: bucket] = 0.0
        idx = None
        if self._use_webrtc:
            self._ensure_webrtc_states()
            # padded rows index one past the last stream: the state gather
            # clamps (discarded) and the scatter drops
            idx = np.full((bucket,), self._webrtc_n, np.int32)
            for i, stream in enumerate(ready):
                idx[i] = stream.index
        t1 = time.perf_counter()
        self.phase_seconds["stage"] += t1 - t0
        raws = jnp.asarray(buf[:bucket])
        nts = jnp.asarray(self._nts[self._flip][:bucket])
        vts = jnp.asarray(self._vts[self._flip][:bucket])
        if self._use_webrtc:
            labels, self._webrtc_states = self._program(
                self.predictor.variables, raws, nts, vts,
                self._webrtc_states, jnp.asarray(idx))
        else:
            labels = self._program(self.predictor.variables, raws, nts, vts)
        self.phase_seconds["dispatch"] += time.perf_counter() - t1
        self._pending_streams = []
        self._pending_ticks = 0
        self._flip ^= 1
        return ready, labels

    def _resolve(self, inflight) -> int:
        """Fetch a dispatched batch's labels and write the per-stream logs."""
        ready, labels = inflight
        t0 = time.perf_counter()
        labels = np.asarray(labels)         # the one blocking device fetch
        t1 = time.perf_counter()
        self.phase_seconds["resolve_fetch"] += t1 - t0
        ts = datetime.today()
        for i, stream in enumerate(ready):
            name = self._label_name(stream, int(labels[i]))
            idx = stream.log.append(name, ts)
            stream.results.append((idx, name, ts))
        self.phase_seconds["resolve_log"] += time.perf_counter() - t1
        self.windows_resolved += len(ready)
        return len(ready)

    def _effective_min_fill(self) -> float:
        if self.min_fill is not None:
            return float(self.min_fill)
        # auto: accumulate once enough streams exist to fill the top bucket
        # (the measured eager-dispatch cliff), eager below that
        return 0.75 if len(self.streams) >= self.bucket else 0.0

    def tick(self) -> int:
        """One serving step: gather ready windows (non-blocking, straight
        into the staging rows), dispatch them, then resolve the PREVIOUS
        tick's batch — device compute for this tick overlaps the next
        gather.  Returns windows logged now.

        Dispatch fires when the top bucket is ``min_fill`` full, a tick
        gathers nothing new (arrival stall / end of streams), or the oldest
        pending window has waited ``max_pending_ticks`` ticks — bounding
        both padding waste at high stream counts and queueing latency under
        light-but-steady traffic, without deadlocking at end of streams."""
        new = self._gather(limit=self.bucket - len(self._pending_streams))
        self._pending_streams.extend(new)
        prev, self._inflight = self._inflight, None
        if self._pending_streams:
            self._pending_ticks += 1
            if (len(self._pending_streams)
                    >= self._effective_min_fill() * self.bucket
                    or not new
                    or self._pending_ticks >= self.max_pending_ticks):
                self._inflight = self._dispatch_staged()
        return self._resolve(prev) if prev is not None else 0

    def flush(self) -> int:
        """Resolve any in-flight batch and drain pending windows (call when
        the serving loop stops)."""
        total = 0
        prev, self._inflight = self._inflight, None
        if prev is not None:
            total += self._resolve(prev)
        while self._pending_streams:
            total += self._resolve(self._dispatch_staged())
        return total

    def run_until_exhausted(self, max_ticks: int = 100_000) -> int:
        """Drive replay/fake streams to completion; returns total decisions."""
        import time as _time

        total = 0
        idle = 0
        for _ in range(max_ticks):
            got = self.tick()
            total += got
            if got == 0 and self._inflight is None:
                if all(s.done for s in self.streams):
                    break
                idle += 1
                _time.sleep(min(0.001 * idle, 0.05))   # back off while empty
            else:
                idle = 0
        return total + self.flush()
