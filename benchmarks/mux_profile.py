"""Host-side phase profile of the Multiplexer serving loop.

The host-inclusive many-stream number can sit far below device batch
capacity — before optimizing, split one tick into its phases to see where
the time goes:

    gather   — per-stream ring polls + window pops (host Python/ctypes)
    stage    — copying windows + per-stream calibration into the batch
               staging buffers (host numpy)
    dispatch — jnp.asarray (H2D transfer of the staged batch) + async
               program launch
    resolve  — blocking device fetch of the previous batch's labels +
               per-stream TSV log appends

Usage: python benchmarks/mux_profile.py [--streams N] [--windows W]
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--streams", type=int, default=256)
    ap.add_argument("--windows", type=int, default=6,
                    help="windows per stream")
    ap.add_argument("--min-fill", type=float, default=0.75)
    ap.add_argument("--prefill", action="store_true",
                    help="prefill native rings instead of CaptureThreads "
                         "(GIL-free production; required >= 512 streams)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from mmla_audio_tpu.core.config import PipelineConfig
    from mmla_audio_tpu.inference import OverlapPredictor
    from mmla_audio_tpu.models.overlap import OverlapResBLSTM
    from mmla_audio_tpu.streaming.capture import ArraySource, CaptureThread
    from mmla_audio_tpu.streaming.multiplex import Multiplexer

    cfg = PipelineConfig()
    pred = OverlapPredictor(
        OverlapResBLSTM().init_variables(jax.random.PRNGKey(0)))
    noise = (np.random.RandomState(1).randn(160000) * 20).astype(np.int16)

    ticks = 0

    # phase accounting is first-class on the Multiplexer since round 4
    # (mux.phase_seconds: gather/stage/dispatch/resolve_fetch/resolve_log);
    # this profile just drives a loop and reads the counters
    n_win = cfg.audio.window_samples
    with tempfile.TemporaryDirectory() as root:
        mux = Multiplexer(pred, root, kind="overlap", bucket=args.streams,
                          min_fill=args.min_fill, cfg=cfg)
        caps = []
        from mmla_audio_tpu.streaming.capture import PrefilledCapture

        base = np.random.RandomState(0).randint(
            -3000, 3000, (args.windows + 2) * n_win).astype(np.int16)
        for s in range(args.streams):
            # share one base buffer: per-stream view keeps memory flat
            cap = PrefilledCapture(base) if args.prefill \
                else CaptureThread(ArraySource(base)).start()
            caps.append(cap)
            mux.add_stream(f"s{s}", cap, noise)
        # warm (compile) on the first two windows per stream
        warmed = 0
        deadline = time.time() + 300
        while warmed < 2 * args.streams and time.time() < deadline:
            warmed += mux.tick()
            if warmed == 0:
                time.sleep(0.005)
        mux.reset_phase_counters()
        t0 = time.perf_counter()
        n = 0
        while n < args.windows * args.streams - 2 * args.streams:
            got = mux.tick()
            ticks += 1
            if got == 0 and mux._inflight is None \
                    and all(s.done for s in mux.streams):
                break
            n += got
        n += mux.flush()
        dt = time.perf_counter() - t0
    for c in caps:
        c.stop()

    per_win = dt / max(n, 1) * 1e3
    ps = mux.phase_seconds
    out = {
        "metric": "mux_profile",
        "streams": args.streams,
        "windows": n,
        "ticks": ticks,
        "total_s": round(dt, 3),
        "per_window_ms": round(per_win, 3),
        **{f"{k}_ms_per_window": round(v / max(n, 1) * 1e3, 4)
           for k, v in ps.items()},
        "host_side_ms_per_window":
            round(mux.host_side_seconds() / max(n, 1) * 1e3, 4),
        "sustained_rt_streams": round(2.56 / (per_win / 1e3), 0),
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
