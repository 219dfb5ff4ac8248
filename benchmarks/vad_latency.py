"""Single-window (B=1) serve latency per VAD decision mode.

Completes the VadConfig.decision default measurement:
the batched cost is in bench.py (`serve_step_ms_vad_*`); this measures the
single-stream session's fused program — where the webrtc engine's
sample-serial scans cannot amortize across a batch — against the <50 ms
p50 window-to-decision BASELINE target.

Usage: python benchmarks/vad_latency.py
"""

import dataclasses
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

K = 32


def main():
    import jax
    import jax.numpy as jnp

    from mmla_audio_tpu.core.config import PipelineConfig, VadConfig
    from mmla_audio_tpu.inference import OverlapPredictor
    from mmla_audio_tpu.models.overlap import OverlapResBLSTM
    from mmla_audio_tpu.ops.denoise import noise_threshold
    from mmla_audio_tpu.ops.features import overlap_model_input
    from mmla_audio_tpu.streaming.session import preprocess_window
    from mmla_audio_tpu.vad.gmm import gmm_init_from_noise
    from mmla_audio_tpu.vad.webrtc import webrtc_init

    variables = OverlapResBLSTM().init_variables(jax.random.PRNGKey(0))
    pred = OverlapPredictor(variables)
    rng = np.random.RandomState(2)
    n = 40960
    buf = jnp.asarray((rng.randn(n) * 3000).astype(np.float32))
    noise = (rng.randn(160000) * 20).astype(np.int16)
    nt = noise_threshold(jnp.asarray(noise.astype(np.float32) / 32768.0),
                         PipelineConfig().denoise)
    vt = jnp.asarray(30.0, jnp.float32)

    out = {"metric": "serve_latency_b1", "K": K,
           "device": str(jax.devices()[0])}
    for mode in ("energy", "gmm", "webrtc"):
        # gmm is a benchmark probe, not a VadConfig serving option:
        # preprocess_window selects the decision by which state operand is
        # passed, so the probe rides the energy cfg's frame geometry
        cfg = dataclasses.replace(
            PipelineConfig(),
            vad=VadConfig(decision=mode if mode != "gmm" else "energy"))
        gmm_state = gmm_init_from_noise(noise) if mode == "gmm" else None
        web_state = webrtc_init() if mode == "webrtc" else None

        @jax.jit
        def chained(variables, b, _cfg=cfg, _g=gmm_state, _w=web_state):
            def body(carry, _):
                trimmed, n_out, _st = preprocess_window(
                    carry, nt, vt, _cfg, gmm_state=_g, webrtc_state=_w)
                img = overlap_model_input(
                    trimmed[: _cfg.overlap_feature.n_samples] / 32768.0,
                    _cfg.overlap_feature)
                logits = pred.apply_model(variables, img[None])
                lab = jnp.argmax(logits[0]).astype(jnp.float32)
                return carry + lab * 1e-12, lab
            _, outs = jax.lax.scan(body, b, jnp.arange(K))
            return outs

        _ = np.asarray(chained(variables, buf)[-1])
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            _ = np.asarray(chained(variables, buf)[-1])
            times.append(time.perf_counter() - t0)
        ms = float(np.median(times)) / K * 1e3
        out[f"b1_step_ms_{mode}"] = round(ms, 3)
        print(f"[lat] {mode}: {ms:.2f} ms/window", file=sys.stderr,
              flush=True)

    # --- host-preprocess arrangement (webrtc): CPU denoise + native VAD +
    # CPU trim on the host, device runs features+model on the trimmed
    # window.  Host half timed as wall clock; device half as a K-chain on
    # pre-trimmed input; the sum is the single-stream latency (the
    # host-to-device upload of the window excluded: the default device path
    # pays the same per-window upload).
    try:
        from mmla_audio_tpu.streaming.hostpre import HostPreprocessor

        cfg = PipelineConfig()
        hp = HostPreprocessor(cfg, noise_thresh=np.asarray(nt))
        raw = np.asarray((rng.randn(n) * 3000).astype(np.float32))

        def host_chain():
            return hp.window(raw)

        host_chain()                                  # compile CPU programs
        reps = 20
        t0 = time.perf_counter()
        for _ in range(reps):
            trimmed, n_out = host_chain()
        host_ms = (time.perf_counter() - t0) / reps * 1e3

        # device half: predictor K-chain at B=1 on the trimmed window.
        # float32 buffer so the harness's `* 1e-12` carry bump is a real
        # inter-step dependency (int16 carry + `* 0` bump gets folded and
        # the forward hoists out of the scan — CLAUDE.md)
        from benchmarks.timing import chained_step_seconds
        buf1 = jnp.asarray(trimmed[None].astype(np.float32))
        n1 = jnp.asarray([max(n_out, 4000)], jnp.int32)
        dev_ms = chained_step_seconds(pred.lower_fn(), variables, buf1, n1,
                                      K=K) * 1e3
        out["b1_host_chain_ms"] = round(host_ms, 3)
        out["b1_device_step_ms"] = round(dev_ms, 3)
        out["b1_step_ms_webrtc_host"] = round(host_ms + dev_ms, 3)
        print(f"[lat] webrtc host-preprocess: host {host_ms:.2f} + device "
              f"{dev_ms:.2f} = {host_ms + dev_ms:.2f} ms/window",
              file=sys.stderr, flush=True)
    except Exception as e:                # noqa: BLE001
        print(f"[lat] WARNING host-preprocess axis failed: "
              f"{type(e).__name__}: {e}", file=sys.stderr, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
