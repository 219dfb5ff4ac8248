"""Label parity: the same f32 program on the GPU vs the host CPU backend.

The parity configuration (f32 activations, HIGHEST-precision DSP GEMMs)
exists so that GPU serving produces the same labels as a reference-faithful
CPU run.  This harness runs the full fused window->label program for both
overlap detection and speaker ID on a mixed bag of synthetic windows
(speech-like harmonics, noise, near-silence, clipping) on BOTH backends of
the same process and reports label agreement and probability drift, for the
backend's default precision (TF32 dots/convs on an H100) and for "highest"
(true FP32).  ``chip_smoke.py`` phase 4 makes the same comparison on the
speech-like source as a pass/fail check.

Run on a machine with the card:  python benchmarks/gpu_cpu_parity.py
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np
import jax
import jax.numpy as jnp

from mmla_audio_tpu.inference import OverlapPredictor, SpeakerPredictor
from mmla_audio_tpu.models.overlap import OverlapResBLSTM
from mmla_audio_tpu.models.speaker import SpeakerResBLSTM

B = 64
N = 40960
SR = 16000


def make_windows(rng):
    buf = np.zeros((B, N), np.float32)
    n = np.zeros((B,), np.int32)
    t = np.arange(N) / SR
    for i in range(B):
        kind = i % 4
        if kind == 0:        # speech-like harmonic stack with AM
            f0 = 90 + 30 * rng.rand()
            sig = sum(np.sin(2 * np.pi * f0 * k * t + rng.rand() * 6)
                      / k for k in range(1, 9))
            sig *= 0.5 * (1 + np.sin(2 * np.pi * 3.1 * t))
            sig = sig * 6000 + rng.randn(N) * 120
            n[i] = N
        elif kind == 1:      # broadband noise
            sig = rng.randn(N) * 2500
            n[i] = N
        elif kind == 2:      # near-silence (below the 4000-sample gate)
            sig = rng.randn(N) * 30
            n[i] = 2000
        else:                # loud clipped tone burst
            sig = np.clip(np.sin(2 * np.pi * 440 * t) * 40000, -32768, 32767)
            sig[: N // 2] = rng.randn(N // 2) * 500
            n[i] = N - 3000
        buf[i] = np.clip(sig, -32768, 32767)
    return buf.astype(np.float32), n


def run_on(device, fwd, variables, buf, n):
    """``fwd`` on ``device``: the arguments are committed to it."""
    v, b, m = jax.device_put((variables, jnp.asarray(buf), jnp.asarray(n)),
                             device)
    labels, probs = jax.jit(fwd)(v, b, m)
    return np.asarray(labels), np.asarray(probs)


def chained_step_ms(fwd, variables, buf, n, K=32):
    """Sustained per-step ms on the default device (canonical K-chained
    harness; see benchmarks/timing.py)."""
    from benchmarks.timing import chained_step_seconds

    return chained_step_seconds(fwd, variables, buf, n, K=K) * 1e3


def compare(name, model, pred_cls, buf, n, seed):
    variables = model.init_variables(jax.random.PRNGKey(seed))
    cpu = jax.devices("cpu")[0]
    acc = jax.devices()[0]
    out = {}
    for mode, precision in (("default", None), ("strict", "highest")):
        fwd = pred_cls(variables, matmul_precision=precision).lower_fn()
        l_cpu, p_cpu = run_on(cpu, fwd, variables, buf, n)
        l_gpu, p_gpu = run_on(acc, fwd, variables, buf, n)
        agree = float(np.mean(l_cpu == l_gpu))
        drift = float(np.max(np.abs(p_cpu - p_gpu)))
        step_ms = chained_step_ms(fwd, variables, buf, n)
        print(f"{name}/{mode}: label agreement {agree:.4f}, "
              f"max prob drift {drift:.2e}, step {step_ms:.2f} ms (B={B})")
        out[mode] = {"label_agreement": agree, "max_prob_drift": drift,
                     "step_ms": step_ms,
                     "labels_cpu": np.bincount(l_cpu + 1).tolist()}
    return out


def main():
    from mmla_audio_tpu.utils.device import require_gpu

    dev = require_gpu()
    rng = np.random.RandomState(0)
    buf, n = make_windows(rng)
    out = {"B": B, "device": {"platform": dev.platform,
                              "kind": dev.device_kind}}
    out["overlap"] = compare("overlap", OverlapResBLSTM(), OverlapPredictor,
                             buf, n, 0)
    out["speaker"] = compare("speaker", SpeakerResBLSTM(), SpeakerPredictor,
                             buf, n, 1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
