"""Quantify VAD decision parity against the bit-exact webrtcvad engine.

Since round 3 the repo carries the reference's actual per-frame detector
(`vad/webrtc.py`, bit-parity-pinned to the fixed-point transcription
golden), so agreement is now measured with webrtc as ground truth:

* **frame agreement** — fraction of 30 ms frame decisions matching webrtc;
* **label agreement** — fraction of *windows* whose final silent/voiced
  outcome (hysteresis collector -> trimmed length -> <4000-sample silent
  gate, the thing downstream labels depend on) matches webrtc's.

Both alternative detectors are scored: the calibrated energy default and
the float GMM approximation (`vad/gmm.py`), across SNRs and aggressiveness
modes 0-3.

Run:  python benchmarks/vad_agreement.py [--windows 100] [--json]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def synth_speech(n_samples, sr=16000, seed=0, n_tones=4, amp=0.3):
    """Same deterministic speech-like generator the test suite uses."""
    r = np.random.RandomState(seed)
    t = np.arange(n_samples) / sr
    y = np.zeros(n_samples)
    for _ in range(n_tones):
        f0 = r.uniform(80, 2000)
        drift = r.uniform(-30, 30)
        y += r.uniform(0.2, 1.0) * np.sin(
            2 * np.pi * (f0 + drift * t) * t + r.uniform(0, 6.28))
    y += 0.05 * r.randn(n_samples)
    y *= amp / np.max(np.abs(y))
    return y.astype(np.float32)


def measure(snrs=(20.0, 10.0, 5.0, 0.0, -5.0), n_windows=100,
            noise_rms=60.0, frame_len=480, n_win_samples=40960,
            aggressiveness=3, seed=0):
    import jax
    import jax.numpy as jnp

    from mmla_audio_tpu.vad import calibrate_threshold, energy_vad, vad_trim
    from mmla_audio_tpu.vad.collector import frame_count
    from mmla_audio_tpu.vad.gmm import gmm_init_from_noise, gmm_vad
    from mmla_audio_tpu.vad.webrtc import webrtc_init, webrtc_vad_frames

    rng = np.random.RandomState(seed)
    noise_clip = (rng.randn(160000) * noise_rms).astype(np.int16)
    thr_db = calibrate_threshold(noise_clip, aggressiveness)
    gmm_state = gmm_init_from_noise(noise_clip)
    T = frame_count(n_win_samples, frame_len)

    @jax.jit
    def run(x, wstate):
        frames = x[: T * frame_len].reshape(T, frame_len)
        d_energy = energy_vad(frames, jnp.asarray(thr_db, jnp.float32))
        d_gmm, _ = gmm_vad(x, gmm_state, aggressiveness=aggressiveness,
                           frame_len=frame_len)
        d_gmm = d_gmm[:T]
        d_web, wstate = webrtc_vad_frames(
            x[: T * frame_len].astype(jnp.int32), wstate,
            mode=aggressiveness, frame_len=frame_len)
        outs = {}
        for k, d in (("energy", d_energy), ("gmm", d_gmm), ("web", d_web)):
            _, outs[k] = vad_trim(x, jnp.asarray(x.shape[-1]), d, frame_len)
        return d_energy, d_gmm, d_web, outs["energy"], outs["gmm"], \
            outs["web"], wstate

    results = {}
    for snr in snrs:
        agree = {k: {"frame": [], "label": []} for k in ("energy", "gmm")}
        # long-lived webrtc detector across the windows of one SNR series,
        # like a session
        wstate = webrtc_init()
        for w in range(n_windows):
            noise = rng.randn(n_win_samples).astype(np.float32) * noise_rms
            if w % 2 == 0:     # speech window at the target SNR
                sp = synth_speech(n_win_samples, seed=1000 + w)
                sp_rms = float(np.sqrt(np.mean(sp ** 2)))
                gain = noise_rms * 10 ** (snr / 20.0) / max(sp_rms, 1e-9)
                # intermittent speech: zero out a random third of the window
                gaps = rng.rand(n_win_samples // 4800) < 0.33
                mask = np.repeat(~gaps, 4800).astype(np.float32)
                mask = np.pad(mask, (0, n_win_samples - len(mask)),
                              constant_values=1.0)
                x = sp * gain * mask + noise
            else:              # noise-only window
                x = noise
            d_e, d_g, d_w, n_e, n_g, n_w, wstate = run(jnp.asarray(x),
                                                       wstate)
            d_e, d_g, d_w, n_e, n_g, n_w = jax.device_get(
                (d_e, d_g, d_w, n_e, n_g, n_w))
            agree["energy"]["frame"].append(np.mean(d_e == d_w))
            agree["gmm"]["frame"].append(np.mean(d_g == d_w))
            agree["energy"]["label"].append((n_e < 4000) == (n_w < 4000))
            agree["gmm"]["label"].append((n_g < 4000) == (n_w < 4000))
        results[snr] = {
            "energy_vs_webrtc_frame": float(np.mean(agree["energy"]["frame"])),
            "energy_vs_webrtc_label": float(np.mean(agree["energy"]["label"])),
            "gmm_vs_webrtc_frame": float(np.mean(agree["gmm"]["frame"])),
            "gmm_vs_webrtc_label": float(np.mean(agree["gmm"]["label"])),
            "n_windows": n_windows,
        }
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=100)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--modes", type=int, nargs="*", default=[3, 2, 1, 0],
                    help="aggressiveness modes (first gets the full SNR "
                         "table; the rest a reduced sweep)")
    args = ap.parse_args()

    out = {}
    for i, mode in enumerate(args.modes):
        nw = args.windows if i == 0 else max(20, args.windows // 4)
        snrs = (20.0, 10.0, 5.0, 0.0, -5.0) if i == 0 else (20.0, 5.0, -5.0)
        out[mode] = measure(snrs=snrs, n_windows=nw, aggressiveness=mode)
    if args.json:
        print(json.dumps(out))
        return
    for mode, results in out.items():
        print(f"--- aggressiveness {mode} (vs bit-exact webrtc) ---")
        print(f"{'SNR dB':>8} {'energy frm':>11} {'energy lbl':>11} "
              f"{'gmm frm':>9} {'gmm lbl':>9}")
        for snr, r in results.items():
            print(f"{snr:8.1f} {r['energy_vs_webrtc_frame']:11.3f} "
                  f"{r['energy_vs_webrtc_label']:11.3f} "
                  f"{r['gmm_vs_webrtc_frame']:9.3f} "
                  f"{r['gmm_vs_webrtc_label']:9.3f}")


if __name__ == "__main__":
    main()
