"""Stage-level profile of the denoise chain at b512 — the pre-decision
serve chain (denoise -> VAD -> trim) measured ~10x the model step before
the r3 rewrites (bench_vad_modes: 292.8 ms vs batch_step 26.9 ms at b512),
and denoise is its only heavy stage.  Break it down:

  stft       forward DFT GEMMs (split-GEMM framing on hop-strided views)
  mask       squared-magnitude threshold + banded-GEMM smoothing
  istft      window-folded inverse sub-GEMMs + shifted-pad overlap-add
  full       whole reduce_noise pass

Each timed as a K-chained jitted scan (benchmarks/timing.py).
Stage history (measured): mask as a C_in=1 33x7 spatial conv 215.7 ms ->
banded GEMMs 5.4; overlap-add as .at[idx].add scatter 20.6 -> shifted-pad
sums ~0 (fused); full chain 265.7 -> 25.0 -> 20.0 ms after the split-GEMM
framing / window-folded bases / squared-magnitude mask second pass
(benchmarks/serve_roofline.py has the roofline accounting).
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

B = 512
K = 16


def main():
    import jax
    import jax.numpy as jnp

    from mmla_audio_tpu.core.config import DenoiseConfig, PipelineConfig
    from mmla_audio_tpu.ops import denoise as dn

    cfg = DenoiseConfig()
    sr = 16000
    n = 40960
    rng = np.random.RandomState(2)
    y = jnp.asarray((rng.randn(B, n) * 0.1).astype(np.float32))
    noise = jnp.asarray((rng.randn(160000) * 0.01).astype(np.float32))
    nt = dn.noise_threshold(noise, cfg)
    filt = jnp.asarray(dn.smoothing_filter(
        sr, cfg.n_fft, cfg.hop_length, cfg.freq_mask_smooth_hz,
        cfg.time_mask_smooth_ms))

    pad_cfg = [(0, 0), (dn._chunk_pad(cfg, sr), dn._chunk_pad(cfg, sr))]

    def stft_stage(yy):
        yp = jnp.pad(yy, pad_cfg)
        re, im = dn._stft_ri(yp, cfg.n_fft, cfg.hop_length)
        return re, im

    def mask_stage(re, im):
        # the production gate (dn.gate_mask: squared-magnitude domain, no
        # abs/sqrt/log materializations) + banded-GEMM smoothing (the
        # C_in=1 conv2d smoothing form measured 215.7 ms here)
        v_f, v_t = dn._smoothing_factors(
            sr, cfg.n_fft, cfg.hop_length, cfg.freq_mask_smooth_hz,
            cfg.time_mask_smooth_ms)
        mask = dn.gate_mask(re, im, nt, cfg.prop_decrease)
        mf = jnp.asarray(dn._band_matrix(v_f, mask.shape[-1]))
        mt_t = jnp.asarray(dn._band_matrix(v_t, mask.shape[-2]).T)
        sm = jnp.matmul(mask, mf, preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)
        sm = jnp.matmul(mt_t, sm, preferred_element_type=jnp.float32,
                        precision=jax.lax.Precision.HIGHEST)
        return sm

    def istft_stage(re, im):
        # the production inverse: window-folded hop-block sub-GEMMs emit the
        # overlap-add parts directly (no inverse-frames tensor / window
        # multiply / scatter — the .at[idx].add form measured 20.6 ms here)
        return dn._istft(re, im, cfg.n_fft, cfg.hop_length,
                         re.shape[-2] * cfg.hop_length)

    def timed(name, fn, *args):
        @jax.jit
        def chained(*a):
            def body(carry, _):
                out = fn(carry, *a[1:])
                lead = out[0] if isinstance(out, tuple) else out
                # REAL inter-step dependency: a `* 0` bump is folded away and
                # XLA hoists the body out of the scan (a `* 0` carry is folded)
                bump = jnp.sum(lead).astype(carry.dtype) * 1e-12
                return carry + bump, None
            c, _ = jax.lax.scan(body, a[0], jnp.arange(K))
            return c
        out = chained(*args)
        np.asarray(out.ravel()[:1])
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            out = chained(*args)
            np.asarray(out.ravel()[:1])
            times.append(time.perf_counter() - t0)
        ms = float(np.min(times)) / K * 1e3
        print(f"[dn] {name}: {ms:.2f} ms", file=sys.stderr, flush=True)
        return ms

    re, im = stft_stage(y)
    re, im = jax.block_until_ready(re), jax.block_until_ready(im)

    out = {"metric": "denoise_profile_b512", "K": K}
    out["stft_ms"] = round(timed("stft", lambda yy: stft_stage(yy)[0], y), 2)
    out["mask_ms"] = round(timed(
        "mask", lambda r, i: mask_stage(r, i), re, im), 2)
    out["istft_ms"] = round(timed(
        "istft", lambda r, i: istft_stage(r, i), re, im), 2)
    out["full_ms"] = round(timed(
        "full", lambda yy: dn.reduce_noise(yy, nt, cfg, sr=sr), y), 2)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
