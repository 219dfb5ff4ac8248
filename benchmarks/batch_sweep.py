"""Sustained throughput sweep: batch size x dtype x precision.

Fills the measurement gaps left by bench.py's fixed B=512 headline:

  * overlap f32/bf16 at B in {512, 1024, 2048}  — does a bigger batch buy
    throughput per chip, or is the model already traffic-saturated?
  * speaker f32/bf16 at B=512                   — bench only records f32.
  * overlap strict (matmul_precision=highest) at B=512 — the docs quote the
    strict-parity cost at B=64 only.

Same K-chained lax.scan methodology as bench.py (one dispatch and one sync
amortised over K steps: the sustained rate).  Run on the card:
python benchmarks/batch_sweep.py
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

from benchmarks.timing import chained_step_seconds

WINDOW_SEC = 2.56
K = 32


def main():
    import jax
    import jax.numpy as jnp

    from mmla_audio_tpu.inference import OverlapPredictor, SpeakerPredictor
    from mmla_audio_tpu.models.overlap import OverlapResBLSTM
    from mmla_audio_tpu.models.speaker import SpeakerResBLSTM

    rng = np.random.RandomState(0)
    results = {"device": str(jax.devices()[0]), "K": K}

    ov = OverlapResBLSTM()
    ov_vars = ov.init_variables(jax.random.PRNGKey(0))
    n_samples = 40960
    for B in (512, 1024, 2048):
        buf = jnp.asarray((rng.randn(B, n_samples) * 3000).astype(np.float32))
        n = jnp.full((B,), n_samples, jnp.int32)
        for tag, kw in (("f32", {}), ("bf16", {"compute_dtype": jnp.bfloat16})):
            fwd = OverlapPredictor(ov_vars, **kw).lower_fn()
            s = chained_step_seconds(fwd, ov_vars, buf, n)
            rtf = B * WINDOW_SEC / s
            key = f"overlap_{tag}_b{B}"
            results[key] = {"step_ms": round(s * 1e3, 3),
                            "rtf": round(rtf, 1)}
            print(f"[sweep] {key}: {s*1e3:.2f} ms/step -> {rtf:,.0f}x RT",
                  file=sys.stderr, flush=True)

    # strict parity cost at serving batch
    B = 512
    buf = jnp.asarray((rng.randn(B, n_samples) * 3000).astype(np.float32))
    n = jnp.full((B,), n_samples, jnp.int32)
    fwd = OverlapPredictor(ov_vars, matmul_precision="highest").lower_fn()
    s = chained_step_seconds(fwd, ov_vars, buf, n)
    results["overlap_strict_b512"] = {"step_ms": round(s * 1e3, 3),
                                      "rtf": round(B * WINDOW_SEC / s, 1)}
    print(f"[sweep] overlap_strict_b512: {s*1e3:.2f} ms/step",
          file=sys.stderr, flush=True)

    sp = SpeakerResBLSTM()
    sp_vars = sp.init_variables(jax.random.PRNGKey(1))
    for tag, kw in (("f32", {}), ("bf16", {"compute_dtype": jnp.bfloat16})):
        fwd = SpeakerPredictor(sp_vars, **kw).lower_fn()
        s = chained_step_seconds(fwd, sp_vars, buf, n)
        rtf = B * WINDOW_SEC / s
        key = f"speaker_{tag}_b512"
        results[key] = {"step_ms": round(s * 1e3, 3), "rtf": round(rtf, 1)}
        print(f"[sweep] {key}: {s*1e3:.2f} ms/step -> {rtf:,.0f}x RT",
              file=sys.stderr, flush=True)

    print(json.dumps(results))


if __name__ == "__main__":
    main()
