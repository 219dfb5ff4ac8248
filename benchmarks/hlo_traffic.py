"""Per-op HBM-traffic audit of a compiled program's optimized HLO.

`compiled.cost_analysis()` gives one aggregate bytes-accessed number; this
tool attributes it: it parses the optimized HLO text and ranks ops by the
size of their operands + outputs — a crude but effective way to find layout
copies, unfused elementwise chains, and gather materializations (it is how
the denoise split-GEMM/window-folding/squared-mask restructure was found:
the frames tensor and its copies were ~1.5 GB/step of a 12 GB/step program;
the denoise second pass).

Caveats: sizes are logical shape bytes (padding/tiling not counted); fusion
internals are invisible (a fusion counts operands + outputs only, which is
exactly the HBM view); constants/parameters are skipped.

Usage:
  python benchmarks/hlo_traffic.py            # audits the denoise chain
  python benchmarks/hlo_traffic.py serve      # full serve chain
  python benchmarks/hlo_traffic.py model      # featurize+model step
"""

import re
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

B = 512

_DTYPE_BYTES = {"f64": 8, "f32": 4, "bf16": 2, "f16": 2, "s64": 8, "s32": 4,
                "s16": 2, "s8": 1, "u64": 8, "u32": 4, "u16": 2, "u8": 1,
                "pred": 1}


def shape_bytes(s: str) -> int:
    m = re.match(r"(\w+)\[([0-9,]*)\]", s)
    if not m or m.group(1) not in _DTYPE_BYTES:
        return 0
    p = _DTYPE_BYTES[m.group(1)]
    dims = m.group(2)
    for d in dims.split(","):
        if d:
            p *= int(d)
    return p


def audit(compiled, top: int = 30):
    """Rank the optimized HLO's ops by operand+output bytes; returns rows
    of (total_bytes, out_bytes, in_bytes, op, name, shape)."""
    rows = []
    for line in compiled.as_text().splitlines():
        line = line.strip()
        m = re.match(r"%?([\w.\-]+) = (\S+) (\w+)\(", line)
        if not m:
            continue
        name, shape, op = m.groups()
        if op in ("parameter", "constant", "get-tuple-element", "tuple",
                  "bitcast"):
            continue
        if shape.startswith("("):
            out_b = sum(shape_bytes(p)
                        for p in re.findall(r"(\w+\[[0-9,]*\])", shape))
        else:
            out_b = shape_bytes(shape)
        args = line[line.index("(") + 1:]
        in_b = sum(shape_bytes(s)
                   for s in re.findall(r"(\w+\[[0-9,]*\])", args))
        rows.append((out_b + in_b, out_b, in_b, op, name, shape[:60]))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    print(f"crude total: {total / 1e9:.2f} GB over {len(rows)} ops")
    for r in rows[:top]:
        print(f"{r[0] / 1e6:9.1f} MB  out={r[1] / 1e6:8.1f} "
              f"in={r[2] / 1e6:8.1f}  {r[3]:<12} {r[4][:50]:<50} {r[5]}")
    return rows


def main():
    import jax
    import jax.numpy as jnp

    from mmla_audio_tpu.core.config import PipelineConfig
    from mmla_audio_tpu.ops.denoise import (noise_threshold, quantize_i16,
                                            reduce_noise)

    which = sys.argv[1] if len(sys.argv) > 1 else "denoise"
    cfg = PipelineConfig()
    sr = cfg.audio.sample_rate
    n = cfg.audio.window_samples
    rng = np.random.RandomState(2)
    buf = jnp.asarray((rng.randn(B, n) * 3000).astype(np.float32))
    noise = (rng.randn(160000) * 20).astype(np.int16)
    nt1 = noise_threshold(
        jnp.asarray(noise.astype(np.float32) / 32768.0), cfg.denoise)

    if which == "denoise":
        def fn(b):
            def one(r):
                y = reduce_noise(r / 32768.0, nt1, cfg.denoise, sr=sr,
                                 passes=cfg.denoise.passes_live)
                return quantize_i16(y)
            return jax.vmap(one)(b)
    elif which == "serve":
        from mmla_audio_tpu.inference import OverlapPredictor
        from mmla_audio_tpu.models.overlap import OverlapResBLSTM
        from mmla_audio_tpu.ops.features import overlap_model_input
        from mmla_audio_tpu.streaming.session import preprocess_window

        variables = OverlapResBLSTM().init_variables(jax.random.PRNGKey(0))
        pred = OverlapPredictor(variables)
        nt = jnp.broadcast_to(nt1, (B,) + nt1.shape)
        vt = jnp.full((B,), 30.0, jnp.float32)

        def fn(b):
            trimmed, n_out, _ = jax.vmap(
                lambda r, nthr, vthr: preprocess_window(r, nthr, vthr, cfg))(
                b, nt, vt)
            img = overlap_model_input(
                trimmed[:, : cfg.overlap_feature.n_samples] / 32768.0,
                cfg.overlap_feature)
            return pred.apply_model(variables, img)
    elif which == "model":
        from mmla_audio_tpu.inference import OverlapPredictor
        from mmla_audio_tpu.models.overlap import OverlapResBLSTM

        variables = OverlapResBLSTM().init_variables(jax.random.PRNGKey(0))
        fwd = OverlapPredictor(variables).lower_fn()
        nn = jnp.full((B,), n, jnp.int32)

        def fn(b):
            return fwd(variables, b, nn)
    else:
        raise SystemExit(f"unknown target {which!r} "
                         "(denoise | serve | model)")

    compiled = jax.jit(fn).lower(buf).compile()
    audit(compiled)


if __name__ == "__main__":
    main()
