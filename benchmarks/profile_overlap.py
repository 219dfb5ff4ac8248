"""Per-component timing of the overlap serving step at batch 512 on the card.

Breaks the 2.56 s-window -> label step into its pieces so optimization
effort goes where the milliseconds are:

  dsp_f32        masked-prefix -> feature image (HIGHEST-precision DFT GEMMs)
  dsp_default    same with default precision (TF32 on an H100)
  model_f32      feature image -> logits, f32 params
  model_bf16     same with bf16 compute
  model_f32_bnfold   f32 with inference-BN folded into the preceding convs
  full_f32       the production fused program (reference parity config)

Methodology: K steps chained in one lax.scan with a data dependency, one
4-byte host fetch, median of 3 (see bench.py).
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

B = 512
K = 8


def _measure(fn, *args):
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chained(*a):
        def body(carry, _):
            out = fn(carry, *a[1:])
            bump = jnp.real(jax.tree_util.tree_leaves(out)[0]).sum()
            return carry + bump.astype(carry.dtype) * 1e-12, \
                jax.tree_util.tree_leaves(out)[0].ravel()[0]
        _, outs = jax.lax.scan(body, a[0], jnp.arange(K))
        return outs

    out = chained(*args)
    _ = np.asarray(out[-1])
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = chained(*args)
        _ = np.asarray(out[-1])
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) / K


def fold_inference_bn(variables, cfg):
    """Fold each block's post-conv BatchNorm (the BN that directly follows
    Conv_0 / conv3x3) into that conv's kernel+bias for inference.

    conv -> BN(affine a,b) == conv' with kernel*a (per out-channel) and
    bias*a + b.  Only BNs whose input is a conv output fold; the
    pre-activation BNs (applied to the residual sum) cannot.  NOTE: this
    changes the variable tree shape contract (the folded BN becomes
    identity), so it is implemented here as a *parameter transform* that
    keeps the tree intact: BN scale:=1, bias:=0, mean:=0, var:=1-eps.
    """
    import copy

    p = copy.deepcopy(jax_tree_to_np(variables["params"]))
    s = copy.deepcopy(jax_tree_to_np(variables["batch_stats"]))
    for name, blk in p.items():
        if not isinstance(blk, dict) or "Conv_0" not in blk:
            continue
        bn_p = blk["KerasBatchNorm_1"]["BatchNorm_0"]
        bn_s = s[name]["KerasBatchNorm_1"]["BatchNorm_0"]
        gamma, beta = bn_p["scale"], bn_p["bias"]
        mean, var = bn_s["mean"], bn_s["var"]
        eps = cfg.bn_eps
        a = gamma / np.sqrt(var + eps)
        b = beta - mean * a
        blk["Conv_0"]["kernel"] = blk["Conv_0"]["kernel"] * a
        blk["Conv_0"]["bias"] = blk["Conv_0"]["bias"] * a + b
        bn_p["scale"] = np.ones_like(gamma)
        bn_p["bias"] = np.zeros_like(beta)
        bn_s["mean"] = np.zeros_like(mean)
        bn_s["var"] = np.ones_like(var) - eps
    return {"params": p, "batch_stats": s}


def jax_tree_to_np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def main():
    import jax
    import jax.numpy as jnp

    from mmla_audio_tpu.core.config import (
        AudioConfig,
        OverlapFeatureConfig,
        OverlapModelConfig,
    )
    from mmla_audio_tpu.inference import OverlapPredictor
    from mmla_audio_tpu.models.overlap import OverlapResBLSTM
    from mmla_audio_tpu.ops.features import overlap_model_input

    audio = AudioConfig()
    n_samples = audio.window_samples
    fcfg = OverlapFeatureConfig()
    mcfg = OverlapModelConfig()
    model = OverlapResBLSTM(mcfg)
    variables = model.init_variables(jax.random.PRNGKey(0))

    rng = np.random.RandomState(0)
    buf = jnp.asarray((rng.randn(B, n_samples) * 3000).astype(np.float32))
    n = jnp.full((B,), n_samples, jnp.int32)
    img = jnp.asarray(
        (rng.rand(B, 128, 151, 3) * 255).astype(np.float32))

    out = {"batch": B, "device": str(jax.devices()[0])}

    def dsp(b, n):
        y = jnp.where(jnp.arange(n_samples) < n[:, None], b, 0.0)
        return overlap_model_input(y[:, : fcfg.n_samples] / 32768.0, fcfg)

    out["dsp_f32_ms"] = round(_measure(dsp, buf, n) * 1e3, 3)
    print("[profile] dsp_f32", out["dsp_f32_ms"], file=sys.stderr, flush=True)

    import dataclasses
    fcfg_def = dataclasses.replace(fcfg, precision="default") \
        if hasattr(fcfg, "precision") else None
    if fcfg_def is not None:
        def dsp_def(b, n):
            y = jnp.where(jnp.arange(n_samples) < n[:, None], b, 0.0)
            return overlap_model_input(y[:, : fcfg.n_samples] / 32768.0,
                                       fcfg_def)
        out["dsp_default_ms"] = round(_measure(dsp_def, buf, n) * 1e3, 3)
        print("[profile] dsp_default", out["dsp_default_ms"],
              file=sys.stderr, flush=True)

    def model_f32(im):
        return model.apply(variables, im)

    out["model_f32_ms"] = round(_measure(model_f32, img) * 1e3, 3)
    print("[profile] model_f32", out["model_f32_ms"],
          file=sys.stderr, flush=True)

    bf16_vars = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.bfloat16)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, variables)

    def model_bf16(im):
        return model.apply(bf16_vars, im.astype(jnp.bfloat16)
                           ).astype(jnp.float32)

    out["model_bf16_ms"] = round(_measure(model_bf16, img) * 1e3, 3)
    print("[profile] model_bf16", out["model_bf16_ms"],
          file=sys.stderr, flush=True)

    folded = fold_inference_bn(variables, mcfg)
    folded = jax.tree_util.tree_map(jnp.asarray, folded)

    def model_fold(im):
        return model.apply(folded, im)

    # numerical sanity on a small slice before timing
    ref = np.asarray(model.apply(variables, img[:4]))
    got = np.asarray(model.apply(folded, img[:4]))
    out["bnfold_max_abs_diff"] = float(np.abs(ref - got).max())
    out["model_f32_bnfold_ms"] = round(_measure(model_fold, img) * 1e3, 3)
    print("[profile] model_f32_bnfold", out["model_f32_bnfold_ms"],
          "maxdiff", out["bnfold_max_abs_diff"], file=sys.stderr, flush=True)

    pred = OverlapPredictor(variables)
    fwd = pred.lower_fn()

    def full(b, n):
        return fwd(variables, b, n)

    out["full_f32_ms"] = round(_measure(full, buf, n) * 1e3, 3)
    print("[profile] full_f32", out["full_f32_ms"],
          file=sys.stderr, flush=True)

    print(json.dumps(out))


if __name__ == "__main__":
    main()
