"""Shared model building blocks in plain JAX.

A model is a frozen dataclass with ``init_variables`` and ``apply``; its
variables are nested dicts ``{"params": ..., "batch_stats": ...}`` whose
paths are the ones Flax linen produced for the same architecture
(``stage0_block0/Conv_0/kernel``,
``KerasBatchNorm_0/BatchNorm_0/{scale,bias}`` and ``{mean,var}``,
``BiLSTM_0/{forward,backward}/...``), so Keras/TF-bundle imports and saved
variables map 1:1.  Initial values and dropout masks are drawn from the same
keys Flax drew them from: a parameter's key is the root key folded with the
SHA-1 of its module path and its index within the module (``path_key``).

The BiLSTM is the only sequential op in either model; it is a ``lax.scan``
whose per-step work is a single (B, H) @ (H, 4H) GEMM — the input projection
for *all* timesteps is hoisted out of the scan into one (B*T, C) @ (C, 4H)
GEMM.  Gate order/activations match Keras LSTM (i, f, c, o; sigmoid
recurrent activation, tanh activation, unit forget bias) so weights trained
against the reference architecture transfer 1:1.

BatchNorm uses Keras defaults (momentum 0.99, eps 1e-3) with batch statistics
computed as Flax does (biased variance E[x²] − E[x]²) — the reference models
interleave BN through every residual block (`overlap_detector.py:227-256`,
`speaker_identification.py:168-190`).
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["leaky_relu", "path_key", "conv_init", "conv",
           "dense_init", "dense", "batch_norm_init", "batch_norm",
           "lstm_init", "lstm", "bilstm_init", "bilstm", "dropout",
           "max_pool", "avg_pool", "apply_variables"]

Tree = Dict[str, Any]

_glorot = jax.nn.initializers.glorot_uniform()
_orthogonal = jax.nn.initializers.orthogonal()


def leaky_relu(x, alpha: float = 0.3):
    """Keras LeakyReLU default alpha=0.3 (overlap_detector.py:386)."""
    return jnp.where(x >= 0, x, alpha * x)


def path_key(rng, path: Sequence[str], index: int):
    """Key of the ``index``-th (1-based) draw of the module at ``path``.

    The SHA-1 of the path names and the index, folded into ``rng`` — the
    derivation Flax linen uses, so initial values and dropout masks are the
    ones the Flax models produced from the same seed."""
    m = hashlib.sha1()
    for name in path:
        m.update(name.encode("utf-8"))
    m.update(index.to_bytes((index.bit_length() + 7) // 8, byteorder="big"))
    return jax.random.fold_in(rng, jnp.uint32(int.from_bytes(m.digest()[:4], "big")))


# -- convolution / dense ---------------------------------------------------------

def conv_init(rng, path, kernel_size: Tuple[int, ...], c_in: int, c_out: int) -> Tree:
    """Keras Conv default: glorot_uniform kernel (k..., C_in, C_out), zero bias."""
    kernel = _glorot(path_key(rng, path, 1), tuple(kernel_size) + (c_in, c_out))
    return {"kernel": kernel, "bias": jnp.zeros((c_out,), jnp.float32)}


def conv(p: Tree, x, strides: int = 1):
    """``SAME`` convolution, channels last (NWC/NHWC with WIO/HWIO kernels)."""
    k = p["kernel"]
    nd = x.ndim
    dn = lax.ConvDimensionNumbers((0, nd - 1) + tuple(range(1, nd - 1)),
                                  (nd - 1, nd - 2) + tuple(range(nd - 2)),
                                  (0, nd - 1) + tuple(range(1, nd - 1)))
    dtype = jnp.result_type(x, k, p["bias"])
    y = lax.conv_general_dilated(x.astype(dtype), k.astype(dtype),
                                 (strides,) * (nd - 2), "SAME",
                                 dimension_numbers=dn)
    return y + p["bias"].astype(dtype)


def dense_init(rng, path, c_in: int, c_out: int) -> Tree:
    kernel = _glorot(path_key(rng, path, 1), (c_in, c_out))
    return {"kernel": kernel, "bias": jnp.zeros((c_out,), jnp.float32)}


def dense(p: Tree, x):
    dtype = jnp.result_type(x, p["kernel"], p["bias"])
    y = lax.dot_general(x.astype(dtype), p["kernel"].astype(dtype),
                        (((x.ndim - 1,), (0,)), ((), ())))
    return y + p["bias"].astype(dtype)


# -- normalisation / pooling / dropout ------------------------------------------

def batch_norm_init(features: int) -> Tuple[Tree, Tree]:
    """(params, batch_stats) of one ``KerasBatchNorm_i`` node."""
    params = {"BatchNorm_0": {"scale": jnp.ones((features,), jnp.float32),
                              "bias": jnp.zeros((features,), jnp.float32)}}
    stats = {"BatchNorm_0": {"mean": jnp.zeros((features,), jnp.float32),
                             "var": jnp.ones((features,), jnp.float32)}}
    return params, stats


def batch_norm(p: Tree, s: Tree, x, train: bool, momentum: float, eps: float):
    """BatchNorm over the last axis.  Returns ``(y, new_stats)``: in training
    it normalises with the batch's mean and biased variance and moves the
    running stats by ``momentum``; otherwise it uses the running stats."""
    p, s = p["BatchNorm_0"], s["BatchNorm_0"]
    if train:
        axes = tuple(range(x.ndim - 1))
        xf = x.astype(jnp.promote_types(x.dtype, jnp.float32))
        mean = xf.mean(axes)
        var = jnp.maximum(0.0, (xf * xf).mean(axes) - mean * mean)
        s = {"mean": momentum * s["mean"] + (1 - momentum) * mean,
             "var": momentum * s["var"] + (1 - momentum) * var}
    else:
        mean, var = s["mean"], s["var"]
    y = (x - mean) * (lax.rsqrt(var + eps) * p["scale"]) + p["bias"]
    return y.astype(jnp.result_type(x, p["scale"], p["bias"])), {"BatchNorm_0": s}


def max_pool(x, window: int, strides: int):
    """``SAME`` max pool over every axis between batch and channels."""
    nsp = x.ndim - 2
    return lax.reduce_window(x, -jnp.inf, lax.max, (1,) + (window,) * nsp + (1,),
                             (1,) + (strides,) * nsp + (1,), "SAME")


def avg_pool(x, window: int):
    """Keras ``AveragePooling1D``: ``VALID``, stride = window."""
    nsp = x.ndim - 2
    dims = (1,) + (window,) * nsp + (1,)
    return lax.reduce_window(x, 0.0, lax.add, dims, dims, "VALID") / window ** nsp


def dropout(x, rate: float, rng, path):
    """Inverted dropout with the mask drawn from ``path``'s first key of the
    ``"dropout"`` stream; ``rng=None`` (inference) or ``rate == 0`` is a no-op."""
    if rng is None or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = jax.random.bernoulli(path_key(rng, path, 1), p=keep, shape=x.shape)
    return lax.select(mask, x / keep, jnp.zeros_like(x))


# -- recurrence ---------------------------------------------------------------------

def lstm_init(rng, path, c_in: int, units: int) -> Tree:
    """Keras LSTM inits: glorot kernel, orthogonal recurrent kernel, bias zero
    except the forget-gate slice = 1 (unit_forget_bias)."""
    H = units
    return {"kernel": _glorot(path_key(rng, path, 1), (c_in, 4 * H)),
            "recurrent_kernel": _orthogonal(path_key(rng, path, 2), (H, 4 * H)),
            "bias": jnp.zeros((4 * H,), jnp.float32).at[H: 2 * H].set(1.0)}


def lstm(p: Tree, x, reverse: bool = False):
    """Unidirectional LSTM over ``x (B, T, C)`` returning the last hidden
    state ``(B, H)`` (Keras ``LSTM(units)`` with return_sequences=False).

    ``reverse=True`` reproduces Keras ``go_backwards=True``: the sequence is
    consumed from t=T-1 down to t=0 and the final state (at t=0) is returned.
    """
    B = x.shape[0]
    rec_kernel = p["recurrent_kernel"]
    H = rec_kernel.shape[0]
    # Hoist the input projection out of the recurrence: one big GEMM.
    gates_x = jnp.einsum("btc,ch->bth", x, p["kernel"]) + p["bias"]  # (B, T, 4H)
    if reverse:
        gates_x = jnp.flip(gates_x, axis=1)
    gates_x = jnp.swapaxes(gates_x, 0, 1)                            # (T, B, 4H)

    def step(carry, gx):
        h, c = carry
        z = gx + h @ rec_kernel                                       # (B, 4H)
        i = jax.nn.sigmoid(z[:, :H])
        f = jax.nn.sigmoid(z[:, H: 2 * H])
        g = jnp.tanh(z[:, 2 * H: 3 * H])
        o = jax.nn.sigmoid(z[:, 3 * H:])
        c = f * c + i * g
        h = o * jnp.tanh(c)
        return (h, c), None

    init = (jnp.zeros((B, H), x.dtype), jnp.zeros((B, H), x.dtype))
    (h_last, _), _ = lax.scan(step, init, gates_x)
    return h_last


def bilstm_init(rng, path, c_in: int, units: int) -> Tree:
    path = tuple(path)
    return {"forward": lstm_init(rng, path + ("forward",), c_in, units),
            "backward": lstm_init(rng, path + ("backward",), c_in, units)}


def bilstm(p: Tree, x):
    """Keras ``Bidirectional(LSTM(units))`` with merge_mode='concat':
    forward last state ++ backward last state -> ``(B, 2 * units)``."""
    return jnp.concatenate([lstm(p["forward"], x),
                            lstm(p["backward"], x, reverse=True)], axis=-1)


# -- module protocol ------------------------------------------------------------------

def apply_variables(forward, variables: Tree, x, train: bool, rngs, mutable):
    """Run ``forward(params, batch_stats, x, train, dropout_rng)`` with the
    Flax ``apply`` calling convention: returns ``out``, or
    ``(out, {"batch_stats": new})`` when ``mutable`` names that collection."""
    stats = variables.get("batch_stats", {})
    rng = (rngs or {}).get("dropout") if train else None
    if train and stats and not mutable:
        raise ValueError("train=True updates batch_stats: pass "
                         "mutable=['batch_stats']")
    out, new_stats = forward(variables["params"], stats, x, train, rng)
    if mutable:
        return out, {"batch_stats": new_stats}
    return out

