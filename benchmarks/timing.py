"""Canonical K-chained timing harness for device benchmarks.

Chain K steps inside ONE jitted `lax.scan`, with a REAL data dependency
between steps (carry perturbed by each step's output — a `* 0` carry lets
XLA hoist the body out of the loop and time nothing), and sync once on a
4-byte fetch: one dispatch and one sync are amortised over K steps.

`bench.py` at the repo root keeps a deliberate inline copy of this loop so
the driver-run benchmark stays hermetic; if the methodology changes, update
both.
"""

import time

import numpy as np


def chained_step_seconds(fwd, variables, buf, n, K: int = 32, reps: int = 3):
    """Median sustained seconds per step of ``fwd(variables, buf, n) ->
    (labels, aux)`` on the default device."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chained(variables, buf, n):
        def body(carry, _):
            labels, _aux = fwd(variables, carry, n)
            # data dependency between steps prevents loop hoisting
            return carry + labels.sum().astype(carry.dtype) * 1e-12, labels[0]
        _, outs = jax.lax.scan(body, buf, jnp.arange(K))
        return outs

    bufj, nj = jnp.asarray(buf), jnp.asarray(n)
    _ = np.asarray(chained(variables, bufj, nj)[-1])      # compile + warm
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _ = np.asarray(chained(variables, bufj, nj)[-1])  # 4-byte sync
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) / K
