"""Test harness: force an 8-device virtual CPU mesh before JAX initializes.

The tests run on the CPU (``JAX_PLATFORMS=cpu python -m pytest tests/``);
sharding/collective tests run on ``--xla_force_host_platform_device_count=8``
exactly as ``__graft_entry__.dryrun_multichip`` does.  The card itself is
exercised by ``python chip_smoke.py``; a test that needs it carries the
``gpu`` marker and decides in a fixture, never at import, that it skips.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

# cli.main turns the persistent compilation cache on in-process; give each
# test worker a directory of its own (set after jax's import, so the cache
# stays off until a test turns it on) instead of the checkout's .jax_cache.
import tempfile

os.environ["JAX_COMPILATION_CACHE_DIR"] = tempfile.mkdtemp(
    prefix="mmla-test-jax-cache-")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.RandomState(0)


def synth_speech(n_samples, sr=16000, seed=0, n_tones=4, amp=0.3):
    """Deterministic speech-like PCM: a sum of drifting tones + noise bursts."""
    r = np.random.RandomState(seed)
    t = np.arange(n_samples) / sr
    y = np.zeros(n_samples)
    for _ in range(n_tones):
        f0 = r.uniform(80, 2000)
        drift = r.uniform(-30, 30)
        y += r.uniform(0.2, 1.0) * np.sin(2 * np.pi * (f0 + drift * t) * t + r.uniform(0, 6.28))
    y += 0.05 * r.randn(n_samples)
    y *= amp / np.max(np.abs(y))
    return y.astype(np.float32)


def synth_speech_i16(n_samples, sr=16000, seed=0):
    return (synth_speech(n_samples, sr, seed) * 20000).astype(np.int16)
