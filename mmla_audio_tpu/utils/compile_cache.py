"""Persistent XLA compilation cache for fast process restarts.

The reference pays Keras model-build + TF graph time on every script start
(`overlap_detector_run.py:21-40` loads and rebuilds per run); here the
analogous cost is XLA compilation of the serve, registration and training
programs.  JAX's persistent compilation cache stores the serialized compiled
executable keyed by (HLO, flags, device kind), so a *restarted* process —
the deployment story for the streaming runners, which are long-lived but do
get restarted — skips straight past compilation.

Where the cache lives (``compile_cache_dir``):
- ``off`` disables it;
- ``$JAX_COMPILATION_CACHE_DIR``, when set, is the directory, whatever else
  is asked for: no other directory is set in code;
- else an explicit directory (``--compile-cache DIR``);
- else ``<checkout>/.jax_cache``, a fixed path resolved from the package
  location (ignored by git).  The path is part of what a later process must
  find again, so it never depends on a temp dir, a pid or the time.

Failures (read-only dir, unsupported backend serialization) are non-fatal
(``jax_raise_persistent_cache_errors=False`` is JAX's default): enabling the
cache can never break serving, only skip the speedup.  The cache must be
configured before the first compilation, not before backend init.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

__all__ = ["DEFAULT_DIR", "ENV_DIR", "compile_cache_dir", "enable_compile_cache"]

ENV_DIR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir(flag: str | os.PathLike | None = None) -> Path | None:
    """Resolve the cache directory: ``flag == "off"`` -> ``None``;
    ``$JAX_COMPILATION_CACHE_DIR`` -> that; ``flag`` -> ``Path(flag)``;
    else ``DEFAULT_DIR``."""
    if flag is not None and str(flag) == "off":
        return None
    env = os.environ.get(ENV_DIR)
    if env:
        return Path(env)
    return Path(flag) if flag is not None else DEFAULT_DIR


def enable_compile_cache(flag: str | os.PathLike | None = None, *,
                         min_compile_seconds: float = 1.0,
                         min_entry_bytes: int = 0) -> Path | None:
    """Turn JAX's persistent compilation cache on at
    ``compile_cache_dir(flag)`` (created if missing), or off for ``"off"``.
    Returns the directory in use, or ``None`` when disabled.  Idempotent;
    call any time before the program of interest first compiles.  An
    uncreatable or unwritable directory warns and returns ``None``."""
    import jax

    path = compile_cache_dir(flag)
    if path is None:
        jax.config.update("jax_enable_compilation_cache", False)
        return None
    try:
        path.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        print(f"[WARN] compile cache disabled: cannot create {path}: {e}",
              file=sys.stderr)
        return None
    if not os.access(path, os.W_OK):
        # mkdir(exist_ok=True) passes silently on a pre-existing read-only
        # dir; without this check the cache would be "enabled" against a
        # directory JAX can never write
        print(f"[WARN] compile cache disabled: {path} is not writable",
              file=sys.stderr)
        return None
    jax.config.update("jax_enable_compilation_cache", True)
    jax.config.update("jax_compilation_cache_dir", str(path))
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_seconds))
    jax.config.update("jax_persistent_cache_min_entry_size_bytes",
                      int(min_entry_bytes))
    return path
