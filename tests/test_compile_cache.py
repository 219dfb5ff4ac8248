"""Persistent compilation cache: resolution policy + a real cross-process
hit (the deployment story: a restarted streaming runner must skip its cold
compile; jax keys entries by device kind, so the CPU proof here carries to
the GPU path unchanged)."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_CHILD = r"""
import sys
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
from mmla_audio_tpu.utils.compile_cache import enable_compile_cache
enable_compile_cache({cache!r}, min_compile_seconds=0.0)

hits = []
import jax.monitoring
jax.monitoring.register_event_listener(
    lambda name, **kw: hits.append(name)
    if name == "/jax/compilation_cache/cache_hits" else None)

import jax.numpy as jnp
out = jax.jit(lambda x: jnp.tanh(x @ x).sum())(jnp.ones((64, 64)))
print("RESULT", float(out), "HITS", len(hits))
"""


def _run(cache, env_extra=None):
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_extra or {})
    out = subprocess.run(
        [sys.executable, "-c",
         _CHILD.format(repo=str(REPO), cache=str(cache))],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("RESULT")][-1]
    _, val, _, hits = line.split()
    return float(val), int(hits)


def test_cross_process_cache_hit(tmp_path):
    cache = tmp_path / "xla_cache"
    val1, hits1 = _run(cache)
    assert cache.is_dir() and any(cache.iterdir()), "cache never populated"
    val2, hits2 = _run(cache)
    assert val2 == val1
    assert hits2 >= 1, "second process recompiled instead of hitting cache"


def test_cache_dir_resolution(tmp_path, monkeypatch):
    """'off' > $JAX_COMPILATION_CACHE_DIR > explicit DIR > <checkout>/.jax_cache."""
    from mmla_audio_tpu.utils.compile_cache import DEFAULT_DIR, compile_cache_dir

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache_dir(None) == DEFAULT_DIR == REPO / ".jax_cache"
    assert compile_cache_dir(tmp_path / "x") == tmp_path / "x"
    assert compile_cache_dir("off") is None
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    assert compile_cache_dir(None) == tmp_path / "env"
    assert compile_cache_dir(tmp_path / "x") == tmp_path / "env"
    assert compile_cache_dir("off") is None


def test_cli_flag_resolution(tmp_path, monkeypatch):
    """cli.main turns the cache on with no flag (the fixed default path or
    the env variable); --compile-cache DIR|off is passed through."""
    import argparse

    from mmla_audio_tpu import cli

    seen = []
    monkeypatch.setattr(
        "mmla_audio_tpu.utils.compile_cache.enable_compile_cache",
        lambda flag=None, **kw: seen.append(flag))
    for flag in (None, "off", str(tmp_path / "explicit")):
        cli._setup_compile_cache(argparse.Namespace(compile_cache=flag))
    cli._setup_compile_cache(argparse.Namespace())
    assert seen == [None, "off", str(tmp_path / "explicit"), None]


def _record_config(monkeypatch):
    import jax

    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    return calls


def test_env_dir_is_honoured_and_never_overridden(tmp_path, monkeypatch):
    """With $JAX_COMPILATION_CACHE_DIR set, that directory is the cache:
    no other directory is set in code, even when one is passed."""
    from mmla_audio_tpu.utils.compile_cache import enable_compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    calls = _record_config(monkeypatch)
    got = enable_compile_cache(tmp_path / "explicit")
    assert got == tmp_path / "env" and got.is_dir()
    assert calls["jax_enable_compilation_cache"] is True
    assert calls["jax_compilation_cache_dir"] == str(tmp_path / "env")


def test_off_disables_cache(monkeypatch):
    from mmla_audio_tpu.utils.compile_cache import enable_compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/nonexistent/never-made")
    calls = _record_config(monkeypatch)
    assert enable_compile_cache("off") is None
    assert calls == {"jax_enable_compilation_cache": False}


def test_default_dir_is_used(monkeypatch):
    from mmla_audio_tpu.utils import compile_cache as cc

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_config(monkeypatch)
    assert cc.enable_compile_cache() == REPO / ".jax_cache"
    assert calls["jax_compilation_cache_dir"] == str(REPO / ".jax_cache")


def test_enable_failure_is_nonfatal(tmp_path, capsys, monkeypatch):
    """A bad cache path (unwritable parent) must warn and return None, not
    raise — enabling the cache can never break serving (the documented
    contract)."""
    from mmla_audio_tpu.utils.compile_cache import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    blocker = tmp_path / "not_a_dir"
    blocker.write_text("")          # a FILE where a parent dir must go
    got = enable_compile_cache(blocker / "cache")
    assert got is None
    assert "compile cache disabled" in capsys.readouterr().err


def test_enable_existing_readonly_dir_is_nonfatal(tmp_path, capsys,
                                                  monkeypatch):
    """mkdir(exist_ok=True) passes on a pre-existing read-only directory, so
    the guard must ALSO check writability — otherwise the cache is 'enabled'
    against a dir JAX can never write (per-compile warnings instead of the
    promised single up-front warn-and-disable).  chmod 555 is advisory for
    root (CI runs as root), so the unwritable dir is simulated by patching
    os.access for this path."""
    import os

    from mmla_audio_tpu.utils import compile_cache as cc

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    ro = tmp_path / "ro_cache"
    ro.mkdir()
    real_access = os.access
    monkeypatch.setattr(
        cc.os, "access",
        lambda p, mode: False if Path(p) == ro else real_access(p, mode))
    got = cc.enable_compile_cache(ro)
    assert got is None
    assert "not writable" in capsys.readouterr().err


def test_enable_success_path_sets_jax_config(tmp_path, monkeypatch):
    """The happy path points JAX's persistent cache at the (created) dir and
    sets the compile-time/entry-size floors — asserted via a recorded
    jax.config.update so the suite process's real global config is never
    mutated (the cross-process cache-hit test exercises the real effect in
    subprocesses)."""
    from mmla_audio_tpu.utils.compile_cache import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    calls = _record_config(monkeypatch)
    path = enable_compile_cache(tmp_path / "cache", min_compile_seconds=2.5,
                                min_entry_bytes=7)
    assert path == tmp_path / "cache" and path.is_dir()
    assert calls["jax_enable_compilation_cache"] is True
    assert calls["jax_compilation_cache_dir"] == str(path)
    assert calls["jax_persistent_cache_min_compile_time_secs"] == 2.5
    assert calls["jax_persistent_cache_min_entry_size_bytes"] == 7
