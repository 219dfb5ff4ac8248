"""Checkpointing: npz save/load of model variables + training state.

Replaces the reference's SavedModel exports and Keras ModelCheckpoint
(`overlap_detector.py:412-415, 448-457`; `speaker_identification.py:241-243`)
with a directory holding ``variables.npz`` (one array per leaf, keyed by the
``/``-joined path of nested dict keys) and ``metadata.json``; ``save_best``
mirrors best-only-on-val-accuracy, and ``continue_train`` resumes from a
saved state (`continue_train_model`, `overlap_detector.py:480-511`).
Enrolled-corpus features are cached like the reference's
``experiment_feature.npz`` (`speaker_identification.py:485-489`).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional

import jax
import numpy as np

__all__ = ["save_variables", "load_variables", "BestCheckpointer",
           "save_feature_cache", "load_feature_cache"]

_VARIABLES = "variables.npz"


def _flatten(tree, prefix=()) -> Dict[str, np.ndarray]:
    if not isinstance(tree, dict):
        return {"/".join(prefix): np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        if not isinstance(k, str) or "/" in k or not k:
            raise ValueError(f"checkpoint keys must be non-empty str without "
                             f"'/': {'/'.join(prefix + (str(k),))!r}")
        out.update(_flatten(v, prefix + (k,)))
    return out


def save_variables(path, variables: Dict[str, Any],
                   metadata: Optional[dict] = None) -> None:
    """Write ``variables`` (nested dicts of arrays) to ``path/variables.npz``
    and ``metadata`` to ``path/metadata.json``; the npz is replaced
    atomically, so a reader never sees a half-written file."""
    path = Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    flat = _flatten(jax.device_get(variables))
    tmp = path / (_VARIABLES + ".tmp")
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path / _VARIABLES)
    if metadata is not None:
        (path / "metadata.json").write_text(json.dumps(metadata))


def load_variables(path, template: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
    """Read variables saved by ``save_variables``.  With ``template`` the
    result has the template's tree and every leaf must match it in path,
    shape and dtype (``ValueError`` otherwise); without, the nested dicts are
    rebuilt from the saved paths."""
    with np.load(Path(path) / _VARIABLES) as data:
        flat = {k: data[k] for k in data.files}
    if template is None:
        out: Dict[str, Any] = {}
        for key, arr in flat.items():
            node = out
            *parents, leaf = key.split("/")
            for k in parents:
                node = node.setdefault(k, {})
            node[leaf] = arr
        return out
    keys = ["/".join(k.key for k in p)
            for p, _ in jax.tree_util.tree_leaves_with_path(template)]
    if set(keys) != set(flat):
        raise ValueError(f"checkpoint {path} does not match the template: "
                         f"missing {sorted(set(keys) - set(flat))}, "
                         f"unexpected {sorted(set(flat) - set(keys))}")
    leaves, treedef = jax.tree_util.tree_flatten(template)
    for key, want in zip(keys, leaves):
        got = flat[key]
        if got.shape != np.shape(want) or got.dtype != want.dtype:
            raise ValueError(
                f"checkpoint {path}: {key} is {got.dtype}{list(got.shape)}, "
                f"template wants {want.dtype}{list(np.shape(want))}")
    return jax.tree_util.tree_unflatten(treedef, [flat[k] for k in keys])


class BestCheckpointer:
    """Keras ModelCheckpoint(save_best_only=True, monitor=val acc, mode=max)."""

    def __init__(self, path, monitor_mode: str = "max"):
        self.path = Path(path)
        self.mode = monitor_mode
        self.best: Optional[float] = None

    def update(self, metric: float, variables: Dict[str, Any],
               metadata: Optional[dict] = None) -> bool:
        better = (self.best is None
                  or (metric > self.best if self.mode == "max"
                      else metric < self.best))
        if better:
            self.best = float(metric)
            meta = dict(metadata or {})
            meta["best_metric"] = self.best
            save_variables(self.path, variables, meta)
        return better


def _cache_paths(path) -> tuple[Path, Path]:
    """np.savez APPENDS '.npz' while Path.with_suffix REPLACES an existing
    suffix — a dotted stem like 'cache.v1' used to save to 'cache.v1.npz'
    but load from 'cache.npz'.  One suffix rule for both sides."""
    s = str(path)
    base = s[:-4] if s.endswith(".npz") else s
    return Path(base + ".npz"), Path(base + ".json")


def save_feature_cache(path, x: np.ndarray, y: np.ndarray,
                       speaker_id_dict: Dict[str, str]) -> None:
    """experiment_feature.npz + speaker_id_dict.json equivalents."""
    npz, js = _cache_paths(path)
    npz.parent.mkdir(parents=True, exist_ok=True)
    np.savez(npz, x=x, y=y)
    js.write_text(json.dumps(speaker_id_dict))


def load_feature_cache(path):
    npz, js = _cache_paths(path)
    data = np.load(npz)
    sid = json.loads(js.read_text())
    return data["x"], data["y"], sid
