"""Deployment export + compiled-parity check (the TFLite path, in XLA).

The reference "deploys" by converting the SavedModel to a fixed-shape TFLite
flatbuffer and asserting per-sample argmax parity between backends
(`tfl_convert.py:29-88` — the repo's only assertion-based check).  The
equivalent here: parameters exported as an npz checkpoint + the serving
function AOT-compiled for a pinned input shape; ``parity_check`` asserts
per-sample argmax agreement between the eager and compiled programs.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Callable, Dict

import jax
import numpy as np

from mmla_audio_tpu.train.checkpoints import load_variables, save_variables

__all__ = ["export_serving", "load_serving", "aot_compile", "parity_check"]


def export_serving(path, variables: Dict[str, Any], *,
                   input_shape, model_name: str,
                   extra_meta: dict | None = None) -> None:
    """Export a deployable bundle: params + pinned serving signature."""
    meta = {"model": model_name, "input_shape": list(input_shape)}
    meta.update(extra_meta or {})
    save_variables(path, variables, meta)


def load_serving(path, template=None):
    variables = load_variables(path, template)
    meta = json.loads((Path(path) / "metadata.json").read_text())
    return variables, meta


def aot_compile(fn: Callable, *example_args):
    """AOT-compile ``fn`` for the exact shapes of ``example_args`` (the
    fixed-signature concrete function of the reference's converter)."""
    return jax.jit(fn).lower(*example_args).compile()


def parity_check(eager_fn: Callable, compiled, inputs, *,
                 argmax_axis: int = -1) -> None:
    """tfl_convert.py:64-88: per-sample argmax agreement, hard assert."""
    eager_out = np.asarray(eager_fn(*inputs))
    compiled_out = np.asarray(compiled(*inputs))
    np.testing.assert_array_equal(
        np.argmax(eager_out, axis=argmax_axis),
        np.argmax(compiled_out, axis=argmax_axis))
