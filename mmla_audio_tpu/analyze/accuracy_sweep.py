"""Test-split-ratio accuracy sweep + violin plot (the R script's role).

The reference's commented experiment harness
(`speaker_identification.py:566-597`) retrains the transfer head across a
sweep of test-split ratios and seeds, appending accuracies to ``acc.txt``;
``plot_accuracy.R`` renders a ggplot violin+jitter of that file.  Here:
``run_sweep`` produces the same ``acc.txt`` rows (ratio<TAB>accuracy) with
the on-device transfer learner, and ``render_violin_html`` draws the
distribution per ratio (kernel-density violin + jittered points) as a
standalone SVG/HTML — no R required.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

__all__ = ["run_sweep", "parse_acc_file", "render_violin_html"]


def run_sweep(learner, x, y, ratios: Sequence[float] = (0.2, 0.3, 0.4, 0.5),
              seeds: Sequence[int] = (0, 1, 2), acc_path=None,
              epochs_override=None) -> Dict[float, List[float]]:
    """For each (ratio, seed): hold out ``ratio`` of the corpus, fine-tune on
    the rest, record held-out accuracy.  ``learner``: TransferLearner."""
    from mmla_audio_tpu.train.transfer import train_val_split

    results: Dict[float, List[float]] = {r: [] for r in ratios}
    lines = []
    for ratio in ratios:
        for seed in seeds:
            x_tr, y_tr, x_te, y_te = train_val_split(
                np.asarray(x, np.float32), np.asarray(y, np.float32),
                ratio, seed)
            variables, _, _ = learner.fit_once(
                x_tr, y_tr, seed=seed, epochs_override=epochs_override)
            import jax.numpy as jnp

            logits = learner.model.apply(variables, jnp.asarray(x_te))
            acc = float((np.argmax(np.asarray(logits), -1)
                         == np.argmax(y_te, -1)).mean())
            results[ratio].append(acc)
            lines.append(f"{ratio}\t{acc}")
    if acc_path is not None:
        Path(acc_path).write_text("\n".join(lines) + "\n")
    return results


def parse_acc_file(path) -> Dict[float, List[float]]:
    out: Dict[float, List[float]] = {}
    for ln in Path(path).read_text().splitlines():
        if not ln.strip():
            continue
        ratio, acc = ln.split("\t")
        out.setdefault(float(ratio), []).append(float(acc))
    return out


def _kde(vals: np.ndarray, grid: np.ndarray) -> np.ndarray:
    if len(vals) < 2 or np.std(vals) == 0:
        bw = 0.02
    else:
        bw = 1.06 * np.std(vals) * len(vals) ** -0.2
    d = (grid[:, None] - vals[None, :]) / bw
    return np.exp(-0.5 * d * d).sum(axis=1) / (len(vals) * bw * np.sqrt(2 * np.pi))


def render_violin_html(results: Dict[float, List[float]], out_path,
                       title: str = "Registration accuracy vs test split") -> Path:
    import html as _h

    W, H, pad = 720, 420, 50
    ratios = sorted(results)
    lane_w = (W - 2 * pad) / max(len(ratios), 1)
    grid = np.linspace(0.0, 1.0, 120)
    parts = []
    rng = np.random.RandomState(0)
    for i, r in enumerate(ratios):
        vals = np.asarray(results[r], float)
        cx = pad + (i + 0.5) * lane_w
        dens = _kde(vals, grid)
        dens = dens / (dens.max() + 1e-12) * (lane_w * 0.4)
        ys = H - pad - grid * (H - 2 * pad)
        right = [f"{cx + d:.1f},{y:.1f}" for d, y in zip(dens, ys)]
        left = [f"{cx - d:.1f},{y:.1f}" for d, y in zip(dens[::-1], ys[::-1])]
        parts.append(f'<polygon points="{" ".join(right + left)}" '
                     f'fill="#61a0a8" opacity="0.55"/>')
        for v in vals:   # jittered points
            jx = cx + rng.uniform(-lane_w * 0.15, lane_w * 0.15)
            jy = H - pad - v * (H - 2 * pad)
            parts.append(f'<circle cx="{jx:.1f}" cy="{jy:.1f}" r="3" '
                         f'fill="#c23531"/>')
        parts.append(f'<text x="{cx}" y="{H - pad + 18}" font-size="12" '
                     f'text-anchor="middle">{r}</text>')
    for frac in (0.0, 0.25, 0.5, 0.75, 1.0):
        y = H - pad - frac * (H - 2 * pad)
        parts.append(f'<line x1="{pad}" y1="{y}" x2="{W - pad}" y2="{y}" '
                     f'stroke="#eee"/>'
                     f'<text x="{pad - 8}" y="{y + 4}" font-size="11" '
                     f'text-anchor="end">{frac}</text>')
    svg = (f'<svg width="{W}" height="{H}" '
           f'xmlns="http://www.w3.org/2000/svg">{"".join(parts)}'
           f'<text x="{W / 2}" y="20" text-anchor="middle" font-size="15">'
           f'{_h.escape(title)}</text>'
           f'<text x="{W / 2}" y="{H - 8}" text-anchor="middle" '
           f'font-size="12">test split ratio</text></svg>')
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(f"<!DOCTYPE html><html><body>{svg}</body></html>")
    return out_path
