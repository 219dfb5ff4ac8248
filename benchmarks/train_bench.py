"""Overlap-detector training throughput on the device.

The reference trains with Keras `model.fit` on whatever host accelerator TF
finds; it publishes no speed numbers (SURVEY §6).  Here the whole epoch is
ONE scanned XLA program (`Trainer._run_epoch`: shuffle + scan over batches,
forward + weighted-CCE + backward + Adadelta update fused), so the epoch
dispatches once and syncs twice (loss/acc floats).

Measures steady-state seconds/epoch and windows/second at the reference
batch size (32, `overlap_detector.py:421`) and at a larger batch (256),
training geometry (B, 128, 151, 3) f32.

Run on the card:  python benchmarks/train_bench.py
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np

N_WINDOWS = 2048
EPOCHS_STEADY = 6


def main():
    import jax

    from mmla_audio_tpu.train.overlap_trainer import OverlapTrainer

    rng = np.random.RandomState(0)
    x = rng.randn(N_WINDOWS, 128, 151, 3).astype(np.float32) * 40 + 128
    labels = rng.randint(0, 2, N_WINDOWS)
    y = np.eye(2, dtype=np.float32)[labels]
    # separable-ish signal so the loss moves (guards against a degenerate
    # all-constant program being optimized away)
    x[labels == 1, :, :, 0] += 25.0

    results = {"device": str(jax.devices()[0]), "n_windows": N_WINDOWS}
    for bsz in (32, 256):
        ot = OverlapTrainer()
        trainer, _ = ot._make_trainer(np.array([1.0, 1.0], np.float32))
        variables = ot.model.init_variables(jax.random.PRNGKey(0),
                                            input_shape=x.shape[1:])
        state = trainer.init_state(variables)
        t0 = time.perf_counter()
        state, _ = trainer.fit(state, x, y, epochs=1, batch_size=bsz)
        t_compile = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, h = trainer.fit(state, x, y, epochs=EPOCHS_STEADY,
                               batch_size=bsz)
        dt = (time.perf_counter() - t0) / EPOCHS_STEADY
        wps = N_WINDOWS / dt
        results[f"b{bsz}"] = {
            "epoch_s": round(dt, 3),
            "windows_per_s": round(wps, 1),
            "first_epoch_s": round(t_compile, 1),
            "final_loss": round(float(h["loss"][-1]), 4),
        }
        print(f"[train] b{bsz}: {dt:.3f} s/epoch ({wps:,.0f} windows/s; "
              f"compile+first {t_compile:.1f} s, loss {h['loss'][-1]:.4f})",
              file=sys.stderr, flush=True)

    print(json.dumps(results))


if __name__ == "__main__":
    main()
