"""Multi-process path of ``parallel/distributed.py``.

The multi-process branch (`distributed.py` explicit-coordinator initialize +
``host_local_batch_to_global``'s ``make_array_from_process_local_data``):
JAX supports a 2-process CPU coordinator over local
sockets, so the real thing is testable here: two subprocesses each with 4
virtual CPU devices join one 8-device global mesh, assemble host-local
window batches into a globally-sharded array, run a data-parallel program
with a cross-process reduction, and must reproduce the single-process
``shard_batch`` result exactly.

Skip condition: only if the sandbox blocks local sockets (grpc bind
failure), surfaced as a skip rather than a failure.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

_WORKER = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np

coord, pid, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]

from mmla_audio_tpu.parallel import distributed as dist
from mmla_audio_tpu.parallel import DataParallel

dist.initialize(coordinator_address=coord, num_processes=2, process_id=pid)
assert dist.process_info() == (pid, 2), dist.process_info()

mesh = dist.global_mesh()
assert np.prod(mesh.devices.shape) == 8, mesh.devices.shape

# deterministic global batch (16, 5); each process contributes its half
full = np.arange(16 * 5, dtype=np.float32).reshape(16, 5)
local = full[pid * 8: (pid + 1) * 8]
xg = dist.host_local_batch_to_global(local, mesh)
assert xg.shape == (16, 5), xg.shape
# this process's addressable shards hold exactly its own local rows
mine = sorted((s.index[0].start or 0, np.asarray(s.data))
              for s in xg.addressable_shards)
got_rows = np.concatenate([d for _, d in mine])
assert np.array_equal(got_rows, local), (got_rows, local)

# data-parallel program with a cross-process reduction: per-row dot
# with replicated state, then a global batch mean — replicated everywhere
state = np.arange(5, dtype=np.float32) + 1.0

def fn(state, x):
    rows = x @ state
    return rows.mean()                      # all-reduce over the data axis

out = DataParallel(fn, mesh)(state, xg)
json.dump({"pid": pid, "mean": float(out)}, open(out_path, "w"))
"""


@pytest.mark.parametrize("n_proc", [2])
def test_two_process_cpu_coordinator(tmp_path, n_proc):
    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", 0))
        except OSError:
            pytest.skip("sandbox blocks local sockets")
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    outs = []
    for pid in range(n_proc):
        out_path = tmp_path / f"out{pid}.json"
        outs.append(out_path)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), coord, str(pid), str(out_path)],
            cwd=str(Path(__file__).resolve().parent.parent), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    rcs = []
    logs = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        rcs.append(p.returncode)
        logs.append(se.decode(errors="replace")[-2000:])
    if any(rc != 0 for rc in rcs):
        joined = "\n---\n".join(logs)
        if "UNAVAILABLE" in joined or "failed to connect" in joined.lower():
            pytest.skip(f"coordinator unreachable in sandbox: {joined[-300:]}")
        raise AssertionError(f"worker failed rc={rcs}:\n{joined}")

    # single-process reference: plain shard_batch + the same program
    full = np.arange(16 * 5, dtype=np.float32).reshape(16, 5)
    state = np.arange(5, dtype=np.float32) + 1.0
    want = float((full @ state).mean())
    for out_path in outs:
        got = json.loads(out_path.read_text())
        assert got["mean"] == pytest.approx(want, rel=1e-6), got


_FIT_WORKER = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import optax

coord, pid, out_path = sys.argv[1], int(sys.argv[2]), sys.argv[3]

from mmla_audio_tpu.parallel import distributed as dist

dist.initialize(coordinator_address=coord, num_processes=2, process_id=pid)
mesh = dist.global_mesh()

from tests.test_dcn import _fit_workload

model, tr, state, x, y = _fit_workload()
# each host contributes ITS OWN half of the global batch (no raw audio
# crosses hosts); the assembled global arrays ride fit's jax.Array fast path
xg = dist.host_local_batch_to_global(x[pid * 8: (pid + 1) * 8], mesh)
yg = dist.host_local_batch_to_global(y[pid * 8: (pid + 1) * 8], mesh)
state, hist = tr.fit(state, xg, yg, epochs=1, batch_size=8,
                     rng=jax.random.PRNGKey(1), mesh=mesh)
digest = [[str(p), float(np.mean(np.asarray(l))),
           float(np.max(np.abs(np.asarray(l))))]
          for p, l in jax.tree_util.tree_leaves_with_path(state.params)]
json.dump({"pid": pid, "loss": hist["loss"], "digest": digest},
          open(out_path, "w"))
"""


def _fit_workload():
    """Deterministic tiny fit problem shared by the 2-process workers and
    the single-process reference (imported by both, so one definition)."""
    import optax

    import jax

    from mmla_audio_tpu.core.config import SpeakerModelConfig
    from mmla_audio_tpu.models.speaker import SpeakerResBLSTM
    from mmla_audio_tpu.train import Trainer, keras_categorical_crossentropy

    cfg = SpeakerModelConfig(stage_filters=(4, 4, 4), lstm_units=8,
                             num_speakers=2)
    rng = np.random.RandomState(0)
    x = rng.randn(16, 256, 39).astype(np.float32)
    x[:8, :, :8] += 3
    y = np.zeros((16, 2), np.float32)
    y[:8, 0] = 1
    y[8:, 1] = 1
    model = SpeakerResBLSTM(cfg)
    variables = model.init_variables(jax.random.PRNGKey(0))
    # SGD: no preconditioner amplification of cross-process reduction-order
    # noise, so tight equality with the single-process run is meaningful
    # (same rationale as tests/test_parallel_training.py)
    tr = Trainer(model, optax.sgd(1e-3), keras_categorical_crossentropy)
    return model, tr, tr.init_state(variables), x, y


def test_two_process_trainer_fit_matches_single(tmp_path):
    """The production training surface across a process boundary: one
    ``Trainer.fit`` epoch on a 2-process 8-device global
    mesh — host-local batch halves assembled via
    ``host_local_batch_to_global``, gradients all-reduced across the
    two processes — must match the single-process single-device fit."""
    with socket.socket() as s:
        try:
            s.bind(("127.0.0.1", 0))
        except OSError:
            pytest.skip("sandbox blocks local sockets")
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    worker = tmp_path / "fit_worker.py"
    worker.write_text(_FIT_WORKER)
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    procs, outs = [], []
    for pid in range(2):
        out_path = tmp_path / f"fit_out{pid}.json"
        outs.append(out_path)
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), coord, str(pid), str(out_path)],
            cwd=str(repo), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    rcs, logs = [], []
    for p in procs:
        try:
            so, se = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        rcs.append(p.returncode)
        logs.append(se.decode(errors="replace")[-2000:])
    if any(rc != 0 for rc in rcs):
        joined = "\n---\n".join(logs)
        if "UNAVAILABLE" in joined or "failed to connect" in joined.lower():
            pytest.skip(f"coordinator unreachable in sandbox: {joined[-300:]}")
        raise AssertionError(f"fit worker failed rc={rcs}:\n{joined}")

    import jax

    model, tr, state, x, y = _fit_workload()
    state, hist = tr.fit(state, x, y, epochs=1, batch_size=8,
                         rng=jax.random.PRNGKey(1))
    want_digest = [[str(p), float(np.mean(np.asarray(l))),
                    float(np.max(np.abs(np.asarray(l))))]
                   for p, l in
                   jax.tree_util.tree_leaves_with_path(state.params)]
    for out_path in outs:
        got = json.loads(out_path.read_text())
        np.testing.assert_allclose(got["loss"], hist["loss"],
                                   rtol=1e-4, atol=1e-5)
        assert len(got["digest"]) == len(want_digest)
        for (pa, ma, xa), (pb, mb, xb) in zip(got["digest"], want_digest):
            assert pa == pb
            np.testing.assert_allclose([ma, xa], [mb, xb],
                                       rtol=1e-4, atol=1e-5, err_msg=pa)
