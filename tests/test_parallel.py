"""Multi-device sharding on the 8-device virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mmla_audio_tpu.core.config import OverlapModelConfig
from mmla_audio_tpu.inference import OverlapPredictor
from mmla_audio_tpu.models.overlap import OverlapResBLSTM
from mmla_audio_tpu.parallel import (
    DataParallel,
    batch_sharding,
    make_mesh,
    replicate_tree,
    shard_batch,
)


def test_eight_devices_present():
    assert len(jax.devices()) == 8


def test_mesh_shapes():
    mesh = make_mesh()
    assert mesh.devices.shape == (8, 1)
    mesh2 = make_mesh(n_data=4, n_model=2)
    assert mesh2.devices.shape == (4, 2)


def test_shard_batch_places_on_axis():
    mesh = make_mesh()
    x = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    xs = shard_batch(x, mesh)
    assert xs.sharding.is_equivalent_to(batch_sharding(mesh), 2)
    np.testing.assert_array_equal(np.asarray(xs), x)


def test_data_parallel_inference_matches_single_device():
    cfg = OverlapModelConfig(stage_filters=(4, 4, 8), lstm_units=8)
    model = OverlapResBLSTM(cfg)
    variables = model.init_variables(jax.random.PRNGKey(0))
    pred = OverlapPredictor(variables, cfg)

    rng = np.random.RandomState(0)
    buf = (rng.randn(16, 40960) * 3000).astype(np.float32)
    n = np.full(16, 40960, np.int32)

    labels_1, probs_1 = pred.predict(buf, n)

    mesh = make_mesh()
    dp = DataParallel(pred.lower_fn(), mesh)
    labels_8, probs_8 = dp(variables, jnp.asarray(buf), jnp.asarray(n))

    np.testing.assert_array_equal(np.asarray(labels_1), np.asarray(labels_8))
    np.testing.assert_allclose(np.asarray(probs_1), np.asarray(probs_8),
                               atol=2e-5)


def test_data_parallel_gradient_allreduce():
    """Sharded-batch gradients must equal single-device gradients (XLA
    inserts the all-reduce automatically)."""
    mesh = make_mesh()

    def loss_fn(w, x, y):
        pred = x @ w
        return jnp.mean((pred - y) ** 2)

    rng = np.random.RandomState(1)
    w = jnp.asarray(rng.randn(8, 1).astype(np.float32))
    x = jnp.asarray(rng.randn(32, 8).astype(np.float32))
    y = jnp.asarray(rng.randn(32, 1).astype(np.float32))

    g_single = jax.grad(loss_fn)(w, x, y)

    gfn = jax.jit(jax.grad(loss_fn))
    g_sharded = gfn(replicate_tree(w, mesh), shard_batch(x, mesh),
                    shard_batch(y, mesh))
    np.testing.assert_allclose(np.asarray(g_single), np.asarray(g_sharded),
                               atol=1e-6)


def test_param_shardings_rule():
    """>=2-D leaves with a divisible feature dim shard on the model axis;
    biases/BN vectors and odd-sized dims replicate."""
    from mmla_audio_tpu.parallel import param_shardings, shard_params

    mesh = make_mesh(n_data=4, n_model=2)
    tree = {
        "conv": {"kernel": np.zeros((3, 3, 4, 8), np.float32),
                 "bias": np.zeros((8,), np.float32)},
        "head": {"kernel": np.zeros((16, 3), np.float32)},   # 3 % 2 != 0
    }
    sh = param_shardings(tree, mesh)
    assert sh["conv"]["kernel"].spec == jax.sharding.PartitionSpec(
        None, None, None, "model")
    assert sh["conv"]["bias"].spec == jax.sharding.PartitionSpec()
    assert sh["head"]["kernel"].spec == jax.sharding.PartitionSpec()

    placed = shard_params(tree, mesh)
    assert not placed["conv"]["kernel"].sharding.is_fully_replicated
    assert placed["conv"]["bias"].sharding.is_fully_replicated

    # model axis of size 1 degrades to full replication
    mesh1 = make_mesh()
    sh1 = param_shardings(tree, mesh1)
    assert sh1["conv"]["kernel"].spec == jax.sharding.PartitionSpec()


def test_tensor_parallel_train_step_matches_replicated():
    """Full overlap train step on a 2-D (data x model) mesh with the
    parameter tree ACTUALLY partitioned on the model axis: loss, updated
    params, and updated batch stats must match the replicated-layout run
    (GSPMD sharding is layout, not algorithm — XLA inserts the collectives)."""
    import optax

    from mmla_audio_tpu.core.config import OverlapFeatureConfig
    from mmla_audio_tpu.ops.features import overlap_model_input
    from mmla_audio_tpu.parallel import shard_params
    from mmla_audio_tpu.train import adadelta, weighted_categorical_crossentropy

    mcfg = OverlapModelConfig(stage_filters=(4, 8, 8), lstm_units=8,
                              num_classes=2)
    fcfg = OverlapFeatureConfig()
    model = OverlapResBLSTM(mcfg)
    variables = model.init_variables(jax.random.PRNGKey(0))
    tx = adadelta(1e-3)
    weights = jnp.asarray([0.5, 0.5])

    def train_step(params, batch_stats, opt_state, buf, n, y):
        def loss_fn(p):
            audio = jnp.where(jnp.arange(fcfg.n_samples) < n[:, None],
                              buf[:, :fcfg.n_samples], 0.0) / 32768.0
            img = overlap_model_input(audio, fcfg)
            logits, upd = model.apply(
                {"params": p, "batch_stats": batch_stats}, img,
                train=True, rngs={"dropout": jax.random.PRNGKey(0)},
                mutable=["batch_stats"])
            loss = jnp.mean(
                weighted_categorical_crossentropy(logits, y, weights))
            return loss, upd["batch_stats"]

        (loss, new_stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_stats, loss

    rng = np.random.RandomState(0)
    B = 8
    buf = jnp.asarray((rng.randn(B, 40960) * 3000).astype(np.float32))
    n = jnp.full((B,), 24000, jnp.int32)
    y = jnp.asarray(np.eye(2, dtype=np.float32)[rng.randint(0, 2, B)])

    step = jax.jit(train_step)

    mesh_dp = make_mesh()
    p_r, s_r, loss_r = step(
        replicate_tree(variables["params"], mesh_dp),
        replicate_tree(variables["batch_stats"], mesh_dp),
        replicate_tree(tx.init(variables["params"]), mesh_dp),
        shard_batch(buf, mesh_dp), shard_batch(n, mesh_dp),
        shard_batch(y, mesh_dp))

    mesh_tp = make_mesh(n_data=4, n_model=2)
    params_tp = shard_params(variables["params"], mesh_tp)
    # at least one kernel is genuinely partitioned, not replicated
    assert any(
        not leaf.sharding.is_fully_replicated
        for leaf in jax.tree_util.tree_leaves(params_tp))
    p_t, s_t, loss_t = step(
        params_tp,
        replicate_tree(variables["batch_stats"], mesh_tp),
        shard_params(tx.init(variables["params"]), mesh_tp),
        shard_batch(buf, mesh_tp), shard_batch(n, mesh_tp),
        shard_batch(y, mesh_tp))

    # layout changes reduction order: agreement is close, not bitwise
    np.testing.assert_allclose(float(loss_r), float(loss_t),
                               rtol=1e-4, atol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(p_r),
                    jax.tree_util.tree_leaves(p_t)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(s_r),
                    jax.tree_util.tree_leaves(s_t)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)


def test_dryrun_multichip_entrypoint():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


def test_entry_compiles():
    import __graft_entry__ as ge
    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    labels, probs = out
    assert labels.shape == (8,)
    assert probs.shape == (8, 2)


def test_distributed_single_process_paths():
    """Multi-host helpers degrade exactly to the single-process primitives."""
    from mmla_audio_tpu.parallel import distributed as dist

    # no coordinator configured -> initialize is a no-op (and idempotent)
    dist.initialize()
    dist.initialize()
    assert dist.process_info() == (0, 1)

    mesh = dist.global_mesh()
    assert mesh.devices.shape == (8, 1)

    rng = np.random.RandomState(0)
    x = rng.randn(16, 5).astype(np.float32)
    xg = dist.host_local_batch_to_global(x, mesh)
    np.testing.assert_array_equal(np.asarray(xg), x)
    assert xg.sharding == batch_sharding(mesh)

    # sharded compute over the assembled batch matches single-device
    out = jax.jit(lambda a: (a * 2).sum(axis=1))(xg)
    np.testing.assert_allclose(np.asarray(out), (x * 2).sum(axis=1),
                               rtol=1e-6)


def test_distributed_initialize_env_autodiscovery(monkeypatch):
    """The env-driven join/skip branch: $JAX_COORDINATOR_ADDRESS joins the
    multi-process runtime (jax.distributed.initialize() discovers the rest);
    a clean env skips it entirely."""
    from mmla_audio_tpu.parallel import distributed as dist

    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda *a, **kw: calls.append((a, kw)))
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS", raising=False)

    def reset():
        monkeypatch.setattr(dist, "_initialized", False)
        calls.clear()

    # clean env -> skip (single process)
    reset()
    dist.initialize()
    assert not calls and not dist._initialized

    # coordinator env var -> env-driven join (no explicit args)
    reset()
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:8476")
    dist.initialize()
    assert calls == [((), {})] and dist._initialized
    # idempotent: a second call must not re-join
    dist.initialize()
    assert len(calls) == 1
    monkeypatch.delenv("JAX_COORDINATOR_ADDRESS")

    # explicit args: all three forwarded; partial sets fail loudly
    reset()
    dist.initialize(coordinator_address="10.0.0.1:8476",
                    num_processes=2, process_id=1)
    assert calls == [((), {"coordinator_address": "10.0.0.1:8476",
                           "num_processes": 2, "process_id": 1})]
    reset()
    with pytest.raises(ValueError, match="must be given together"):
        dist.initialize(coordinator_address="10.0.0.1:8476")
    assert not calls
