"""The port on random architectures, at embedding widths and hidden sizes
the zoo does not use: the counterpart of ``tests/test_fuzz_parity.py``'s
oracle, mesh and trainer fuzz (``:289-400``), on the CPU.

Architectures: the JAX test's own draw (``_fuzz_cfgs``, imported) from its
seed 21, trials 0 and 1 (d 4 and 16, H 8 and 4, "cat"), and trial 1 of
seed 13 (d 8, H 8, "dot"), so every family runs at d in {4, 8, 16} and
DIEN at H in {4, 8}. Weights: the JAX param tree drawn by
``bridge.init_numpy`` (the JAX init's keys, shapes and distributions;
compiling JAX's own init costs seconds a family on the CPU, more than this
file's budget), DIEN's RNN weights scaled by 0.05 as the JAX test scales
them (``:308-311``), fed to the JAX model (and the JAX trainer), to the
port through ``bridge.params_from_numpy`` and to the NumPy oracle. Every kernel wrapper runs its plain version here, so these
cases hold the port's width contract and math to JAX's on both devices'
shared contract; ``chip_smoke.py`` holds each kernel's general and new
instances to the same plain versions on the card.

Limits (the JAX fuzz test's): f32, rtol 2e-4, atol 2e-5 for the forwards,
against the JAX package, the oracle, and (meshes) one device; training:
``tests/test_torch_train.py``'s (losses rtol 1e-5; dense adagrad params
rtol 1e-5, atol 1e-6; the sparse table 1e-3 of the step's reach, its
accumulator 1e-4 of the largest).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprecsys_tpu import train as jax_train
from deeprecsys_tpu.config import ModelConfig as JaxModelConfig
from deeprecsys_tpu.models import get_model as jax_get_model
from deeprecsys_tpu.models.base import Batch as JaxBatch
from deeprecsys_tpu.parallel import make_mesh as jax_make_mesh
from deeprecsys_tpu.parallel import shard_params as jax_shard_params
from deeprecsys_tpu.parallel import sharded_apply as jax_sharded_apply
from deeprecsys_tpu_torch import bridge, train
from deeprecsys_tpu_torch.config import ModelConfig
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.models import get_model
from deeprecsys_tpu_torch.parallel import make_mesh, shard_params, sharded_apply
from tests.oracle.np_reference import csr_from_batch, oracle_forward, oracle_weights_from_params
from tests.test_fuzz_parity import _fuzz_cfgs

RTOL, ATOL = 2e-4, 2e-5
DRAWS = ((21, 0), (21, 1), (13, 1))  # (seed, trial) of _fuzz_cfgs


def _port_cfg(jax_cfg) -> ModelConfig:
    return ModelConfig(**{f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(jax_cfg)})


def _draw(seed: int, trial: int) -> list:
    """Trial ``trial`` of the JAX test's draw from ``seed``."""
    rng = np.random.default_rng(seed)
    for _ in range(trial):
        list(_fuzz_cfgs(rng))
    return list(_fuzz_cfgs(rng))


def _weights(cfg, seed: int) -> dict:
    params = bridge.init_numpy(cfg, seed)
    if cfg.model_type == "dien":  # the stable regime of the JAX test
        for r in ("rnn0", "rnn1"):
            params[r] = {k: v * np.float32(0.05) for k, v in params[r].items()}
    return params


def _jbatch(host) -> JaxBatch:
    return JaxBatch(dense=None if host.dense is None else jnp.asarray(host.dense),
                    indices=jnp.asarray(host.indices),
                    mask=None if host.mask is None else jnp.asarray(host.mask))


@pytest.mark.parametrize("seed,trial", DRAWS)
def test_port_matches_jax_and_the_oracle_on_random_architectures(seed, trial):
    widths = set()
    for jcfg in _draw(seed, trial):
        cfg = _port_cfg(jcfg)
        params_np = _weights(cfg, seed * 10 + trial)
        host = RecDataGenerator(cfg, seed=trial + 1).generate_batch(4)
        model = get_model(cfg, "cpu")
        with torch.inference_mode():
            ours = model.apply(bridge.params_from_numpy(params_np, cfg, "cpu"),
                               host.to("cpu")).double().numpy()
        jmodel = jax_get_model(jcfg)
        theirs = np.asarray(jax.jit(jmodel.apply)(jax.tree_util.tree_map(jnp.asarray, params_np),
                                                  _jbatch(host)), dtype=np.float64)
        w = oracle_weights_from_params(params_np, cfg)
        S_indices, S_lengths = csr_from_batch(host.indices)
        X = None if host.dense is None else np.asarray(host.dense, dtype=np.float64)
        ref = oracle_forward(cfg, w, X, S_indices, S_lengths)
        what = f"{cfg.model_type} d={cfg.sparse_feature_size} H={cfg.hidden_size} ({seed}, {trial})"
        assert ours.shape == theirs.shape == ref.shape, what
        np.testing.assert_allclose(ours, theirs, rtol=RTOL, atol=ATOL, err_msg=what)
        np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=ATOL, err_msg=what)
        widths.add((cfg.model_type, cfg.sparse_feature_size,
                    cfg.hidden_size if cfg.model_type == "dien" else None))
    assert len({t for t, _, _ in widths}) == 6


def test_the_draws_cover_every_width_and_hidden_size():
    cfgs = [c for s, t in DRAWS for c in _draw(s, t)]
    assert {c.sparse_feature_size for c in cfgs} == {4, 8, 16}
    assert {c.hidden_size for c in cfgs if c.model_type == "dien"} == {4, 8}


@pytest.mark.parametrize("D,M,d", [(1, 8, 4), (2, 4, 8), (4, 2, 4), (8, 1, 8)])
def test_sharded_apply_matches_one_device_and_jax_on_random_architectures(D, M, d):
    """The JAX mesh fuzz's architecture (``:331-343``: a DLRM whose rows
    divide the model axis) on the port's ``["cpu"] * 8`` meshes, against
    the port's single device and JAX's sharded output on its 8-device CPU
    mesh."""
    rng = np.random.default_rng(13 + D)
    rows = tuple(int(r) * 8 for r in rng.integers(3, 12, size=int(rng.integers(2, 5))))
    cfg = ModelConfig(model_type="dlrm", model_name=f"fz-mesh-{D}x{M}", mlp_bot=(5, d),
                      mlp_top=(7, 1), embedding_rows=rows, sparse_feature_size=d,
                      num_indices_per_lookup=int(rng.integers(1, 5)),
                      interaction_op=str(rng.choice(["dot", "cat"])))
    params_np = _weights(cfg, D)
    host = RecDataGenerator(cfg, seed=D).generate_batch(2 * D)
    model = get_model(cfg, "cpu")
    params = bridge.params_from_numpy(params_np, cfg, "cpu")
    mesh = make_mesh(D, M, devices=["cpu"] * (D * M))
    with torch.inference_mode():
        single = model.apply(params, host.to("cpu")).numpy()
        out = sharded_apply(model, mesh, has_dense=True)(shard_params(params, mesh),
                                                         host.to("cpu")).numpy()
    jcfg = JaxModelConfig(**dataclasses.asdict(cfg))
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    jmesh = jax_make_mesh(data=D, model=M, devices=jax.devices()[:D * M])
    fn = jax_sharded_apply(jax_get_model(jcfg).apply, jparams, jmesh, has_dense=True)
    want = np.asarray(fn(jax_shard_params(jparams, jmesh), _jbatch(host)))
    np.testing.assert_allclose(out, single, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(out, want, rtol=RTOL, atol=ATOL)


@pytest.fixture
def numpy_jax_init(monkeypatch):
    """The JAX trainer's model initialised from ``_weights`` (the JAX param
    tree of the trainer's own config, drawn by ``bridge.init_numpy``), so
    that no JAX init is compiled; the port's trainer starts from the JAX
    trainer's params as ever."""
    get_model = jax_train.get_model

    def from_numpy(cfg):
        model = get_model(cfg)
        params = _weights(_port_cfg(cfg), 0)
        return model._replace(init=lambda key: jax.tree_util.tree_map(jnp.asarray, params))

    monkeypatch.setattr(jax_train, "get_model", from_numpy)


def _trainers(jcfg, sparse: bool):
    """The JAX trainer and the port's from its params, adagrad at lr 0.01."""
    jt = jax_train.Trainer(jcfg, optimizer="adagrad", learning_rate=0.01, sparse_tables=sparse)
    start = bridge.params_from_numpy(jax.device_get(jt.params), jt.cfg, "cpu")
    pt = train.Trainer(_port_cfg(jcfg), optimizer="adagrad", learning_rate=0.01,
                       sparse_tables=sparse, device="cpu", params=start)
    return jt, pt


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("family", ["dlrm", "dien"])
def test_one_training_step_matches_jax(family, sparse, numpy_jax_init):
    """One dense and one sparse step of a d = 8 DLRM and an H = 8 DIEN (seed
    13's trial 1) against the JAX trainer."""
    jcfg = next(c for c in _draw(13, 1) if c.model_type == family)
    assert jcfg.sparse_feature_size == 8 and (family != "dien" or jcfg.hidden_size == 8)
    jt, pt = _trainers(jcfg, sparse)
    want = jt.fit(1, batch_size=16, seed=1).losses
    got = pt.fit(1, batch_size=16, seed=1).losses
    np.testing.assert_allclose(got, want, rtol=1e-5)
    wanted = bridge.flatten(jax.device_get(jt.params))
    ours = bridge.flatten(bridge.params_to_numpy(pt.params, pt.cfg))
    assert sorted(ours) == sorted(wanted)
    for key, w in wanted.items():
        atol = 1e-3 * 0.01 if sparse and key == "tables" else 1e-6
        np.testing.assert_allclose(ours[key], np.asarray(w), rtol=1e-5, atol=atol, err_msg=key)
    if sparse:
        want_acc = np.asarray(jt.opt_state[1])
        np.testing.assert_allclose(pt.opt_state[1].numpy(), want_acc, rtol=0,
                                   atol=1e-4 * want_acc.max())


@pytest.mark.parametrize("d", [4, 8, 16])
def test_every_lookup_and_sparse_step_computes_at_the_fuzz_widths(d):
    """Every lookup wrapper, its shard mode, the lookup's backward and the
    sparse steps at d in {4, 8, 16} on the CPU: none raises, and each is its
    plain version (the card's instances are held to the same plain
    versions in ``chip_smoke.py``'s phase 3)."""
    from deeprecsys_tpu_torch import ops
    from deeprecsys_tpu_torch.ops import embedding as emb
    from deeprecsys_tpu_torch.ops import hotcold

    rng = np.random.default_rng(d)
    rows = (30, 20, 50)
    R, lo, hi = sum(rows), 25, 75
    offsets = torch.tensor([0, 30, 50], dtype=torch.int32)
    idx = torch.from_numpy(np.stack([rng.integers(0, n, (6, 5)) for n in rows], 1).astype(np.int32))
    mask = torch.from_numpy(rng.random(idx.shape) < 0.7)
    table = torch.from_numpy(rng.standard_normal((R, d)).astype(np.float32))
    q = torch.from_numpy(rng.integers(-127, 128, (R, d)).astype(np.int8))
    scale = torch.rand(3) * 1e-2
    qrows = emb.quantize_rowwise_int8(table)
    g = torch.from_numpy(rng.standard_normal((6, 3, d)).astype(np.float32))
    w = (lo, hi)
    eq = torch.testing.assert_close
    eq(ops.embedding_bag(table, offsets, idx, mask=mask),
       emb.embedding_bag_reference(table, offsets, idx, mask=mask))
    eq(ops.embedding_bag_int8(q, scale, offsets, idx, mask=mask),
       emb.embedding_bag_int8_reference(q, scale, offsets, idx, mask=mask))
    eq(ops.embedding_bag_int8_rowwise(qrows, offsets, idx, mask=mask),
       emb.embedding_bag_int8_rowwise_reference(qrows, offsets, idx, mask=mask))
    eq(ops.embedding_bag_shard(table[lo:hi], offsets, idx, lo, mask=mask),
       emb.embedding_bag_reference(table[lo:hi], offsets, idx, mask=mask, window=w))
    eq(ops.embedding_bag_int8_shard(q[lo:hi], offsets, idx, lo, mask=mask),
       emb.embedding_bag_int8_reference(q[lo:hi], None, offsets, idx, mask=mask, window=w))
    eq(ops.embedding_bag_int8_rowwise_shard(qrows[lo:hi], offsets, idx, lo, mask=mask),
       emb.embedding_bag_int8_rowwise_reference(qrows[lo:hi], offsets, idx, mask=mask,
                                                window=w))
    eq(ops.embedding_bag_backward(g, offsets, idx, R, mask=mask),
       emb.embedding_bag_backward_reference(g, offsets, idx, R, mask=mask))
    eq(emb.embedding_bag_backward_shard(g, offsets, idx, lo, hi - lo, mask=mask),
       emb.embedding_bag_backward_reference(g, offsets, idx, hi - lo, mask=mask, window=w))
    hot_ids = np.arange(0, R, 4, dtype=np.int64)
    split = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in hotcold.split_hot_cold(
        idx.numpy(), offsets.numpy().astype(np.int64), hot_ids, slot_mask=mask.numpy()).items()
        if k != "n_cold"}
    hot = torch.from_numpy(hot_ids)
    eq(ops.embedding_bag_hotcold(table[hot], table, split),
       emb.embedding_bag_hotcold_reference(table[hot], table, split))
    eq(ops.embedding_bag_hotcold_int8(q[hot], q, scale, split),
       emb.embedding_bag_hotcold_int8_reference(q[hot], q, scale, split))
    eq(ops.embedding_bag_hotcold_int8_rowwise(qrows[hot], qrows, split),
       emb.embedding_bag_hotcold_int8_rowwise_reference(qrows[hot], qrows, split))
    for fn, ref, t in ((ops.embedding_bag_hotcold_shard, emb.embedding_bag_hotcold_reference, table),
                       (ops.embedding_bag_hotcold_int8_rowwise_shard,
                        emb.embedding_bag_hotcold_int8_rowwise_reference, qrows)):
        eq(fn(t[hot], t, split), ref(t[hot], t, split, partial=True))
    eq(ops.embedding_bag_hotcold_int8_shard(q[hot], q, split),
       emb.embedding_bag_hotcold_int8_reference(q[hot], q, None, split, partial=True))
    from deeprecsys_tpu_torch.ops.sparse_adagrad import sparse_adagrad_step_reference
    for dt in (torch.float32, torch.bfloat16):
        t0, a0 = (table * 0.05).to(dt), torch.rand(R) * 1e-3
        got, acc, want, want_a = t0.clone(), a0.clone(), t0.clone(), a0.clone()
        ops.sparse_adagrad_step(got, acc, offsets, idx, g, 0.1)
        sparse_adagrad_step_reference(want, want_a, offsets, idx, g, 0.1)
        assert torch.equal(got, want) and torch.equal(acc, want_a)
        got, acc = t0[lo:hi].clone(), a0[lo:hi].clone()
        want, want_a = t0[lo:hi].clone(), a0[lo:hi].clone()
        ops.sparse_adagrad_step_shard(got, acc, offsets, idx, g, lo, 0.1)
        sparse_adagrad_step_reference(want, want_a, offsets, idx, g, 0.1, window=w)
        assert torch.equal(got, want) and torch.equal(acc, want_a)
