"""The port's mesh training against the JAX package's, on the CPU.

The JAX tests train on a virtual 8-device CPU mesh (``tests/conftest.py``);
the port trains on ``make_mesh(..., devices=["cpu"] * 8)``, whose entries
name one device, so each table shard and each replicated leaf is one tensor
however many entries share it. Both packages start from the same weights
(the JAX trainer's params through ``bridge``) and take the same batches (the
port's generator is bit-identical). Every kernel wrapper runs its plain
version on the CPU: K1's and K1b's windows in the dense step, K1's and K5's
windows in the sparse one. Covered, mirroring ``tests/test_train.py`` and
``tests/test_parallel.py``: ``Trainer(mesh=)`` dense (sgd, adagrad, adam;
adagrad also where the JAX config packs rows) and sparse (2x4, 4x2), the
sharded sparse step against both packages' single-device step,
``make_train_step``, and one step on a 2x2 mesh of one device against a
1x1 mesh.

Limits:
- losses: rtol 1e-5 over 3 steps;
- params against JAX: ``tests/test_torch_train.py``'s limits for the mode
  (dense sgd/adagrad rtol 1e-5, atol 1e-6; adam atol 2% of the steps'
  reach; the sparse table 1e-3 of the reach, its accumulator 1e-4 of the
  largest);
- sharded against single-device: the JAX tests' (tables rtol 1e-4, atol
  1e-6; accumulators atol 1e-7);
- a 2x2 mesh of one device against 1x1: f32 rounding (losses rtol 1e-5;
  params rtol 1e-5, atol 1e-7). A leaf updated once a sharing entry would
  miss this by a factor.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprecsys_tpu import train as jax_train
from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu.config import ModelConfig as JaxModelConfig
from deeprecsys_tpu.data import RecDataGenerator as JaxGenerator
from deeprecsys_tpu.models import get_model as jax_get_model
from deeprecsys_tpu.models.base import Batch as JaxBatch
from deeprecsys_tpu.parallel import make_mesh as jax_make_mesh
from deeprecsys_tpu.parallel import make_train_step as jax_make_train_step
from deeprecsys_tpu.parallel import shard_params as jax_shard_params
from deeprecsys_tpu_torch import bridge, train, zoo
from deeprecsys_tpu_torch.config import ModelConfig
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.models import get_model
from deeprecsys_tpu_torch.models.base import Batch
from deeprecsys_tpu_torch.parallel import make_mesh, make_train_step, shard_params, unshard_params
from deeprecsys_tpu_torch.parallel.sharding import leaf_copies

SCALE = 2000
STEPS = 3
BATCH = 32
CPU8 = ["cpu"] * 8
LR = {"sgd": 0.01, "adagrad": 0.01, "adam": 1e-3, "sparse": 0.01}


def _mesh(D, M):
    return make_mesh(D, M, devices=CPU8[:D * M])


def _jax_mesh(D, M):
    return jax_make_mesh(data=D, model=M, devices=jax.devices()[:D * M])


def _port_cfg(jax_cfg):
    return ModelConfig(**{f.name: getattr(jax_cfg, f.name)
                          for f in dataclasses.fields(jax_cfg)})


def _mesh_pair(name, mode, D, M, jax_cfg=None, **kw):
    """The JAX mesh trainer and the port's on the same mesh shape, started
    from the JAX trainer's params."""
    sparse = mode == "sparse"
    opt = "adagrad" if sparse else mode
    jt = jax_train.Trainer(jax_cfg or jax_zoo.get_config(name, table_scale=SCALE),
                           mesh=_jax_mesh(D, M), optimizer=opt, learning_rate=LR[mode],
                           sparse_tables=sparse, **kw)
    start = bridge.params_from_numpy(jax.device_get(jt.params), jt.cfg, "cpu")
    pt = train.Trainer(zoo.get_config(name, table_scale=SCALE), mesh=_mesh(D, M), optimizer=opt,
                       learning_rate=LR[mode], sparse_tables=sparse, params=start, **kw)
    return jt, pt


def _assert_close_to_jax(jax_params, jax_cfg, got: dict, mode: str):
    """``tests/test_torch_train.py::_assert_params_close``'s limits on the
    port's full params (``got``, the port's layout)."""
    want = bridge.flatten(jax.device_get(jax_params))
    got = bridge.flatten(bridge.params_to_numpy(got, _port_cfg(jax_cfg)))
    assert sorted(got) == sorted(want)
    reach = STEPS * LR[mode]
    for key, w in want.items():
        w = np.asarray(w)
        assert got[key].shape == w.shape and got[key].dtype == w.dtype, key
        atol = (0.02 * reach if mode == "adam" else
                1e-3 * reach if mode == "sparse" and key == "tables" else 1e-6)
        np.testing.assert_allclose(got[key], w, rtol=1e-5, atol=atol, err_msg=key)


def _full_acc(pt):
    acc = pt.opt_state[1]
    return torch.cat([acc.part(0, m) for m in range(pt.mesh.shape["model"])])


@pytest.mark.parametrize("mode", ["sgd", "adagrad", "adam", "adagrad_packed"])
def test_mesh_trainer_dense_matches_jax(mode):
    """Dense training on a 2x4 mesh (JAX ``test_trainer_sharded_*``). Where
    the JAX config packs rows (``table_pack=2``), the port trains the
    unpacked layout its own rules resolve; the params compare in JAX's."""
    opt = mode.split("_")[0]
    jcfg = jax_zoo.get_config("rm1", table_scale=SCALE)
    if mode == "adagrad_packed":
        jcfg = jcfg.replace(table_pack=2)
    jt, pt = _mesh_pair("rm1", opt, 2, 4, jax_cfg=jcfg)
    want = jt.fit(STEPS, batch_size=BATCH, seed=1).losses
    got = pt.fit(STEPS, batch_size=BATCH, seed=1).losses
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_close_to_jax(jt.params, jt.cfg, pt.full_params(), opt)
    # The optimizer state of a table shard is row-sharded with it.
    if opt == "adagrad":
        leaves = [t for c in leaf_copies(pt.params) for t in c]
        (idx,) = pt.opt_state.devices.values()
        accs = pt.opt_state.states[torch.device("cpu")]
        assert len(accs) == len(idx) == len(leaves)
        assert [tuple(a.shape) for a in accs].count((pt.params.rows_per_shard, 32)) == 4


@pytest.mark.parametrize("D,M", [(2, 4), (4, 2)])
def test_mesh_trainer_sparse_matches_jax(D, M):
    """Sparse training on 2x4 and 4x2 (JAX ``test_sharded_sparse_*``)."""
    jt, pt = _mesh_pair("rm1", "sparse", D, M)
    want = jt.fit(STEPS, batch_size=BATCH, seed=1).losses
    got = pt.fit(STEPS, batch_size=BATCH, seed=1).losses
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_close_to_jax(jt.params, jt.cfg, pt.full_params(), "sparse")
    want_acc = np.asarray(jt.opt_state[1])
    np.testing.assert_allclose(_full_acc(pt).numpy(), want_acc, rtol=0,
                               atol=1e-4 * want_acc.max())


def _ncf_step_inputs(cfg_port):
    gen = RecDataGenerator(cfg_port, seed=5)
    host = gen.generate_batch(16)
    labels = (host.indices[:, 0, 0] % 2).astype(np.float32)
    return host, np.broadcast_to(labels[:, None], (16, cfg_port.out_dim)).copy()


@pytest.mark.parametrize("dedup", [False, True])
def test_sharded_sparse_step_matches_single_device(dedup):
    """One sharded sparse step (ncf, 2x4) against the single-device sparse
    step of both packages (JAX ``test_sharded_sparse_matches_single_device``)."""
    lr, tlr = 0.05, 0.01
    jcfg = jax_zoo.get_config("ncf", table_scale=1000)
    kw = dict(optimizer="sgd", learning_rate=lr, loss="mse", sparse_tables=True,
              table_learning_rate=tlr, dedup=dedup)
    single = jax_train.Trainer(jcfg, seed=0, **kw)
    start = bridge.params_from_numpy(jax.device_get(single.params), single.cfg, "cpu")
    pcfg = zoo.get_config("ncf", table_scale=1000)
    port_single = train.Trainer(pcfg, device="cpu", params=start, **kw)
    port_mesh = train.Trainer(pcfg, mesh=_mesh(2, 4), params=start, **kw)
    host, targets = _ncf_step_inputs(pcfg)
    batch = JaxBatch(dense=None, indices=jnp.asarray(host.indices))
    p1, o1, l1 = single._step(single.params, single.opt_state, batch, jnp.asarray(targets))
    l2 = port_single.step(host, targets)
    l3 = port_mesh.step(host, targets)
    assert abs(float(l1) - float(l3)) < 1e-5 and abs(float(l2) - float(l3)) < 1e-5
    full = port_mesh.full_params()
    for want_t, want_a in ((np.asarray(p1["tables"]), np.asarray(o1[1])),
                           (port_single.params["tables"].numpy(),
                            port_single.opt_state[1].numpy())):
        np.testing.assert_allclose(full["tables"].numpy(), want_t, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(_full_acc(port_mesh).numpy(), want_a, rtol=1e-4, atol=1e-7)


def _dryrun_cfg(cls):
    """``__graft_entry__.py``'s tiny "dot" DLRM at the kernels' narrowest
    width (d = 32: K1 and K1b take d 32 or 64)."""
    return cls(model_type="dlrm", model_name="dryrun", mlp_bot=(16, 32), mlp_top=(16, 8, 1),
               embedding_rows=(64, 64, 32, 32), sparse_feature_size=32,
               num_indices_per_lookup=4, interaction_op="dot")


@pytest.mark.parametrize("name", ["rm1", "dryrun"])
def test_make_train_step_matches_jax(name):
    """``make_train_step`` on a 2x4 mesh, three SGD steps on one batch
    (JAX ``test_train_step_runs_and_reduces_loss``)."""
    if name == "dryrun":
        pcfg, jcfg = _dryrun_cfg(ModelConfig), _dryrun_cfg(JaxModelConfig)
    else:
        pcfg = zoo.get_config(name, table_scale=SCALE)
        jcfg = jax_zoo.get_config(name, table_scale=SCALE)
    np_params = bridge.init_numpy(pcfg, 0)
    jmodel, model = jax_get_model(jcfg), get_model(pcfg, "cpu")
    gen = JaxGenerator(jcfg, seed=2)
    host = gen.generate_batch(16)
    targets = gen.generate_targets(16, round_targets=True)
    jsp = jax_shard_params(jax.tree_util.tree_map(jnp.asarray, np_params), _jax_mesh(2, 4))
    jstep = jax_make_train_step(jmodel.apply, _jax_mesh(2, 4), has_dense=True, learning_rate=0.1,
                                loss="bce")(jsp)
    sp = shard_params(bridge.params_from_numpy(np_params, pcfg, "cpu"), _mesh(2, 4))
    step = make_train_step(model, _mesh(2, 4), has_dense=True, learning_rate=0.1, loss="bce")(sp)
    jbatch = JaxBatch(dense=jnp.asarray(host.dense), indices=jnp.asarray(host.indices))
    pbatch = Batch(dense=torch.from_numpy(host.dense), indices=torch.from_numpy(host.indices))
    want, got = [], []
    for _ in range(STEPS):
        jsp, jl = jstep(jsp, jbatch, jnp.asarray(targets))
        sp2, pl = step(sp, pbatch, torch.from_numpy(np.asarray(targets)))
        assert sp2 is sp
        want.append(float(jl))
        got.append(float(pl))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    wflat = bridge.flatten(jax.device_get(jsp))
    gflat = bridge.flatten(bridge.params_to_numpy(unshard_params(sp), pcfg))
    for key, w in wflat.items():
        np.testing.assert_allclose(gflat[key], np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("mode", ["dense", "sparse", "make_train_step"])
def test_one_device_2x2_matches_1x1(mode):
    """On a mesh of one device, the entries of a column share their shard
    and every entry shares the towers: a 2x2 step must update each tensor
    once, with the mean gradient, as a 1x1 step does."""
    cfg = zoo.get_config("rm1", table_scale=SCALE)
    start = bridge.params_from_numpy(bridge.init_numpy(cfg, 3), cfg, "cpu")
    gen = RecDataGenerator(cfg, seed=4)
    hosts = [gen.generate_batch(BATCH) for _ in range(STEPS)]
    runs = []
    for D, M in ((1, 1), (2, 2)):
        mesh = make_mesh(D, M, devices=["cpu"] * (D * M))
        if mode == "make_train_step":
            sp = shard_params(bridge.tree_map(lambda t: t.clone(), start), mesh)
            step = make_train_step(get_model(cfg, "cpu"), mesh, has_dense=True,
                                   learning_rate=0.05, loss="bce")(sp)
            losses = [float(step(sp, h, torch.from_numpy(
                (h.dense.mean(1) > 0).astype(np.float32)[:, None]))[1]) for h in hosts]
            runs.append((losses, unshard_params(sp), None))
            continue
        tr = train.Trainer(cfg, mesh=mesh, optimizer="adagrad", learning_rate=0.05,
                           sparse_tables=mode == "sparse", params=start)
        losses = [float(tr.step(h, tr._labels(h, None))) for h in hosts]
        runs.append((losses, tr.full_params(), _full_acc(tr) if mode == "sparse" else None))
    (l1, p1, a1), (l2, p2, a2) = runs
    np.testing.assert_allclose(l2, l1, rtol=1e-5)
    f1, f2 = bridge.flatten(p1), bridge.flatten(p2)
    for key in f1:
        np.testing.assert_allclose(f2[key].numpy(), f1[key].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=key)
    if a1 is not None:
        np.testing.assert_allclose(a2.numpy(), a1.numpy(), rtol=1e-5, atol=1e-7)


def test_mesh_trainer_evaluates_and_exports_whole_params():
    cfg = zoo.get_config("rm1", table_scale=SCALE)
    start = bridge.params_from_numpy(bridge.init_numpy(cfg, 5), cfg, "cpu")
    single = train.Trainer(cfg, optimizer="sgd", device="cpu", params=start)
    tr = train.Trainer(cfg, mesh=_mesh(2, 4), optimizer="sgd", params=start)
    for t in (single, tr):
        t.fit(2, batch_size=BATCH, seed=1)
    assert tr.evaluate(RecDataGenerator(tr.cfg, seed=5), 64) == pytest.approx(
        single.evaluate(RecDataGenerator(single.cfg, seed=5), 64), rel=1e-6)
    full = tr.full_params()
    assert full["tables"].shape == single.params["tables"].shape
    sp, scfg = train.export_serving_params(tr.params, tr.cfg, table_quant="int8_rowwise")
    want, _ = train.export_serving_params(full, tr.cfg, table_quant="int8_rowwise")
    assert torch.equal(sp["tables"]["qrows"], want["tables"]["qrows"])


def test_sharded_sparse_rows_must_divide():
    cfg = zoo.get_config("dien", table_scale=SCALE)  # 15,250 rows
    assert cfg.total_rows % 4
    with pytest.raises(ValueError, match="pad tables to divide over the model axis"):
        train.make_sharded_sparse_table_step(get_model(cfg, "cpu"), cfg, None, 0.1, None,
                                             _mesh(1, 4))
    with pytest.raises(ValueError, match="pad tables to divide over the model axis"):
        train.Trainer(cfg, mesh=_mesh(1, 4), sparse_tables=True)
    # dien at table_scale 2000 trains sparse on model axis 2.
    tr = train.Trainer(cfg, mesh=_mesh(2, 2), sparse_tables=True, learning_rate=0.05)
    assert np.isfinite(tr.fit(2, batch_size=16).losses).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_update_shard_copies_leaves_every_copy_equal(dtype):
    """The sharded sparse step's update of one shard over explicit clones
    (copies on distinct cards): K5's window once on copy 0, then its
    touched rows copied into the others, so every copy of the table and
    the accumulator equals copy 0 bit for bit, and copy 0 is one window
    step."""
    cfg = zoo.get_config("rm1", table_scale=SCALE)
    rps = cfg.total_rows // 4
    row_lo = rps  # shard 1 of 4
    gen = torch.Generator().manual_seed(3)
    table = ((torch.rand((rps, cfg.sparse_feature_size), generator=gen) - 0.5) * 0.1).to(dtype)
    acc = torch.rand((rps,), generator=gen) * 1e-3
    batch = RecDataGenerator(cfg, seed=4).generate_batch(2 * BATCH)
    offsets = torch.as_tensor(cfg.table_offsets, dtype=torch.int32)
    indices = torch.as_tensor(batch.indices)
    g = torch.randn((2 * BATCH, cfg.num_tables, cfg.sparse_feature_size), generator=gen) * 1e-2
    tables = [table.clone() for _ in range(3)]
    accs = [acc.clone() for _ in range(3)]
    train.update_shard_copies(tables, accs, offsets, indices, g, row_lo, 0.1)
    want_t, want_a = table.clone(), acc.clone()
    train.sparse_adagrad_step_shard(want_t, want_a, offsets, indices, g, row_lo, 0.1)
    assert torch.equal(tables[0], want_t) and torch.equal(accs[0], want_a)
    assert not torch.equal(tables[0], table)  # the step touched the shard
    for t, a in zip(tables[1:], accs[1:]):
        assert torch.equal(t, tables[0]) and torch.equal(a, accs[0])
