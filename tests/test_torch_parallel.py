"""The port's multi-device serving against the JAX package's, on the CPU.

The JAX tests run every mesh path on a virtual 8-device CPU mesh
(``tests/conftest.py``); the port runs the same paths on
``make_mesh(..., devices=["cpu"] * 8)``, whose entries name one device.
Both take the same seeded numpy inputs and weights (``bridge.init_numpy``).
Covered: ``make_mesh``; ``shard_params`` (shared shards, the odd-rows
replication); ``shard_local_indices`` and ``masked_pooled_psum``; the
row-sharded lookup and the plain versions of its kernels' window; the
shard's hot/cold lookups and the mesh splitters; ``sharded_apply`` for the
zoo's families and the int8 layouts; ``make_hotcold_model(mesh=)`` in the
tensor-parallel and hybrid modes; mesh engines (``run_serving``, payload and
ragged requests, refresh, reload) and ``ServingServer(mesh=)``.

Tolerances:
- f32 lookups: rtol/atol 1e-5 (the same sums in another order);
- model outputs: rtol 2e-4, atol 2e-5 (the JAX tests'), against JAX's
  sharded output and the port's single-device output;
- per-table int8 pools, the splitters, the ladders: exact.
"""

import queue
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu.models import get_model as jax_get_model
from deeprecsys_tpu.models import hotcold as jax_hotcold
from deeprecsys_tpu.models.base import Batch as JaxBatch
from deeprecsys_tpu.ops import embedding as jax_emb
from deeprecsys_tpu.parallel import make_mesh as jax_make_mesh
from deeprecsys_tpu.parallel import sharding as jax_sharding
from deeprecsys_tpu_torch import ServingConfig, bridge, zoo
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.models import get_model, hotcold
from deeprecsys_tpu_torch.models.base import Batch
from deeprecsys_tpu_torch.ops import embedding as emb
from deeprecsys_tpu_torch.ops import hotcold as ops_hc
from deeprecsys_tpu_torch.parallel import (
    distributed_init, make_mesh, shard_params, sharded_apply, sharded_embedding_bag)
from deeprecsys_tpu_torch.parallel import sharding
from deeprecsys_tpu_torch.serving import engine, packets, run_serving

SCALE = 5000       # tests/test_parallel.py's table scale
CPU8 = ["cpu"] * 8
RTOL = ATOL = 1e-5
MODEL_RTOL, MODEL_ATOL = 2e-4, 2e-5
AXES = [(1, 8), (2, 4), (4, 2), (8, 1)]
QUANTS = ("none", "int8", "int8_rowwise")


def _mesh(D, M):
    return make_mesh(D, M, devices=CPU8[:D * M])


def _jax_mesh(D, M):
    return jax_make_mesh(data=D, model=M, devices=jax.devices()[:D * M])


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _jbatch(b):
    return JaxBatch(dense=None if b.dense is None else jnp.asarray(b.dense),
                    indices=jnp.asarray(b.indices),
                    mask=None if b.mask is None else jnp.asarray(b.mask))


def _models(name, scale=SCALE, quant="none", seed=0):
    """The port's and the JAX package's model on the same numpy weights."""
    port_cfg = zoo.get_config(name, table_scale=scale, table_quant=quant)
    jax_cfg = jax_zoo.get_config(name, table_scale=scale, table_quant=quant)
    np_params = bridge.init_numpy(port_cfg, seed)
    return (get_model(port_cfg, "cpu"), bridge.params_from_numpy(np_params, port_cfg, "cpu"),
            jax_get_model(jax_cfg), jax.tree_util.tree_map(jnp.asarray, np_params))


# ---------------------------------------------------------------- the mesh


def test_make_mesh_shapes_equal_jax():
    for kw in ({}, {"data": 4, "model": 2}, {"model": 4}, {"data": 2}):
        m, jm = make_mesh(devices=CPU8, **kw), jax_make_mesh(**kw)
        assert m.shape == dict(jm.shape), kw
        assert m.devices.shape == jm.devices.shape
    assert make_mesh(devices=CPU8).shape == {"data": 8, "model": 1}
    with pytest.raises(ValueError):
        make_mesh(data=3, model=3, devices=CPU8)
    with pytest.raises(ValueError):
        make_mesh(model=3, devices=CPU8)
    m = make_mesh(2, 2, devices=["cpu"] * 4)
    assert m.devices.flat[0] == torch.device("cpu") and m.size == 4
    assert m.distinct_devices == [torch.device("cpu")]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA card is present")
def test_make_mesh_without_a_card_raises():
    """devices=None takes every visible CUDA device and never the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_mesh()
    distributed_init()  # one process: a no-op, as in JAX
    with pytest.raises(RuntimeError, match="'nccl' needs CUDA cards"):
        distributed_init("localhost:1234", num_processes=2, process_id=0, backend="nccl")


def test_shard_params_shares_one_tensor_a_device_and_shard():
    """Entries of one device and one shard share their shard (a 2x2 mesh of
    one card holds the table once); every other leaf has one copy a
    device; a table already on its device is sharded into views."""
    model, params, _, _ = _models("rm1")
    mesh = _mesh(2, 4)
    sp = shard_params(params, mesh)
    R = params["tables"].shape[0]
    assert sp.rows_per_shard == R // 4
    for m in range(4):
        assert sp.entry(0, m)["tables"] is sp.entry(1, m)["tables"]
        assert sp.entry(0, m)["tables"].data_ptr() == params["tables"][m * R // 4].data_ptr()
    assert sp.entry(0, 0)["tables"] is not sp.entry(0, 1)["tables"]
    assert sp.entry(1, 3)["top"][0]["w"] is sp.entry(0, 0)["top"][0]["w"]
    assert len(sp.tensors()) == 4 + len(bridge.flatten({k: v for k, v in params.items()
                                                         if k != "tables"}))


def test_odd_rows_replicate_with_the_jax_warning(capsys):
    """A table whose rows do not divide the model axis is replicated (JAX
    sharding.py:58-78), and the forward still matches."""
    model, params, _, _ = _models("ncf")
    mesh = _mesh(1, 8)
    assert params["tables"].shape[0] % 8
    specs = sharding.param_shardings(params, mesh)
    assert specs["tables"] == "replicated" and specs["mlp"][0]["w"] == "replicated"
    assert "does not divide the model axis (8); replicating it" in capsys.readouterr().out
    sp = shard_params(params, mesh)
    assert sp.rows_per_shard is None and sp.entry(0, 5)["tables"] is params["tables"]
    batch = RecDataGenerator(model.cfg, seed=1).generate_batch(8).to("cpu")
    np.testing.assert_allclose(sharded_apply(model, mesh, False)(sp, batch).numpy(),
                               model.apply(params, batch).numpy(),
                               rtol=MODEL_RTOL, atol=MODEL_ATOL)


# ------------------------------------------------------- row-sharded lookups


def _lookup_case(seed=0, d=32, B=8, L=5):
    rng = np.random.default_rng(seed)
    rows = [40, 32, 24]  # 96 rows: divides 1, 2, 4 and 8 shards
    table = rng.normal(size=(sum(rows), d)).astype(np.float32)
    offsets = np.array([0, 40, 72], dtype=np.int32)
    idx = np.stack([np.stack([rng.integers(0, n, size=L) for n in rows])
                    for _ in range(B)]).astype(np.int32)
    mask = rng.random(idx.shape) < 0.7
    return table, offsets, idx, mask


def test_shard_local_indices_and_masked_pooled_psum_equal_jax():
    """The plain functions against JAX's inside its shard_map over "model"
    (sharding.py:102-130): each shard's (safe, valid), and the pooled sum."""
    from jax import shard_map

    table, offsets, idx, _ = _lookup_case(1)
    M, rps = 4, table.shape[0] // 4
    mesh = jax_make_mesh(data=1, model=M, devices=jax.devices()[:M])

    def local(tbl, offs, ids):
        safe, valid = jax_sharding.shard_local_indices(ids, offs, rps)
        pooled = jax_sharding.masked_pooled_psum(tbl, safe, valid)
        return safe[None], valid[None], pooled

    safe_j, valid_j, pooled_j = shard_map(
        local, mesh=mesh, in_specs=(P("model", None), P(), P()),
        out_specs=(P("model"), P("model"), P()), check_vma=False)(
        jnp.asarray(table), jnp.asarray(offsets), jnp.asarray(idx))
    safes, valids = [], []
    for m in range(M):
        safe, valid = sharding.shard_local_indices(_t(idx), _t(offsets), rps, m)
        np.testing.assert_array_equal(safe.numpy(), np.asarray(safe_j)[m])
        np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j)[m])
        safes.append(safe)
        valids.append(valid)
    shards = [_t(table[m * rps:(m + 1) * rps]) for m in range(M)]
    got = sharding.masked_pooled_psum(shards, safes, valids)
    np.testing.assert_allclose(got.numpy(), np.asarray(pooled_j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_window_plain_versions_sum_to_the_direct_lookup(masked):
    """The plain versions of K1, K1-int8 and K4 with the window: the shards'
    partials add up to the direct lookup (int8: bit for bit), and a slot
    another shard owns adds nothing."""
    table, offsets, idx, mask = _lookup_case(2)
    mask_t = _t(mask) if masked else None
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.integers(-127, 128, table.shape).astype(np.int8))
    qrows = emb.quantize_rowwise_int8(_t(table))
    scale = torch.tensor([0.01, 0.02, 0.03], dtype=torch.float32)
    for M in (2, 4, 8):
        rps = table.shape[0] // M
        win = [(m * rps, (m + 1) * rps) for m in range(M)]
        f = sum(emb.embedding_bag_shard(_t(table)[lo:hi], _t(offsets), _t(idx), lo, mask=mask_t)
                for lo, hi in win)
        want = emb.embedding_bag(_t(table), _t(offsets), _t(idx), mask=mask_t)
        np.testing.assert_allclose(f.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
        i8 = sum(emb.embedding_bag_int8_shard(q[lo:hi], _t(offsets), _t(idx), lo, mask=mask_t)
                 for lo, hi in win)
        assert i8.dtype == torch.int32
        assert torch.equal((i8.float() * scale[None, :, None]).to(torch.bfloat16),
                           emb.embedding_bag_int8(q, scale, _t(offsets), _t(idx),
                                                  compute_dtype=torch.bfloat16, mask=mask_t))
        rw = sum(emb.embedding_bag_int8_rowwise_shard(qrows[lo:hi], _t(offsets), _t(idx), lo,
                                                      mask=mask_t) for lo, hi in win)
        want = emb.embedding_bag_int8_rowwise(qrows, _t(offsets), _t(idx), mask=mask_t)
        np.testing.assert_allclose(rw.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)
    # Id 3 of every table: fused rows 3, 43 and 75; the window [0, 8) owns
    # only the first, and the other tables' bags add nothing.
    part = emb.embedding_bag_shard(_t(table)[:8], _t(offsets), _t(idx) * 0 + 3, 0)
    assert part[:, 0].abs().sum() > 0 and not part[:, 1:].any()
    with pytest.raises(ValueError, match="row_lo"):
        emb.embedding_bag_shard(_t(table), _t(offsets), _t(idx), -1)


@pytest.mark.parametrize("D,M", [(2, 4), (1, 8), (8, 1)])
def test_sharded_embedding_bag_matches_jax_and_single_device(D, M):
    table, offsets, idx, _ = _lookup_case(0)
    got = sharded_embedding_bag(_t(table), _t(offsets), _t(idx), _mesh(D, M), table.shape[0])
    want = jax_sharding.sharded_embedding_bag(jnp.asarray(table), jnp.asarray(offsets),
                                              jnp.asarray(idx), _jax_mesh(D, M), table.shape[0])
    single = emb.embedding_bag(_t(table), _t(offsets), _t(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=RTOL, atol=ATOL)


def test_sharded_embedding_bag_requires_divisibility():
    """JAX raises an AssertionError (sharding.py:154); the port a
    ValueError with its text, and ``pad_rows_for_mesh`` says the fix."""
    mesh = _mesh(2, 4)
    with pytest.raises(ValueError, match="must divide over model axis 4"):
        sharded_embedding_bag(torch.zeros((10, 32)), torch.zeros(1, dtype=torch.int32),
                              torch.zeros((2, 1, 1), dtype=torch.int32), mesh, 10)
    with pytest.raises(AssertionError):
        jax_sharding.sharded_embedding_bag(jnp.zeros((10, 8)), jnp.zeros(1, jnp.int32),
                                           jnp.zeros((2, 1, 1), jnp.int32), jax_make_mesh(2, 4),
                                           10)
    cfg = zoo.get_config("rm1", table_scale=SCALE)
    for n in (1, 3, 7, 8):
        assert sharding.pad_rows_for_mesh(cfg, n) == jax_sharding.pad_rows_for_mesh(
            jax_zoo.get_config("rm1", table_scale=SCALE), n)


# ----------------------------------------------------------- sharded_apply


@pytest.fixture(scope="module")
def jax_sharded_outputs():
    """JAX's sharded_apply on (data=4, model=2), computed once a model."""
    cache = {}

    def get(name, quant="none", seed=0, batch_seed=1):
        key = (name, quant, seed, batch_seed)
        if key not in cache:
            # rm2's tables at SCALE hold 100 rows, fewer than its L = 120.
            model, params, jmodel, jparams = _models(name, scale=1000 if name == "rm2" else SCALE,
                                                     quant=quant, seed=seed)
            host = RecDataGenerator(model.cfg, seed=batch_seed).generate_batch(8)
            mesh = jax_make_mesh(data=4, model=2)
            fn = jax_sharding.sharded_apply(jmodel.apply, jparams, mesh,
                                            has_dense=host.dense is not None)
            out = fn(jax_sharding.shard_params(jparams, mesh), _jbatch(host))
            cache[key] = (model, params, host, np.asarray(out, np.float32))
        return cache[key]

    return get


@pytest.mark.parametrize("name", ["rm1", "ncf", "din", "dien", "wnd", "mtwnd", "rm3", "rm2"])
def test_sharded_apply_matches_jax_and_single_device(jax_sharded_outputs, name):
    """JAX tests/test_parallel.py:59: the model over a (4, 2) mesh; also the
    port's single-device forward on the same weights."""
    model, params, host, want = jax_sharded_outputs(name)
    batch = host.to("cpu")
    mesh = _mesh(4, 2)
    fn = sharded_apply(model, mesh, has_dense=batch.dense is not None)
    sp = shard_params(params, mesh)
    out = fn(sp, batch)
    np.testing.assert_allclose(out.numpy(), want, rtol=MODEL_RTOL, atol=MODEL_ATOL)
    assert torch.equal(fn(sp, host), out)  # a host batch of numpy arrays
    with pytest.raises(TypeError, match="shard_params"):  # params are placed once, not a call
        fn(params, batch)
    np.testing.assert_allclose(out.numpy(), model.apply(params, batch).numpy(),
                               rtol=MODEL_RTOL, atol=MODEL_ATOL)


@pytest.mark.parametrize("quant", ["int8", "int8_rowwise"])
def test_sharded_apply_quantized_tables(jax_sharded_outputs, quant):
    """JAX tests/test_parallel.py:118: 2-D int8 leaves row-shard, the scale
    replicates. The per-table int8 lookup combines exact int32 partials and
    scales once: bit for bit the single-device K1-int8."""
    model, params, host, want = jax_sharded_outputs("ncf", quant)
    batch = host.to("cpu")
    mesh = _mesh(4, 2)
    specs = sharding.param_shardings(params, mesh)
    key2d = "qrows" if quant == "int8_rowwise" else "q"
    assert specs["tables"][key2d] == "model"
    if quant == "int8":
        assert specs["tables"]["scale"] == "replicated"
    sp = shard_params(params, mesh)
    out = sharded_apply(model, mesh, has_dense=False)(sp, batch)
    np.testing.assert_allclose(out.numpy(), want, rtol=MODEL_RTOL, atol=MODEL_ATOL)
    np.testing.assert_allclose(out.numpy(), model.apply(params, batch).numpy(),
                               rtol=MODEL_RTOL, atol=MODEL_ATOL)
    if quant == "int8":  # each data slice's pooled lookup: K1-int8's bits
        offs = sharding.Replicated(mesh, torch.as_tensor(model.cfg.table_offsets,
                                                         dtype=torch.int32))
        for d, sl in enumerate(sharding.split_batch(batch, mesh)):
            single = emb.embedding_bag_int8(params["tables"]["q"], params["tables"]["scale"],
                                            offs.on(torch.device("cpu")), sl.indices)
            assert torch.equal(sharding.pooled_on_row(sp, d, sl, model.cfg, offs), single)


def test_sharded_apply_on_packed_jax_tables():
    """The JAX package's row-packed tables (tests/test_parallel.py:374-446)
    reach the port through ``bridge.params_from_numpy``, which unpacks
    them: the port keeps ``(R, d)`` rows, a deliberate difference. The
    sharded forward on the unpacked table matches JAX's on the packed one."""
    jcfg = jax_zoo.get_config("rm1", table_scale=SCALE).replace(table_pack=2)
    pcfg = zoo.get_config("rm1", table_scale=SCALE).replace(table_pack=2)
    np_params = bridge.init_numpy(pcfg, 1)
    assert "packed" in np_params["tables"]
    params = bridge.params_from_numpy(np_params, pcfg, "cpu")
    assert isinstance(params["tables"], torch.Tensor)
    assert params["tables"].shape == (pcfg.total_rows, pcfg.sparse_feature_size)
    host = RecDataGenerator(pcfg, seed=6).generate_batch(8)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    jmesh = jax_make_mesh(2, 4)
    want = jax_sharding.sharded_apply(jax_get_model(jcfg).apply, jparams, jmesh, True)(
        jax_sharding.shard_params(jparams, jmesh), _jbatch(host))
    model, mesh = get_model(pcfg, "cpu"), _mesh(2, 4)
    got = sharded_apply(model, mesh, True)(shard_params(params, mesh), host.to("cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MODEL_RTOL, atol=MODEL_ATOL)


# ------------------------------------------------------ hot/cold over a mesh


def _hc_case(seed):
    rng = np.random.default_rng(seed)
    R, d = 512, 32
    table = rng.normal(size=(R, d)).astype(np.float32)
    offsets = np.array([0, 200], dtype=np.int64)
    idx = rng.integers(0, np.array([200, 312])[None, :, None], size=(8, 2, 6)).astype(np.int32)
    hot_ids = np.sort(rng.choice(R, size=48, replace=False)).astype(np.int64)
    return table, offsets, idx, hot_ids


def _direct(table, offsets, idx):
    return emb.embedding_bag(_t(table), _t(offsets.astype(np.int32)), _t(idx)).numpy()


@pytest.mark.parametrize("M", [2, 4, 8])
def test_sharded_hotcold_matches_jax_and_direct(M):
    """JAX tests/test_parallel.py:141, :507: the tensor-parallel hot/cold
    lookup; also with an empty hot set (every lookup cold)."""
    table, offsets, idx, hot_ids = _hc_case(13 + M)
    jmesh = _jax_mesh(8 // M, M)
    for hot in (np.empty(0, np.int64), hot_ids):
        split = ops_hc.split_hot_cold_sharded(idx, offsets, hot, n_shards=M,
                                              rows_per_shard=512 // M)
        assert split["cold_local"].shape[0] == M
        got = sharding.sharded_embedding_bag_hotcold(_t(table)[hot], _t(table), split,
                                                     _mesh(8 // M, M))
        np.testing.assert_allclose(got.numpy(), _direct(table, offsets, idx),
                                   rtol=RTOL, atol=ATOL)
    jsplit = {"hot_sel": jnp.asarray(split["hot_sel"]),
              "hot_mask": jnp.asarray(split["hot_mask"]),
              "cold_local": jax.device_put(jnp.asarray(split["cold_local"]),
                                           NamedSharding(jmesh, P("model", None))),
              "cold_seg": jax.device_put(jnp.asarray(split["cold_seg"]),
                                         NamedSharding(jmesh, P("model", None)))}
    want = jax_sharding.sharded_embedding_bag_hotcold(
        jnp.asarray(table[hot_ids]),
        jax.device_put(jnp.asarray(table), NamedSharding(jmesh, P("model", None))), jsplit, jmesh)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("D,M", AXES)
def test_hybrid_hotcold_matches_jax_and_direct(D, M):
    """JAX tests/test_parallel.py:259: a cold stream a (data, model) cell."""
    table, offsets, idx, hot_ids = _hc_case(17)
    split = ops_hc.split_hot_cold_hybrid(idx, offsets, hot_ids, n_data=D, n_model=M,
                                         rows_per_shard=512 // M)
    assert split["cold_local"].shape[:2] == (D, M)
    got = sharding.hybrid_embedding_bag_hotcold(_t(table)[hot_ids], _t(table), split,
                                                _mesh(D, M))
    np.testing.assert_allclose(got.numpy(), _direct(table, offsets, idx), rtol=RTOL, atol=ATOL)
    jmesh = _jax_mesh(D, M)

    def put(k, spec):
        return jax.device_put(jnp.asarray(split[k]), NamedSharding(jmesh, spec))

    jsplit = {"hot_sel": put("hot_sel", P("data", None, None)),
              "hot_mask": put("hot_mask", P("data", None, None)),
              "cold_local": put("cold_local", P("data", "model", None)),
              "cold_seg": put("cold_seg", P("data", "model", None))}
    want = jax.jit(lambda h, t, s: jax_sharding.hybrid_embedding_bag_hotcold(h, t, s, jmesh))(
        jnp.asarray(table[hot_ids]), jax.device_put(jnp.asarray(table),
                                                    NamedSharding(jmesh, P("model", None))),
        jsplit)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_shard_hotcold_plain_versions_sum_to_the_direct_lookup():
    """K6 on a shard (plain versions): the shards' partials, the hot hits on
    shard 0 only, add up to the direct lookup in all three layouts; per-table
    int8 bit for bit."""
    table, offsets, idx, hot_ids = _hc_case(5)
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.integers(-127, 128, table.shape).astype(np.int8))
    qrows = emb.quantize_rowwise_int8(_t(table))
    scale = torch.tensor([0.01, 0.03], dtype=torch.float32)
    M = 4
    split = ops_hc.split_hot_cold_sharded(idx, offsets, hot_ids, n_shards=M, rows_per_shard=128)
    hid = torch.from_numpy(hot_ids)
    parts = {"float": [], "int8": [], "int8_rowwise": []}
    for m in range(M):
        s = {"hot_sel": _t(split["hot_sel"]),
             "hot_mask": _t(split["hot_mask"]) if m == 0 else torch.zeros(idx.shape, dtype=bool),
             "cold_ids": _t(split["cold_local"][m]), "cold_seg": _t(split["cold_seg"][m])}
        lo, hi = m * 128, (m + 1) * 128
        parts["float"].append(emb.embedding_bag_hotcold_shard(_t(table)[hid], _t(table)[lo:hi], s))
        parts["int8"].append(emb.embedding_bag_hotcold_int8_shard(q[hid], q[lo:hi], s))
        parts["int8_rowwise"].append(emb.embedding_bag_hotcold_int8_rowwise_shard(
            qrows[hid], qrows[lo:hi], s))
    offs = _t(offsets.astype(np.int32))
    np.testing.assert_allclose(sum(parts["float"]).numpy(), _direct(table, offsets, idx),
                               rtol=RTOL, atol=ATOL)
    i8 = sum(parts["int8"])
    assert i8.dtype == torch.int32
    assert torch.equal((i8.float() * scale[None, :, None]),
                       emb.embedding_bag_int8(q, scale, offs, _t(idx)))
    np.testing.assert_allclose(sum(parts["int8_rowwise"]).numpy(),
                               emb.embedding_bag_int8_rowwise(qrows, offs, _t(idx)).numpy(),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("impl", ["numpy", "native"])
def test_mesh_splitters_equal_jax_bit_for_bit(impl, masked):
    """split_hot_cold_sharded and _hybrid: the JAX arrays exactly, n_cold,
    the bucketed C_pad and the pad segment, on rm1's ids (JAX
    ops/embedding.py:649-735), with and without the ragged mask."""
    from deeprecsys_tpu_torch.runtime import native

    if impl == "native" and not native.native_available():
        pytest.fail("the native splitter did not build")
    cfg = zoo.get_config("rm1", table_scale=SCALE)
    idx = RecDataGenerator(cfg, seed=3).generate_batch(16).indices
    mask = np.random.default_rng(2).random(idx.shape) < 0.7 if masked else None
    offsets = np.asarray(cfg.table_offsets, dtype=np.int64)
    hot_ids = hotcold.hot_ids_from_generator(cfg, seed=5, hot_rows=256, n_batches=2,
                                             batch_size=64)
    total = cfg.total_rows
    for D, M in AXES + [(1, 4), (2, 2)]:
        buckets = hotcold.cold_buckets_for(idx.size, _mesh(D, M))
        got = ops_hc.split_hot_cold_hybrid(idx, offsets, hot_ids, D, M, total // M,
                                           cold_buckets=buckets, impl=impl, slot_mask=mask)
        want = jax_emb.split_hot_cold_hybrid(idx, offsets, hot_ids, D, M, total // M,
                                             cold_buckets=buckets, impl=impl, slot_mask=mask)
        assert got["n_cold"] == want["n_cold"]
        for k in ("hot_sel", "hot_mask", "cold_local", "cold_seg"):
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (D, M, k)
        if D == 1:
            got = ops_hc.split_hot_cold_sharded(idx, offsets, hot_ids, M, total // M,
                                                cold_buckets=buckets, impl=impl, slot_mask=mask)
            want = jax_emb.split_hot_cold_sharded(idx, offsets, hot_ids, M, total // M,
                                                  cold_buckets=buckets, impl=impl,
                                                  slot_mask=mask)
            for k in ("hot_sel", "hot_mask", "cold_local", "cold_seg"):
                assert np.array_equal(got[k], want[k]), (M, k)
            assert got["n_cold"] == want["n_cold"]


@pytest.mark.parametrize("n", [8, 640, 327_680, 655_361])
def test_cold_buckets_for_mesh_equal_jax(n):
    for D, M in AXES + [(1, 4), (2, 2)]:
        assert hotcold.cold_buckets_for(n, _mesh(D, M)) == jax_hotcold.cold_buckets_for(
            n, _jax_mesh(D, M))


def test_descriptor_wall_scaling_counters():
    """JAX tests/test_parallel.py:464, on the port's splitters: each
    shard's cold descriptors divide by the model axis, and each data
    shard's segments are its local batch slice."""
    cfg = zoo.get_config("rm1", table_scale=SCALE)
    B, T = 64, cfg.num_tables
    total = int(cfg.total_rows)
    offsets = np.asarray(cfg.table_offsets)
    idx = np.asarray(RecDataGenerator(cfg, seed=3).generate_batch(B).indices)
    hot_ids = hotcold.hot_ids_from_generator(cfg, seed=5, hot_rows=256, n_batches=2,
                                             batch_size=64)
    per_m = {}
    for M in (1, 2, 4, 8):
        s = ops_hc.split_hot_cold_sharded(idx, offsets, hot_ids, n_shards=M,
                                          rows_per_shard=total // M)
        counts = (s["cold_seg"] != B * T).sum(axis=-1)
        assert counts.shape == (M,) and counts.sum() == s["n_cold"]
        assert counts.max() <= np.ceil(s["n_cold"] / M) * 1.3
        per_m[M] = int(counts.max())
    assert per_m[2] <= per_m[1] * 0.65
    assert per_m[8] <= per_m[1] * 0.17
    for D, M in AXES:
        s = ops_hc.split_hot_cold_hybrid(idx, offsets, hot_ids, n_data=D, n_model=M,
                                         rows_per_shard=total // M)
        pad_seg = (B // D) * T
        counts = (s["cold_seg"] != pad_seg).sum(axis=-1)
        assert counts.shape == (D, M) and counts.sum() == s["n_cold"]
        assert counts.max() <= np.ceil(s["n_cold"] / (D * M)) * 1.4
        real = s["cold_seg"][s["cold_seg"] != pad_seg]
        assert real.size == 0 or real.max() < pad_seg


@pytest.fixture(scope="module")
def jax_hotcold_outputs():
    """JAX's hot/cold model over a mesh, computed once a (layout, axes)."""
    cache = {}

    def get(quant, D, M):
        key = (quant, D, M)
        if key not in cache:
            model, params, jmodel, jparams = _models("rm1", quant=quant, seed=1)
            host = RecDataGenerator(model.cfg, seed=6).generate_batch(8)
            hot_ids = hotcold.hot_ids_from_generator(model.cfg, seed=5, hot_rows=48,
                                                     n_batches=2, batch_size=32)
            jmesh = _jax_mesh(D, M)
            hc = jax_hotcold.make_hotcold_model(jmodel, hot_ids, mesh=jmesh)
            hp = jax_sharding.shard_params(hc.convert_params(jparams), jmesh)
            split = hc.prepare(_jbatch(host))
            hot = P("data", None, None) if D > 1 else P()
            cold = P("data", "model", None) if D > 1 else P("model", None)
            dev = {k: jax.device_put(jnp.asarray(v), NamedSharding(
                jmesh, hot if k in ("hot_sel", "hot_mask") else cold))
                for k, v in split.items() if k != "n_cold"}
            want = np.asarray(jax.jit(hc.apply)(hp, _jbatch(host), dev), np.float32)
            cache[key] = (model, params, host, hot_ids, want)
        return cache[key]

    return get


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("D,M", AXES)
def test_hotcold_model_on_a_mesh_matches_jax_and_single_device(jax_hotcold_outputs, quant,
                                                               D, M):
    """make_hotcold_model(mesh=) in the tensor-parallel (D = 1) and hybrid
    modes, in the three table layouts (JAX tests/test_parallel.py:196,
    :325): against JAX's hot/cold model on the same mesh and the port's
    single-device direct forward."""
    model, params, host, hot_ids, want = jax_hotcold_outputs(quant, D, M)
    mesh = _mesh(D, M)
    hc = hotcold.make_hotcold_model(model, hot_ids, mesh=mesh)
    sp = shard_params(hc.convert_params(params), mesh)
    split = hc.prepare(host)
    assert ("cold_local" in split and split["cold_local"].shape[:-1]
            == ((M,) if D == 1 else (D, M)))
    got = hc.apply(sp, Batch(dense=_t(host.dense), indices=None), split)
    np.testing.assert_allclose(got.numpy(), want, rtol=MODEL_RTOL, atol=MODEL_ATOL)
    np.testing.assert_allclose(got.numpy(), model.apply(params, host.to("cpu")).numpy(),
                               rtol=MODEL_RTOL, atol=MODEL_ATOL)


def test_gather_rows_reads_raw_rows_from_their_shards():
    """The mesh refresh's hot table: raw rows of the table's layout,
    gathered from the shards that own them (int8 ``q``, ``qrows``)."""
    for quant in QUANTS:
        model, params, _, _ = _models("rm1", quant=quant)
        tables = params["tables"]
        leaf = tables if quant == "none" else tables["qrows" if quant == "int8_rowwise" else "q"]
        ids = np.sort(np.random.default_rng(0).choice(leaf.shape[0], 40, replace=False))
        for D, M in ((1, 8), (2, 4)):
            sp = shard_params(params, _mesh(D, M))
            assert torch.equal(sharding.gather_rows(sp, ids), leaf[torch.from_numpy(ids)])


# --------------------------------------------------------------- engines


def _scfg(**kw):
    base = dict(engine_backend="cpu", batch_buckets=(8,), max_mini_batch_size=8)
    base.update(kw)
    return ServingConfig(**base)


class _MeshEngine:
    def __init__(self, cfg, scfg, mesh, params=None):
        self.cfg = cfg
        self.req_q, self.resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
        self.engine = engine.ComputeEngine(0, cfg, scfg, self.req_q, self.resp_q, ready_q,
                                           mesh=mesh, params=params)
        self.engine.start()
        got = ready_q.get(timeout=300)
        assert not isinstance(got, Exception), got
        self.n = 0

    def predict(self, indices, dense=None, mask=None):
        self.req_q.put(packets.ServiceRequest(
            batch_id=self.n, batch_size=len(indices), arrival_time=time.time(),
            payload=Batch(dense=dense, indices=indices, mask=mask)))
        self.n += 1
        r = self.resp_q.get(timeout=120)
        assert r.error_code == 0, r.error_code
        return r.scores

    def stop(self):
        self.req_q.put(None)
        self.engine.join(timeout=120)
        assert not self.engine.is_alive() and self.engine.error is None


def _payload(cfg, n, seed, masked=False):
    rng = np.random.default_rng(seed)
    rows = np.asarray(cfg.scaled_rows, dtype=np.int64)
    T, L = cfg.num_tables, cfg.num_indices_per_lookup
    idx = rng.integers(0, rows[None, :, None], size=(n, T, L)).astype(np.int32)
    dense = rng.normal(size=(n, cfg.dense_dim)).astype(np.float32) if cfg.dense_dim else None
    mask = rng.random((n, T, L)) < 0.6 if masked else None
    return idx, dense, mask


def _single_scores(cfg, params, idx, dense=None, mask=None):
    model = get_model(cfg.replace(embedding_impl="xla"), "cpu")
    with torch.inference_mode():
        return model.apply(params, Batch(dense=dense, indices=idx, mask=mask).to("cpu")).numpy()


def test_run_serving_on_a_mesh_end_to_end():
    """JAX tests/test_parallel.py:76: rm1 on a (4, 2) mesh through the whole
    serving stack; 24-row queries split [16, 8]."""
    cfg = ServingConfig(
        num_batches=10, nepochs=1, inference_engines=1, engine_backend="cpu",
        avg_arrival_rate_ms=0.5, batch_size_distribution="fixed",
        avg_mini_batch_size=24, max_mini_batch_size=64,
        batch_buckets=(8, 16, 32, 64), sub_task_batch_size=16, req_granularity=4, seed=21)
    res = run_serving(zoo.get_config("rm1", table_scale=SCALE), cfg, settle_s=0.01,
                      mesh=_mesh(4, 2))
    assert res.cpu_requests == 10
    assert res.num_responses == 20
    assert np.isfinite(res.p95_ms) and not res.engine_errors


def test_mesh_engine_buckets_round_up_to_the_data_axis():
    """JAX engine.py:140-151: buckets round up to a multiple of D."""
    scfg = _scfg(batch_buckets=(1, 6, 8, 30), max_mini_batch_size=30)
    qs = [queue.Queue() for _ in range(3)]
    eng = engine.ComputeEngine(0, zoo.get_config("ncf", table_scale=SCALE), scfg, *qs,
                               mesh=_mesh(4, 2))
    assert eng.buckets == (4, 8, 32) and eng.device == torch.device("cpu")


@pytest.mark.parametrize("impl,D,M", [("xla", 2, 4), ("xla", 8, 1), ("hotcold", 1, 8),
                                      ("hotcold", 2, 4)])
def test_mesh_engine_payload_and_ragged_scores(impl, D, M):
    """Payload and ragged requests through a mesh engine, direct and
    hot/cold (JAX tests/test_parallel.py:559): the port's single-device
    forward and the JAX model's on the same weights (rows that do not fill
    the bucket ride with pad rows)."""
    from tests.test_torch_ingress import _jax_scores

    cfg = zoo.get_config("rm1", table_scale=SCALE, embedding_impl=impl, hot_set_rows=64)
    np_params = bridge.init_numpy(cfg.replace(embedding_impl="xla"), 3)
    params = bridge.params_from_numpy(np_params, cfg, "cpu")
    srv = _MeshEngine(cfg, _scfg(accept_ragged=True), _mesh(D, M), params=params)
    try:
        assert (srv.engine._hotcold is not None) == (impl == "hotcold")
        for i, (n, masked) in enumerate(((8, False), (5, False), (8, True), (3, True))):
            idx, dense, mask = _payload(cfg, n, 40 + i, masked)
            got = srv.predict(idx, dense, mask)
            np.testing.assert_allclose(got, _single_scores(cfg, params, idx, dense, mask),
                                       rtol=MODEL_RTOL, atol=MODEL_ATOL)
            np.testing.assert_allclose(got, _jax_scores("rm1", SCALE, np_params, idx, dense,
                                                        mask), rtol=MODEL_RTOL, atol=MODEL_ATOL)
    finally:
        srv.stop()


@pytest.mark.parametrize("D,M", [(1, 8), (2, 4)])
def test_mesh_hotcold_refresh_recovers_from_drift(D, M):
    """JAX tests/test_parallel.py:595: a drifted head outside the hot set is
    refreshed in on a mesh engine (the hot rows gathered from the shards
    that own them, written into the hot table its programs read); scores
    equal the direct model through the swap."""
    cfg = zoo.get_config("ncf", table_scale=500).replace(embedding_impl="hotcold",
                                                          hot_set_rows=64)
    scfg = _scfg(sub_task_batch_size=8, hotcold_refresh_interval=4, hotcold_refresh_window=8,
                 hotcold_refresh_margin=0.05)
    srv = _MeshEngine(cfg, scfg, _mesh(D, M))
    try:
        eng = srv.engine
        assert eng._hotcold is not None
        hot = set(int(i) for i in eng._hotcold.hot_ids)
        pools = []
        for off, r in zip(cfg.table_offsets, cfg.scaled_rows):
            cold = [i for i in range(r) if (int(off) + i) not in hot][:6]
            assert len(cold) == 6
            pools.append(cold)
        T, L = cfg.num_tables, cfg.num_indices_per_lookup

        def drift(seed):
            rng = np.random.default_rng(seed)
            return np.stack([rng.choice(pools[t], size=(8, L)) for t in range(T)],
                            axis=1).astype(np.int32)

        old = eng.params.entry(0, 0)["hot_table"]
        for i in range(8):
            srv.predict(drift(i))
            if eng.hot_refreshes:
                break
        assert eng.hot_refreshes == 1, "mesh refresh never fired"
        assert eng.hot_coverage > 0.9
        new = eng.params.entry(D - 1, M - 1)["hot_table"]
        assert new is old  # the same tensor, now holding the new rows
        assert torch.equal(new, sharding.gather_rows(eng.params, eng._hotcold.hot_ids))
        params = {k: v for k, v in eng.params.entry(0, 0).items() if k not in ("hot_table",)}
        params["tables"] = torch.cat([eng.params.entry(0, m)["tables"] for m in range(M)])
        idx = drift(99)
        np.testing.assert_allclose(srv.predict(idx), _single_scores(cfg, params, idx),
                                   rtol=MODEL_RTOL, atol=MODEL_ATOL)
    finally:
        srv.stop()


@pytest.mark.parametrize("impl", ["xla", "hotcold"])
def test_mesh_engine_reloads_a_checkpoint(tmp_path, impl):
    """JAX engine.py:785-792: a reload loads on the first device and shards
    over the mesh; the next request scores with the new weights (a
    hot/cold engine keeps its hot ids, its hot table from the new tables)."""
    from deeprecsys_tpu_torch.utils.checkpoint import save_params

    cfg = zoo.get_config("rm1", table_scale=SCALE, embedding_impl=impl, hot_set_rows=64)
    base = cfg.replace(embedding_impl="xla")
    new_np = bridge.init_numpy(base, 77)
    save_params(tmp_path / "ck", new_np)
    srv = _MeshEngine(cfg, _scfg(), _mesh(2, 4))
    try:
        idx, dense, _ = _payload(cfg, 8, 5)
        before = srv.predict(idx, dense)
        handle = srv.engine.request_reload(str(tmp_path / "ck"))
        after = srv.predict(idx, dense)
        assert handle.event.wait(30) and handle.error is None
        new = bridge.params_from_numpy(new_np, base, "cpu")
        np.testing.assert_allclose(after, _single_scores(cfg, new, idx, dense),
                                   rtol=MODEL_RTOL, atol=MODEL_ATOL)
        assert not np.allclose(before, after)
        assert srv.engine.params.rows_per_shard == cfg.total_rows // 4
    finally:
        srv.stop()


def test_serving_server_ragged_predict_over_a_mesh(tmp_path):
    """Ragged /v1/predict through ServingServer(mesh=) with a thread engine
    (the mesh case of JAX tests/test_serving.py's ragged ingress test): the
    JAX model's direct masked forward on the same weights."""
    from tests.test_torch_ingress import _csr, _jax_scores, _post, _serve

    from deeprecsys_tpu_torch.data.ragged import pad_csr
    from deeprecsys_tpu_torch.serving.ingress import ServingServer
    from deeprecsys_tpu_torch.utils.checkpoint import save_params

    cfg = zoo.get_config("rm1", table_scale=SCALE)
    np_params = bridge.init_numpy(cfg, 4)
    save_params(tmp_path / "m", np_params)
    scfg = ServingConfig(engine_backend="cpu", inference_engines=1, sub_task_batch_size=8,
                         max_mini_batch_size=8, batch_buckets=(8,), accept_ragged=True)
    server = ServingServer(cfg, scfg, checkpoint_path=str(tmp_path / "m"), mesh=_mesh(2, 4))
    ing, base = _serve(server)
    try:
        assert server.engines[0].mesh.shape == {"data": 2, "model": 4}
        lengths, values, dense = _csr(cfg, 8, 9)
        status, out = _post(f"{base}/v1/predict", {
            "lengths": lengths.tolist(), "values": values.tolist(), "dense": dense.tolist()})
        assert status == 200
        idx, mask = pad_csr(lengths, values, cfg.num_indices_per_lookup)
        np.testing.assert_allclose(np.asarray(out["scores"], np.float32),
                                   _jax_scores("rm1", SCALE, np_params, idx, dense, mask),
                                   rtol=MODEL_RTOL, atol=MODEL_ATOL)
    finally:
        ing.stop()


def test_cpu_mp_ingress_refuses_a_mesh_like_jax():
    """A mesh with cpu-mp engine processes raises, as the JAX ingress does
    (ingress.py:121-125): a deliberate match, each child would shard over the
    same devices."""
    from deeprecsys_tpu.config import ServingConfig as JaxServingConfig
    from deeprecsys_tpu.serving.ingress import ServingServer as JaxServingServer

    from deeprecsys_tpu_torch.serving.ingress import ServingServer

    with pytest.raises(NotImplementedError, match="mesh with cpu-mp ingress"):
        ServingServer(zoo.get_config("ncf", table_scale=SCALE),
                      ServingConfig(engine_backend="cpu-mp"), mesh=_mesh(2, 4))
    with pytest.raises(NotImplementedError, match="mesh with cpu-mp ingress"):
        JaxServingServer(jax_zoo.get_config("ncf", table_scale=SCALE),
                         JaxServingConfig(engine_backend="cpu-mp"), mesh=jax_make_mesh(2, 4))


def test_build_engine_pool_passes_the_mesh_on():
    """run_serving(mesh=) and build_engine_pool(mesh=) hand the mesh to
    every compute engine, the offload engine too."""
    mesh = _mesh(2, 2)
    qs = [queue.Queue() for _ in range(5)]
    scfg = ServingConfig(engine_backend="cpu", inference_engines=2, model_accel=True)
    engines, total = engine.build_engine_pool(zoo.get_config("ncf", table_scale=SCALE), scfg,
                                              *qs[:4], mesh=mesh, accel_device="cpu")
    assert total == 3 and all(e.mesh is mesh for e in engines)
