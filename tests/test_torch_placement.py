"""The port's table-wise sharding against the JAX package's, on the CPU:
the placement planner (``parallel/placement.py``, a copy of the JAX
module, equal for every zoo config at 1, 2, 4 and 8 shards), the table-wise
layout, the table-wise lookup and the table-wise model
(``parallel/api.py``), on the 8-entry CPU mesh.

Tolerances: the placement and the layout exactly; f32 lookups rtol/atol
1e-5 against JAX's table-wise lookup and the port's single-device lookup;
per-table int8 pools bit for bit against the port's single-device K1-int8
plain version; models rtol 2e-4, atol 2e-5 (the JAX tests') against JAX's
table-wise model and the port's single-device forward.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu.config import ModelConfig as JaxModelConfig
from deeprecsys_tpu.models import get_model as jax_get_model
from deeprecsys_tpu.models.base import Batch as JaxBatch
from deeprecsys_tpu.parallel import make_mesh as jax_make_mesh
from deeprecsys_tpu.parallel.api import make_tablewise_model as jax_tablewise_model
from deeprecsys_tpu.parallel.placement import plan_tablewise_placement as jax_plan
from deeprecsys_tpu.parallel.sharding import build_tablewise_tables as jax_build
from deeprecsys_tpu.parallel.sharding import tablewise_embedding_bag as jax_tablewise
from deeprecsys_tpu_torch import bridge, zoo
from deeprecsys_tpu_torch.config import ModelConfig
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.models import get_model
from deeprecsys_tpu_torch.models.base import Batch
from deeprecsys_tpu_torch.ops import embedding as emb
from deeprecsys_tpu_torch.parallel import make_mesh
from deeprecsys_tpu_torch.parallel.api import make_tablewise_model
from deeprecsys_tpu_torch.parallel.placement import plan_tablewise_placement
from deeprecsys_tpu_torch.parallel.sharding import (
    TablewisePlan, build_tablewise_tables, tablewise_embedding_bag)

CPU8 = ["cpu"] * 8
RTOL = ATOL = 1e-5
MODEL_RTOL, MODEL_ATOL = 2e-4, 2e-5


def _cfgs(rows, L=4, d=32):
    kw = dict(model_type="dlrm", model_name="t", mlp_bot=(8, d), mlp_top=(8, 1),
              embedding_rows=tuple(rows), sparse_feature_size=d,
              num_indices_per_lookup=L, interaction_op="cat")
    return ModelConfig(**kw), JaxModelConfig(**kw)


def _fused(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(cfg.total_rows, cfg.sparse_feature_size)).astype(np.float32)


@pytest.mark.parametrize("name", zoo.MODEL_NAMES)
def test_placement_equals_jax_for_every_zoo_config(name):
    for M in (1, 2, 4, 8):
        got = plan_tablewise_placement(zoo.get_config(name), M)
        want = jax_plan(jax_zoo.get_config(name), M)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (name, M)


def test_planner_balances_and_permutes():
    cfg, _ = _cfgs([100, 10, 10, 10, 100, 10, 10, 10])
    pl = plan_tablewise_placement(cfg, 4)
    assert sorted(pl.perm) == list(range(8))
    assert all(len(g) == 2 for g in pl.tables_per_shard)
    assert pl.shard_of_table[0] != pl.shard_of_table[4]  # the two big tables apart
    assert pl.load_imbalance == pytest.approx(1.0)
    for old, pos in enumerate(pl.inv_perm):
        assert pl.perm[pos] == old


def test_planner_pads_indivisible_with_virtual_tables():
    pl = plan_tablewise_placement(_cfgs([10, 10, 10])[0], 2)
    assert pl.num_real_tables == 3 and len(pl.perm) == 4
    assert all(len(g) == 2 for g in pl.tables_per_shard)


def test_tablewise_layout_equals_jax():
    cfg, jcfg = _cfgs([64, 32, 48, 16, 40, 24, 56, 8, 5])
    fused = _fused(cfg)
    pl = plan_tablewise_placement(cfg, 4)
    got = build_tablewise_tables(torch.from_numpy(fused), cfg, pl)
    want = jax_build(jnp.asarray(fused), jcfg, jax_plan(jcfg, 4))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rows,L,masked", [
    ([64, 32, 48, 16, 40, 24, 56, 8], 4, False),
    ([100, 10, 30, 50], 1, False),
    ([64, 32, 48, 16, 40, 24, 56, 8, 7], 4, True),
])
def test_tablewise_lookup_matches_jax_and_single_device(rows, L, masked):
    """The lookup (virtual pad tables where T does not divide, a ragged
    mask permuted with its ids) against JAX's table-wise lookup and the
    port's single-device lookup (JAX tests/test_placement.py:44, :131)."""
    cfg, jcfg = _cfgs(rows, L=L)
    fused = _fused(cfg)
    idx = RecDataGenerator(cfg, seed=1).generate_batch(8).indices
    mask = np.random.default_rng(5).random(idx.shape) < 0.6 if masked else None
    pl = plan_tablewise_placement(cfg, 4)
    offsets = torch.as_tensor(cfg.table_offsets, dtype=torch.int32)
    got = tablewise_embedding_bag(build_tablewise_tables(torch.from_numpy(fused), cfg, pl),
                                  torch.from_numpy(idx), pl, make_mesh(2, 4, devices=CPU8),
                                  mask=None if mask is None else torch.from_numpy(mask))
    single = emb.embedding_bag_reference(torch.from_numpy(fused), offsets, torch.from_numpy(idx),
                                         mask=None if mask is None else torch.from_numpy(mask))
    want = jax_tablewise(jax_build(jnp.asarray(fused), jcfg, jax_plan(jcfg, 4)),
                         jnp.asarray(idx), jax_plan(jcfg, 4), jax_make_mesh(2, 4),
                         mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("quant,masked", [
    ("none", False), ("none", True), ("int8", False), ("int8_rowwise", True)])
def test_tablewise_virtual_slot_of_a_full_shard_reads_row_0(quant, masked):
    """Uneven tables (100, 10, 10) on a 1x2 mesh: the planner puts table 0
    and the virtual pad table on shard 0, whose 100 rows the virtual slot's
    planned offset (100) would overrun. The plan reads the shard's row 0
    there (JAX ``sharding.py:348-357``), and the lookup in the three layouts
    matches JAX's (float) and the single device's plain version."""
    cfg, jcfg = _cfgs([100, 10, 10])
    pl = plan_tablewise_placement(cfg, 2)
    virtual = pl.perm.index(3)
    assert pl.local_offsets[virtual] == pl.rows_per_shard == 100
    mesh = make_mesh(1, 2, devices=CPU8[:2])
    idx = RecDataGenerator(cfg, seed=4).generate_batch(8).indices
    mask = np.random.default_rng(6).random(idx.shape) < 0.6 if masked else None
    tmask = None if mask is None else torch.from_numpy(mask)
    offsets = torch.as_tensor(cfg.table_offsets, dtype=torch.int32)
    g = torch.Generator().manual_seed(1)
    if quant == "none":
        fused = torch.from_numpy(_fused(cfg))
        got = tablewise_embedding_bag(build_tablewise_tables(fused, cfg, pl), torch.from_numpy(idx),
                                      pl, mesh, mask=tmask)
        want = jax_tablewise(jax_build(jnp.asarray(fused.numpy()), jcfg, jax_plan(jcfg, 2)),
                             jnp.asarray(idx), jax_plan(jcfg, 2),
                             jax_make_mesh(1, 2, devices=jax.devices()[:2]),
                             mask=None if mask is None else jnp.asarray(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        single = emb.embedding_bag_reference(fused, offsets, torch.from_numpy(idx), mask=tmask)
        np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=RTOL, atol=ATOL)
    elif quant == "int8":
        q = torch.randint(-127, 128, (cfg.total_rows, 32), dtype=torch.int8, generator=g)
        scale = torch.from_numpy(emb.int8_table_scales(cfg.scaled_rows))
        plan = TablewisePlan(pl, mesh, scale)
        assert int(plan.local_off.part(0, 0)[1]) == 0 and float(plan.scale.part(0, 0)[1]) == 0.0
        got = tablewise_embedding_bag(build_tablewise_tables(q, cfg, pl), torch.from_numpy(idx),
                                      pl, mesh, table_scale=scale, mask=tmask)
        assert torch.equal(got, emb.embedding_bag_int8_reference(
            q, scale, offsets, torch.from_numpy(idx), mask=tmask))
    else:
        qrows = emb.quantize_rowwise_int8(torch.from_numpy(_fused(cfg)))
        got = tablewise_embedding_bag(build_tablewise_tables(qrows, cfg, pl),
                                      torch.from_numpy(idx), pl, mesh, rowwise=True, mask=tmask)
        single = emb.embedding_bag_int8_rowwise_reference(qrows, offsets, torch.from_numpy(idx),
                                                          mask=tmask)
        np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=RTOL, atol=ATOL)


def test_tablewise_on_din_scale():
    """DIN's skewed tables over 2 shards: the two big tables land apart and
    the lookup matches the single-device one (JAX :89)."""
    cfg = zoo.get_config("din", table_scale=20000)
    pl = plan_tablewise_placement(cfg, 2)
    assert pl.shard_of_table[cfg.num_tables - 2] != pl.shard_of_table[cfg.num_tables - 1]
    fused = torch.from_numpy(_fused(cfg))
    idx = torch.from_numpy(RecDataGenerator(cfg, seed=2).generate_batch(4).indices)
    got = tablewise_embedding_bag(build_tablewise_tables(fused, cfg, pl), idx, pl,
                                  make_mesh(4, 2, devices=CPU8))
    want = emb.embedding_bag_reference(fused, torch.as_tensor(cfg.table_offsets,
                                                              dtype=torch.int32), idx)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=ATOL)


def test_tablewise_int8_pools_exactly():
    """Per-table int8: each shard pools in exact int32 with its placed
    tables' scales, so the table-wise lookup is the single-device K1-int8
    plain version bit for bit."""
    cfg, _ = _cfgs([64, 32, 48, 16, 40, 24, 56, 8, 9], L=6)
    q = torch.randint(-127, 128, (cfg.total_rows, 32), dtype=torch.int8,
                      generator=torch.Generator().manual_seed(0))
    scale = torch.from_numpy(emb.int8_table_scales(cfg.scaled_rows))
    idx = torch.from_numpy(RecDataGenerator(cfg, seed=3).generate_batch(8).indices)
    pl = plan_tablewise_placement(cfg, 4)
    got = tablewise_embedding_bag(build_tablewise_tables(q, cfg, pl), idx, pl,
                                  make_mesh(2, 4, devices=CPU8), table_scale=scale,
                                  compute_dtype=torch.bfloat16)
    want = emb.embedding_bag_int8_reference(q, scale, torch.as_tensor(cfg.table_offsets,
                                                                      dtype=torch.int32),
                                            idx, compute_dtype=torch.bfloat16)
    assert torch.equal(got, want)


def _tablewise_model_case(name, scale, quant, masked, seed):
    port_cfg = zoo.get_config(name, table_scale=scale, table_quant=quant)
    jax_cfg = jax_zoo.get_config(name, table_scale=scale, table_quant=quant)
    np_params = bridge.init_numpy(port_cfg, seed)
    host = RecDataGenerator(port_cfg, seed=3).generate_batch(8)
    mask = np.random.default_rng(7).random(host.indices.shape) < 0.6 if masked else None
    params = bridge.params_from_numpy(np_params, port_cfg, "cpu")
    batch = Batch(dense=host.dense, indices=host.indices, mask=mask)
    mesh = make_mesh(4, 2, devices=CPU8)
    tw = make_tablewise_model(get_model(port_cfg, "cpu"), mesh)
    got = tw.apply(tw.convert_params(params), batch.to("cpu"))
    single = get_model(port_cfg, "cpu").apply(params, batch.to("cpu"))
    jtw = jax_tablewise_model(jax_get_model(jax_cfg), jax_make_mesh(4, 2))
    want = jtw.apply(jtw.convert_params(jax.tree_util.tree_map(jnp.asarray, np_params)),
                     JaxBatch(dense=None if host.dense is None else jnp.asarray(host.dense),
                              indices=jnp.asarray(host.indices),
                              mask=None if mask is None else jnp.asarray(mask)))
    return got, single, np.asarray(want)


@pytest.mark.parametrize("name,quant,masked", [
    ("rm1", "none", False), ("wnd", "none", False), ("din", "none", False),
    ("rm1", "int8", False), ("rm1", "int8_rowwise", False), ("rm1", "none", True),
    ("wnd", "int8", True)])
def test_tablewise_full_model_matches_jax_and_single_device(name, quant, masked):
    """Every model family on table-wise tables matches the single-device
    forward (JAX tests/test_placement.py:65, :105, :131): float, per-table
    int8 and row-wise int8, with and without a ragged mask. (The towers run
    on data slices of 2 rows, whose f32 products the CPU may order apart
    from a batch of 8: the int8 pools' exactness is held above.)"""
    scale = 20000 if name == "din" else 2000
    got, single, want = _tablewise_model_case(name, scale, quant, masked, seed=2)
    np.testing.assert_allclose(got.numpy(), want, rtol=MODEL_RTOL, atol=MODEL_ATOL)
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=MODEL_RTOL, atol=MODEL_ATOL)
