"""The port's ops against the JAX package's, on the CPU, same numpy inputs.

Tolerances:
- f32 pooled sums: rtol 1e-6 (summation order differs; L <= 8 terms here).
- bf16 pooled sums: at most 1 bf16 ulp of the larger value, plus the f32
  summation slack L * 2^-23 * sum|rows| (both sides sum in f32 and round
  once, so only the order of the f32 sum differs).
- f32 MLPs: rtol 1e-5. bf16 MLPs: 2 bf16 ulps (2^-7 relative), since an f32
  product that lands near a rounding tie may round the other way at one
  layer and move the next layer's output by about one ulp.
"""

import dataclasses
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprecsys_tpu.ops import cat_interaction as jax_cat
from deeprecsys_tpu.ops import embedding_bag as jax_embedding_bag
from deeprecsys_tpu.ops import mlp_apply as jax_mlp_apply
from deeprecsys_tpu.ops import pack_table as jax_pack_table
from deeprecsys_tpu_torch import zoo as port_zoo
from deeprecsys_tpu_torch.ops import (
    cat_interaction, embedding_bag, embedding_bag_reference, init_fused_tables,
    mlp_apply, mlp_init, unpack_table)
from deeprecsys_tpu_torch.ops.embedding import (
    K1_BLOCKS_PER_SM, K1_WARPS_PER_BLOCK, K1W_ROWS_PER_SLOT, k1_launch_plan, k1_window_plan)

TABLE_ROWS = (50, 30, 20)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _lookup_inputs(d, B=4, L=5, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(sum(TABLE_ROWS), d)).astype(np.float32)
    offsets = np.concatenate([[0], np.cumsum(TABLE_ROWS)[:-1]]).astype(np.int32)
    indices = np.stack([np.stack([rng.integers(0, n, size=L) for n in TABLE_ROWS])
                        for _ in range(B)]).astype(np.int32)
    mask = rng.random(indices.shape) < 0.6 if masked else None
    return table, offsets, indices, mask


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16_ulp(x):
    x = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("table_dt,compute_dt", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("bfloat16", "float32"), ("float32", "bfloat16")])
def test_embedding_bag_reference_matches_jax(table_dt, compute_dt, d, masked):
    table, offsets, indices, mask = _lookup_inputs(d, masked=masked)
    t_dt, j_dt = DTYPES[table_dt]
    tc_dt, jc_dt = DTYPES[compute_dt]
    want = _f32(jax_embedding_bag(
        jnp.asarray(table).astype(j_dt), jnp.asarray(offsets), jnp.asarray(indices),
        compute_dtype=jc_dt, mask=None if mask is None else jnp.asarray(mask)))
    got_t = embedding_bag_reference(
        torch.from_numpy(table).to(t_dt), torch.from_numpy(offsets),
        torch.from_numpy(indices), compute_dtype=tc_dt,
        mask=None if mask is None else torch.from_numpy(mask))
    assert got_t.dtype == tc_dt and got_t.shape == (4, 3, d)
    got = _f32(got_t)
    if compute_dt == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        rows = np.abs(_f32(torch.from_numpy(table).to(t_dt)))[
            (indices + offsets[None, :, None])]
        if mask is not None:
            rows = rows * mask[..., None]
        slack = indices.shape[-1] * 2.0 ** -23 * rows.sum(axis=2)
        tol = _bf16_ulp(np.maximum(np.abs(got), np.abs(want))) + slack
        assert (np.abs(got - want) <= tol).all()


@pytest.mark.parametrize("masked", [False, True])
def test_cpu_wrapper_takes_plain_path(masked):
    table, offsets, indices, mask = _lookup_inputs(32, masked=masked)
    args = (torch.from_numpy(table).to(torch.bfloat16), torch.from_numpy(offsets),
            torch.from_numpy(indices))
    m = None if mask is None else torch.from_numpy(mask)
    embedding_bag.kernel_launches = 0
    got = embedding_bag(*args, mask=m)
    assert embedding_bag.kernel_launches == 0
    assert torch.equal(got, embedding_bag_reference(*args, mask=m))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    table, offsets, indices, _ = _lookup_inputs(32)
    t, o, i = (torch.from_numpy(table), torch.from_numpy(offsets),
               torch.from_numpy(indices))
    with pytest.raises(ValueError, match="d >= 1"):
        embedding_bag(t[:, :0].contiguous(), o, i)
    # Any width d >= 1 computes (the kernel's general instance on the card).
    narrow = t[:, :12].contiguous()
    assert torch.equal(embedding_bag(narrow, o, i), embedding_bag_reference(narrow, o, i))
    with pytest.raises(TypeError, match="dtypes"):
        embedding_bag(t.double(), o, i)
    with pytest.raises(TypeError, match="indices"):
        embedding_bag(t, o, i.long())
    with pytest.raises(TypeError, match="offsets"):
        embedding_bag(t, o[:2], i)
    with pytest.raises(TypeError, match="mask"):
        embedding_bag(t, o, i, mask=torch.ones(i.shape, dtype=torch.uint8))
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag(t, o, i.transpose(0, 2).contiguous().transpose(0, 2))
    with pytest.raises(TypeError, match="dtypes"):
        embedding_bag(t, o, i, compute_dtype=torch.float16)


@pytest.mark.parametrize("pack,rows_total", [(2, 100), (4, 101)])
def test_unpack_table_inverts_jax_pack(pack, rows_total):
    table = np.random.default_rng(1).normal(size=(rows_total, 8)).astype(np.float32)
    packed = np.array(jax_pack_table(jnp.asarray(table), pack))
    got = unpack_table(torch.from_numpy(packed), pack, rows_total)
    np.testing.assert_array_equal(got.numpy(), table)


def _mlp_params(dims, seed=2):
    rng = np.random.default_rng(seed)
    return [{"w": rng.normal(size=(n, m)).astype(np.float32) / np.sqrt(n),
             "b": rng.normal(size=(m,)).astype(np.float32) * 0.1}
            for n, m in zip(dims[:-1], dims[1:])]


@pytest.mark.parametrize("sigmoid_layer,final_relu", [(-1, True), (3, True), (-1, False)])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_mlp_apply_matches_jax(dt, sigmoid_layer, final_relu):
    t_dt, j_dt = DTYPES[dt]
    np_params = _mlp_params((24, 16, 8, 4))
    x = np.random.default_rng(3).normal(size=(6, 24)).astype(np.float32)
    jp = [{k: jnp.asarray(v).astype(j_dt) for k, v in layer.items()} for layer in np_params]
    tp = [{k: torch.from_numpy(v).to(t_dt) for k, v in layer.items()} for layer in np_params]
    want = _f32(jax_mlp_apply(jp, jnp.asarray(x).astype(j_dt),
                              sigmoid_layer=sigmoid_layer, final_relu=final_relu))
    got_t = mlp_apply(tp, torch.from_numpy(x).to(t_dt),
                      sigmoid_layer=sigmoid_layer, final_relu=final_relu)
    assert got_t.dtype == t_dt
    got = _f32(got_t)
    if dt == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7,
                                   atol=2.0 ** -7 * np.abs(want).max())
    if sigmoid_layer == 3:
        assert ((got > 0) & (got < 1)).all()
    elif not final_relu:
        assert (got < 0).any()  # the last pre-activation is exposed


def test_mlp_apply_bf16_adds_bias_in_f32():
    # (1 + 2^-7)(1 + 3*2^-7) = 1 + 2^-5 + 3*2^-14. Rounded to bf16 before
    # the bias it is 1 + 2^-5, and minus 1 gives 2^-5. Kept in f32 through
    # the bias it is 2^-5 (1 + 3*2^-9), which rounds once to 2^-5 (1 + 2^-7).
    x = np.array([[1 + 2.0 ** -7]], np.float32)
    w = np.array([[1 + 3 * 2.0 ** -7]], np.float32)
    b = np.array([-1.0], np.float32)
    bf = jnp.bfloat16
    want = _f32(jax_mlp_apply([{"w": jnp.asarray(w).astype(bf), "b": jnp.asarray(b).astype(bf)}],
                              jnp.asarray(x).astype(bf)))
    got = _f32(mlp_apply([{"w": torch.from_numpy(w).bfloat16(),
                           "b": torch.from_numpy(b).bfloat16()}],
                         torch.from_numpy(x).bfloat16()))
    assert got.item() == want.item() == 2.0 ** -5 * (1 + 2.0 ** -7)


@pytest.mark.parametrize("with_dense", [True, False])
def test_cat_interaction_matches_jax(with_dense):
    rng = np.random.default_rng(4)
    dense = rng.normal(size=(3, 8)).astype(np.float32) if with_dense else None
    emb = rng.normal(size=(3, 5, 8)).astype(np.float32)
    want = np.asarray(jax_cat(None if dense is None else jnp.asarray(dense), jnp.asarray(emb)))
    got = cat_interaction(None if dense is None else torch.from_numpy(dense),
                          torch.from_numpy(emb)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_init_fused_tables_scale_per_table(dt):
    g = torch.Generator().manual_seed(0)
    t = init_fused_tables([10, 1000], 32, dt, g, "cpu").float().numpy()
    assert t.shape == (1010, 32)
    # Each table within U(+-sqrt(1/n)) (reference init distribution) ...
    assert np.abs(t[:10]).max() <= np.sqrt(1 / 10) * (1 + 2 ** -8)
    assert np.abs(t[10:]).max() <= np.sqrt(1 / 1000) * (1 + 2 ** -8)
    # ... and filling it: the uniform's std is bound / sqrt(3).
    np.testing.assert_allclose(t[10:].std(), np.sqrt(1 / 1000) / np.sqrt(3), rtol=0.03)
    assert abs(t[10:].mean()) < 0.02 * np.sqrt(1 / 1000)


def test_mlp_init_distributions():
    g = torch.Generator().manual_seed(1)
    (layer,) = mlp_init((256, 512), torch.float32, g, "cpu")
    assert layer["w"].shape == (256, 512) and layer["b"].shape == (512,)
    np.testing.assert_allclose(layer["w"].std().item(), np.sqrt(2 / (256 + 512)), rtol=0.03)
    np.testing.assert_allclose(layer["b"].std().item(), np.sqrt(1 / 512), rtol=0.15)
    assert abs(layer["w"].mean().item()) < 0.01 * np.sqrt(2 / 768)


# ------------------------------------------------------------ K1's launch plan

K1_CU = Path(__file__).resolve().parents[1] / "deeprecsys_tpu_torch" / "ops" / "csrc" / \
    "embedding_bag.cu"
K1_COMPACT_IDS = 128  # kCompactIds: the ids a warp packs at once


def _k1_instances(S):
    """The (bags a warp, rows a lane) pairs embedding_bag.cu instantiates."""
    return {(S, u) for u in (1, 2, 4, 8)} | {(1, 4)}


def _k1_coverage(plan, n_bags, L):
    """How often K1 reads each (bag, row) and writes each bag under ``plan``:
    the kernel's index arithmetic (grid-stride loop over warp tasks, slot s
    of bag bi reading rows step0 + u * SPB + s, the ids' loader lane k
    holding (k // RPS, step0 + k % RPS)), in numpy."""
    G, U, S = plan.bags_per_warp, plan.rows_per_lane, plan.row_slots
    SPB, RPS = S // G, plan.rows_per_step
    warps = plan.grid * K1_WARPS_PER_BLOCK
    tasks = np.concatenate([np.arange(w, plan.tasks, warps) for w in range(warps)])
    reads = np.zeros((n_bags, L), np.int64)
    writes = np.zeros(n_bags, np.int64)
    g = np.arange(S)
    bi, s = g // SPB, g % SPB
    for step0 in range(0, L, RPS):
        u = np.arange(U)[:, None]
        k = bi * RPS + u * SPB + s                      # (U, S): the shuffle's source id
        assert (k < G * RPS).all()
        assert ((k // RPS == bi) & (step0 + k % RPS == step0 + u * SPB + s)).all()
        bag = tasks[:, None, None] * G + bi[None, None, :]   # (tasks, 1, S)
        row = step0 + u * SPB + s                            # (U, S)
        bag, row = np.broadcast_arrays(bag, row[None])
        ok = (bag < n_bags) & (row < L)
        np.add.at(reads, (bag[ok], row[ok]), 1)
    bag = tasks[:, None] * G + np.arange(G)[None, :]
    np.add.at(writes, bag[bag < n_bags], 1)
    return reads, writes


def test_k1_constants_match_the_kernel_source():
    src = K1_CU.read_text()
    assert re.search(rf"kWarpsPerBlock = {K1_WARPS_PER_BLOCK};", src)
    assert re.search(rf"kMinBlocksPerSm = {K1_BLOCKS_PER_SM};", src)
    cases = set(re.findall(r"DRS_K1_CASE\((S|1), (\d)\)", src))
    assert cases == {("S", "1"), ("S", "2"), ("S", "4"), ("S", "8"), ("1", "4")}


@pytest.mark.parametrize("grid_cap", [None, 264])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", ["rm1", "rm2", "rm3", "wnd", "mtwnd", "ncf", "din", "dien"])
def test_k1_plan_covers_every_zoo_bag_once(name, dtype, grid_cap):
    """Also with the grid capped, so that warps loop over several tasks, as
    the kernel's grid-stride loop allows."""
    cfg = port_zoo.get_config(name)
    n_bags, L, d = 512 * cfg.num_tables, cfg.num_indices_per_lookup, cfg.sparse_feature_size
    plan = k1_launch_plan(n_bags, L, d, dtype)
    assert (plan.bags_per_warp, plan.rows_per_lane) in _k1_instances(plan.row_slots)
    assert plan.grid * K1_WARPS_PER_BLOCK >= plan.tasks > (plan.grid - 1) * K1_WARPS_PER_BLOCK
    if grid_cap is not None:
        plan = dataclasses.replace(plan, grid=min(plan.grid, grid_cap))
    reads, writes = _k1_coverage(plan, n_bags, L)
    assert (reads == 1).all() and (writes == 1).all()


@pytest.mark.parametrize("grid_cap", [None, 1])
@pytest.mark.parametrize("d,dtype", [(32, torch.bfloat16), (64, torch.bfloat16),
                                     (32, torch.float32), (64, torch.float32),
                                     (8, torch.bfloat16), (256, torch.bfloat16),
                                     (4, torch.float32), (128, torch.float32)])
@pytest.mark.parametrize("L", [1, 2, 3, 5, 8, 20, 80, 120])
@pytest.mark.parametrize("n_bags", [1, 13, 1001])
def test_k1_plan_covers_edge_shapes_once(n_bags, L, d, dtype, grid_cap):
    """B * T = 1, and not a multiple of the bags a warp holds."""
    plan = k1_launch_plan(n_bags, L, d, dtype)
    if grid_cap is not None:
        plan = dataclasses.replace(plan, grid=min(plan.grid, grid_cap))
    assert (plan.bags_per_warp, plan.rows_per_lane) in _k1_instances(plan.row_slots)
    assert plan.row_slots == 32 // (d * dtype.itemsize // 16)
    if L <= 8:  # every lane has all its bag's rows in flight in one step
        assert plan.bags_per_warp == plan.row_slots and plan.rows_per_step >= L
    reads, writes = _k1_coverage(plan, n_bags, L)
    assert (reads == 1).all() and (writes == 1).all()


@pytest.mark.parametrize("d,dtype,vector", [
    (4, torch.bfloat16, False), (8, torch.bfloat16, True), (12, torch.bfloat16, False),
    (256, torch.bfloat16, True), (512, torch.bfloat16, False), (4, torch.float32, True),
    (12, torch.float32, False), (128, torch.float32, True), (256, torch.float32, False),
    (3, torch.float32, False)])
def test_k1_plan_takes_the_16_byte_lanes_only_at_rows_of_16_times_2k_bytes(d, dtype, vector):
    """Rows of 16 * 2^k bytes up to 512 take the 16-byte-lane mappings
    (one instance a width in embedding_bag.cu); any other width the general
    instance, a warp a bag (bags_per_warp 0), in the direct lookup and in
    the window alike."""
    for L in (1, 5, 80):
        for plan in (k1_launch_plan(100, L, d, dtype), k1_window_plan(100, L, d, dtype)):
            assert plan.general == (not vector)
            if not vector:
                assert plan.grid * K1_WARPS_PER_BLOCK >= plan.tasks == 100 and not plan.compact


def _compact_coverage(ids: np.ndarray, row_lo: int, n_rows: int, plan) -> np.ndarray:
    """How often the window's compacted gather reads each slot of each bag
    (``csrc/embedding_bag.cu::embedding_bag_compact_kernel``'s index
    arithmetic in numpy): windows of kCompactIds slots, lane l's r-th id the
    slot w0 + 32 r + l, owned ids packed by rank (the ballot's popc below
    the lane, plus the count of earlier registers), then the slots s < S of
    P lanes reading packed ids k0 + u S + s."""
    n_bags, L = ids.shape
    S, U = plan.row_slots, plan.rows_per_lane
    reads = np.zeros(ids.shape, np.int64)
    for bag in range(n_bags):
        for w0 in range(0, L, K1_COMPACT_IDS):
            packed, n = {}, 0
            for r in range(K1_COMPACT_IDS // 32):
                lanes = w0 + r * 32 + np.arange(32)
                owned = (lanes < L) & np.isin(lanes, np.flatnonzero(
                    (ids[bag] >= row_lo) & (ids[bag] < row_lo + n_rows)))
                for lane in np.flatnonzero(owned):
                    packed[n + int(owned[:lane].sum())] = lanes[lane]
                n += int(owned.sum())
            for k0 in range(0, n, S * U):
                for u in range(U):
                    for s in range(S):
                        k = k0 + u * S + s
                        if k < n:
                            reads[bag, packed[k]] += 1
    return reads


@pytest.mark.parametrize("L", [65, 120, 128, 300])
def test_k1_window_compact_plan_reads_every_owned_slot_once(L):
    """The window's plan for walks longer than K1W_DIRECT_STEPS steps is the
    compacted gather: each slot whose row the shard owns read exactly once,
    no other slot read. rm1's bags (d = 32, L = 80: 2.5 steps) keep the
    direct mapping, rm2's (d = 64, L = 120: 7.5 steps) take the gather."""
    plan = k1_window_plan(7, L, 64, torch.bfloat16)
    assert plan.compact and plan.rows_per_lane == K1W_ROWS_PER_SLOT and plan.row_slots == 4
    assert not k1_window_plan(7, 64, 64, torch.bfloat16).compact  # 4 steps: direct
    assert not k1_window_plan(4096, 80, 32, torch.bfloat16).compact  # rm1
    assert k1_window_plan(16384, 120, 64, torch.bfloat16).compact  # rm2
    rng = np.random.default_rng(L)
    ids = rng.integers(0, 1000, size=(7, L))
    reads = _compact_coverage(ids, 250, 250, plan)
    owned = (ids >= 250) & (ids < 500)
    assert (reads == owned).all()


def test_k1_compact_constants_match_the_kernel_source():
    src = K1_CU.read_text()
    assert re.search(rf"kCompactIds = {K1_COMPACT_IDS};", src)
    assert re.search(rf"kCompactU = {K1W_ROWS_PER_SLOT};", src)
