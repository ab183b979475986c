"""The port's hot/cold split against the JAX package's, on the CPU: the host
ops (``ops/hotcold.py``: the split on its numpy and native paths, the
hot-set choice, the coverage and the scan budget), the plain versions of K6
(``ops/embedding.py``), ``models/hotcold.py`` for all eight zoo models in
the three table layouts and ``experiments/skew_bench.py``, and a simulation
of K6's index arithmetic (``utils/memory.py`` in ``test_torch_config.py``).

Tolerances:
- the split, the hot-set choice, the coverage and the ladders: equal
  exactly (the same integer and numpy arithmetic);
- K6's plain version, float tables: f32 rtol 1e-5 against JAX's hot/cold
  op (the same sums in another order); per-table int8: bit for bit (exact
  int32 sums, one f32 multiply, one rounding); row-wise: ``hotcold_tolerance``
  (the same f32 products, another order of their sum);
- K6's plain version against the port's direct lookup on the same ids:
  ``pooled_tolerance``/``rowwise_tolerance``, int8 bit for bit (a hot/cold
  split is an exact re-association of the direct sum);
- models: f32 rtol and atol 1e-5 against JAX's hot/cold model; bf16 against
  JAX's direct model at the zoo's limit (two bf16 ulps of the largest
  output, ``chip_smoke.bf16_atol``): JAX's hot/cold pools in bf16 where the
  port pools in f32 as its direct lookup does.
"""

import dataclasses
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu.experiments import skew_bench as jax_skew
from deeprecsys_tpu.models import get_model as jax_get_model
from deeprecsys_tpu.models import hotcold as jax_hotcold
from deeprecsys_tpu.models.base import Batch as JaxBatch
from deeprecsys_tpu.ops import embedding as jax_emb
from deeprecsys_tpu_torch import bridge, zoo
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.experiments import skew_bench
from deeprecsys_tpu_torch.models import get_model, hotcold
from deeprecsys_tpu_torch.models.base import Batch
from deeprecsys_tpu_torch.ops import embedding as emb
from deeprecsys_tpu_torch.ops import hotcold as ops_hc
from deeprecsys_tpu_torch.runtime import native
from tests.golden import make_torch_port_fixture as fixture
from tests.test_torch_quant import _k4_lane_words

SCALE = 2000
QUANTS = ("none", "int8", "int8_rowwise")
HOTCOLD_CU = (Path(__file__).resolve().parents[1] / "deeprecsys_tpu_torch" / "ops" / "csrc"
              / "embedding_bag_hotcold.cu")


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _split_t(split: dict) -> dict:
    return {k: _t(split[k]) for k in ("hot_sel", "hot_mask", "cold_ids", "cold_seg")}


def _split_j(split: dict) -> dict:
    return {k: jnp.asarray(split[k]) for k in ("hot_sel", "hot_mask", "cold_ids", "cold_seg")}


def _stream(seed, B=6, T=3, L=5, rows=(50, 70, 30), alpha=1.3, masked=False):
    rng = np.random.default_rng(seed)
    rows = np.asarray(rows[:T] if len(rows) >= T else (rows * T)[:T], dtype=np.int64)
    offsets = np.concatenate([[0], np.cumsum(rows)[:-1]]).astype(np.int32)
    idx = (rng.zipf(alpha, size=(B, T, L)) % rows[None, :, None]).astype(np.int32)
    mask = rng.random((B, T, L)) < 0.7 if masked else None
    return rows, offsets, idx, mask


# ---------------------------------------------------------------- the split

@pytest.mark.parametrize("with_index", [False, True])
@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("impl", ["numpy", "native"])
@pytest.mark.parametrize("shape", [(6, 3, 5), (16, 8, 80), (1, 1, 1), (33, 4, 3)])
def test_split_equals_jax_exactly(shape, impl, masked, pad, with_index):
    """Every output of the port's split equals JAX's (its numpy path, the
    definition), padded or not, masked or not, with or without a hash
    index, on the port's numpy and native paths, and written into caller
    buffers too."""
    B, T, L = shape
    rows, offsets, idx, mask = _stream(sum(shape), B, T, L, rows=(500, 70, 9000, 31),
                                       masked=masked)
    hot = jax_emb.select_hot_ids(idx, offsets, 37)
    buckets = hotcold.cold_ladder(idx.size)
    want = jax_emb.split_hot_cold(idx, offsets, hot, cold_buckets=buckets, impl="numpy",
                                  pad=pad, slot_mask=mask)
    index = native.HotIndex(hot) if with_index else None
    n_cap = max(idx.size, max(buckets))
    out = {"hot_sel": np.full(n_cap, -7, np.int32), "hot_mask": np.ones(n_cap, bool),
           "cold_ids": np.full(n_cap, -7, np.int32), "cold_seg": np.full(n_cap, -7, np.int32)}
    for o in (None, out):
        got = ops_hc.split_hot_cold(idx, offsets, hot, cold_buckets=buckets, impl=impl, pad=pad,
                                    slot_mask=mask, hot_index=index, out=o)
        assert sorted(got) == sorted(want)
        for k in want:
            if k == "n_cold":
                assert got[k] == want[k]
                continue
            g, w = np.asarray(got[k]), np.asarray(want[k])
            assert g.dtype == w.dtype and g.shape == w.shape, k
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_native_split_is_counted_and_refuses_a_stale_index():
    _, offsets, idx, _ = _stream(1)
    hot = jax_emb.select_hot_ids(idx, offsets, 5)
    before = ops_hc._split_hot_cold_native.calls
    ops_hc.split_hot_cold(idx, offsets, hot, impl="native")
    ops_hc.split_hot_cold(idx, offsets, hot, impl="numpy")
    assert ops_hc._split_hot_cold_native.calls == before + 1
    assert native.native_available()
    with pytest.raises(ValueError, match="stale index"):
        ops_hc.split_hot_cold(idx, offsets, hot, impl="native",
                              hot_index=native.HotIndex(hot[:-1]))


def test_native_library_builds_into_the_checkout():
    path = native.library_path()
    assert native.get_lib() is not None and path.exists()
    assert path.parent == Path(__file__).resolve().parents[1] / "build" / "native"
    assert "deeprecsys_tpu" not in str(path.relative_to(path.parents[2]))


@pytest.mark.parametrize("seed", range(4))
def test_native_cold_stream_is_sorted_and_matches_brute_force(seed):
    """Fuzz (as tests/test_fuzz_parity.py): the native split's cold stream
    holds exactly the misses, in order, with their bags; ``cold_seg`` is
    non-decreasing with the pads (bag B*T) last, the order K6 relies on;
    each hit maps back to its fused id."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(25):
        T, L, B = int(rng.integers(1, 6)), int(rng.integers(1, 9)), int(rng.integers(1, 40))
        rows = rng.integers(4, 60, size=T)
        offsets = np.concatenate([[0], np.cumsum(rows)])[:-1]
        idx = np.stack([rng.integers(0, rows[t], size=(B, L)) for t in range(T)],
                       axis=1).astype(np.int32)
        mask = rng.random(idx.shape) < 0.7 if rng.random() < 0.5 else None
        k = int(rng.integers(0, int(rows.sum()) + 1))
        hot = ops_hc.select_hot_ids(idx[: max(B // 2, 1)], offsets, k)
        s = ops_hc.split_hot_cold(idx, offsets, hot, impl="native", slot_mask=mask,
                                  cold_buckets=hotcold.cold_ladder(idx.size))
        flat = (idx.astype(np.int64) + offsets[None, :, None]).reshape(-1)
        valid = np.ones(flat.shape, bool) if mask is None else mask.reshape(-1)
        in_hot = np.isin(flat, hot) & valid
        np.testing.assert_array_equal(s["hot_mask"].reshape(-1), in_hot)
        sel = s["hot_sel"].reshape(-1)
        np.testing.assert_array_equal(hot[sel[in_hot]], flat[in_hot])
        assert (sel[~in_hot] == 0).all()
        cold = valid & ~in_hot
        n = s["n_cold"]
        assert n == int(cold.sum())
        groups = np.arange(flat.size) // L
        np.testing.assert_array_equal(s["cold_ids"][:n], flat[cold])
        np.testing.assert_array_equal(s["cold_seg"][:n], groups[cold])
        assert (np.diff(s["cold_seg"]) >= 0).all()
        assert (s["cold_seg"][n:] == B * T).all() and (s["cold_ids"][n:] == 0).all()


def test_pad_bucket_equals_jax():
    for n in range(0, 70):
        for buckets in (None, (8, 16, 64), (3,)):
            for floor in (1, 8):
                assert ops_hc._pad_bucket(n, buckets, floor) == \
                    jax_emb._pad_bucket(n, buckets, floor)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [0, 1, 7, 60, 10_000])
def test_select_hot_ids_and_coverage_equal_jax(k, masked):
    _, offsets, idx, mask = _stream(k + 3, B=40, masked=masked)
    got = ops_hc.select_hot_ids(idx, offsets, k, mask=mask)
    want = jax_emb.select_hot_ids(idx, offsets, k, mask=mask)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    _, _, other, omask = _stream(k + 4, B=40, masked=masked)
    assert ops_hc.hot_coverage_of(other, offsets, got, mask=omask) == \
        jax_emb.hot_coverage_of(other, offsets, want, mask=omask)


@pytest.mark.parametrize("budget", [0, -1, 1, 100, 2_000, 10**9])
def test_scan_budget_subsample_equals_jax(budget):
    arr = np.arange(37 * 3 * 5).reshape(37, 3, 5)
    np.testing.assert_array_equal(ops_hc.scan_budget_subsample(arr, budget),
                                  jax_emb.scan_budget_subsample(arr, budget))


@pytest.mark.parametrize("n", [0, 1, 7, 8, 63, 640, 327_680, 655_361])
def test_cold_ladder_equals_jax(n):
    assert hotcold.cold_ladder(n) == jax_hotcold.cold_ladder(n)
    assert hotcold.cold_buckets_for(n) == jax_hotcold.cold_buckets_for(n, None)


# ---------------------------------------------------------------- K6's plain versions

def _tables(seed, R, d=32):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((R, d)).astype(np.float32)
    q = rng.integers(-127, 127, (R, d), dtype=np.int8, endpoint=True)
    row_scale = (rng.random(R, dtype=np.float32) * 1e-2 + 1e-4).astype(np.float32)
    qrows = np.concatenate([q, row_scale.view(np.int8).reshape(R, 4)], axis=1)
    return table, q, qrows


def _hotcold_inputs(seed, k, masked, B=8, T=3, L=6):
    """A zipf batch and its split over a hot set: the ``k`` most frequent
    rows, every row (k = -1), rows the batch never reads (k = -2: all cold,
    K > 0) or none (k = 0)."""
    rows, offsets, idx, mask = _stream(seed, B, T, L, rows=(120, 80, 300), masked=masked)
    flat = (idx.astype(np.int64) + offsets.astype(np.int64)[None, :, None]).reshape(-1)
    if k == -1:
        hot = np.arange(rows.sum(), dtype=np.int64)
    elif k == -2:
        hot = np.setdiff1d(np.arange(rows.sum(), dtype=np.int64), flat)[:50]
    else:
        hot = ops_hc.select_hot_ids(idx, offsets, k)
    split = ops_hc.split_hot_cold(idx, offsets, hot, cold_buckets=hotcold.cold_ladder(idx.size),
                                  slot_mask=mask)
    scale = (np.random.default_rng(seed).random(T, dtype=np.float32) * 1e-2
             + 1e-4).astype(np.float32)
    return rows, offsets, idx, mask, hot, split, scale


# The edges of JAX tests/test_ops.py:169-195: a hot set, every row hot, no
# row of the batch hot; and K = 0, which JAX's op cannot take (jnp.take
# from an empty hot table) and the port's checks against the direct lookup.
EDGES = [30, -1, -2, 0]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", EDGES)
def test_float_plain_version_matches_jax_and_direct(k, masked):
    rows, offsets, idx, mask, hot, split, _ = _hotcold_inputs(k + 11, k, masked)
    table, _, _ = _tables(1, int(rows.sum()))
    ht = table[hot]
    got = emb.embedding_bag_hotcold(_t(ht), _t(table), _split_t(split))
    if len(hot):
        want = np.asarray(jax_emb.embedding_bag_hotcold(jnp.asarray(ht), jnp.asarray(table),
                                                        _split_j(split)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    direct = emb.embedding_bag(_t(table), _t(offsets), _t(idx), mask=_t(mask))
    tol = emb.pooled_tolerance(got, direct, _t(table), _t(offsets), _t(idx), _t(mask))
    assert bool(((got - direct).abs() <= tol).all())
    if k in (0, -2):
        assert split["n_cold"] == (idx.size if mask is None else int(mask.sum()))
    if k == -1:
        assert split["n_cold"] == 0


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", EDGES)
def test_int8_plain_version_equals_jax_bitwise(k, masked, cdt):
    rows, offsets, idx, mask, hot, split, scale = _hotcold_inputs(k + 21, k, masked)
    _, q, _ = _tables(2, int(rows.sum()))
    got = emb.embedding_bag_hotcold_int8(_t(q[hot]), _t(q), _t(scale), _split_t(split),
                                         compute_dtype=cdt)
    jdt = jnp.float32 if cdt == torch.float32 else jnp.bfloat16
    assert got.dtype == cdt
    if len(hot):
        want = jax_emb.embedding_bag_hotcold_int8(jnp.asarray(q[hot]), jnp.asarray(q),
                                                  jnp.asarray(scale), _split_j(split),
                                                  compute_dtype=jdt)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    direct = emb.embedding_bag_int8(_t(q), _t(scale), _t(offsets), _t(idx), compute_dtype=cdt,
                                    mask=_t(mask))
    assert torch.equal(got, direct)


@pytest.mark.parametrize("cdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", EDGES)
def test_rowwise_plain_version_matches_jax(k, masked, cdt):
    rows, offsets, idx, mask, hot, split, _ = _hotcold_inputs(k + 31, k, masked)
    _, _, qrows = _tables(3, int(rows.sum()))
    hq, sp = _t(qrows[hot]), _split_t(split)
    got = emb.embedding_bag_hotcold_int8_rowwise(hq, _t(qrows), sp, compute_dtype=cdt)
    jdt = jnp.float32 if cdt == torch.float32 else jnp.bfloat16
    assert got.dtype == cdt
    if len(hot):
        want = jax_emb.embedding_bag_hotcold_int8_rowwise(jnp.asarray(qrows[hot]),
                                                          jnp.asarray(qrows), _split_j(split),
                                                          compute_dtype=jdt)
        want = torch.from_numpy(np.array(want.astype(jnp.float32))).to(cdt)
        tol = emb.hotcold_tolerance(got, want, hq, _t(qrows), sp, rowwise=True)
        assert bool(((got.float() - want.float()).abs() <= tol).all())
    direct = emb.embedding_bag_int8_rowwise(_t(qrows), _t(offsets), _t(idx), compute_dtype=cdt,
                                            mask=_t(mask))
    tol = emb.rowwise_tolerance(got, direct, _t(qrows), _t(offsets), _t(idx), _t(mask))
    assert bool(((got.float() - direct.float()).abs() <= tol).all())


@pytest.mark.parametrize("quant", QUANTS)
def test_cpu_wrappers_take_the_plain_path(quant):
    rows, offsets, idx, mask, hot, split, scale = _hotcold_inputs(5, 30, True)
    table, q, qrows = _tables(4, int(rows.sum()))
    sp = _split_t(split)
    wrapper = {"none": emb.embedding_bag_hotcold, "int8": emb.embedding_bag_hotcold_int8,
               "int8_rowwise": emb.embedding_bag_hotcold_int8_rowwise}[quant]
    wrapper.kernel_launches = 0
    if quant == "none":
        got = wrapper(_t(table[hot]), _t(table), sp)
        want = emb.embedding_bag_hotcold_reference(_t(table[hot]), _t(table), sp)
    elif quant == "int8":
        got = wrapper(_t(q[hot]), _t(q), _t(scale), sp)
        want = emb.embedding_bag_hotcold_int8_reference(_t(q[hot]), _t(q), _t(scale), sp)
    else:
        got = wrapper(_t(qrows[hot]), _t(qrows), sp)
        want = emb.embedding_bag_hotcold_int8_rowwise_reference(_t(qrows[hot]), _t(qrows), sp)
    assert wrapper.kernel_launches == 0 and torch.equal(got, want)


def test_wrappers_reject_what_k6_does_not_take():
    rows, offsets, idx, mask, hot, split, scale = _hotcold_inputs(6, 30, False)
    table, q, qrows = _tables(5, int(rows.sum()))
    t, ht, sp = _t(table), _t(table[hot]), _split_t(split)
    with pytest.raises(NotImplementedError, match="packed"):
        emb.embedding_bag_hotcold(ht, t, sp, pack=2)
    with pytest.raises(NotImplementedError, match="packed"):
        emb.embedding_bag_hotcold_int8(_t(q[hot]), _t(q), _t(scale), sp, pack=4)
    with pytest.raises(TypeError, match="hot_sel"):
        emb.embedding_bag_hotcold(ht, t, {**sp, "hot_sel": sp["hot_sel"].long()})
    with pytest.raises(TypeError, match="hot_mask"):
        emb.embedding_bag_hotcold(ht, t, {**sp, "hot_mask": sp["hot_mask"].to(torch.uint8)})
    with pytest.raises(TypeError, match="cold_ids"):
        emb.embedding_bag_hotcold(ht, t, {**sp, "cold_seg": sp["cold_seg"][:-1]})
    with pytest.raises(ValueError, match="hot table"):
        emb.embedding_bag_hotcold(ht.bfloat16(), t, sp)
    with pytest.raises(ValueError, match=r"d >= 1"):
        emb.embedding_bag_hotcold(ht[:, :0], t[:, :0].contiguous(), sp)
    with pytest.raises(ValueError, match="contiguous"):
        emb.embedding_bag_hotcold(ht.t().contiguous().t(), t, sp)
    with pytest.raises(TypeError, match="scale"):
        emb.embedding_bag_hotcold_int8(_t(q[hot]), _t(q), _t(scale)[:1], sp)
    with pytest.raises(TypeError, match="int8"):
        emb.embedding_bag_hotcold_int8_rowwise(ht, t, sp)
    with pytest.raises(ValueError, match=r"w >= 5"):
        emb.embedding_bag_hotcold_int8_rowwise(_t(q[hot][:, :4].copy()), _t(q[:, :4].copy()), sp)


# ---------------------------------------------------------------- K6's index arithmetic

def _cold_starts(seg: np.ndarray, n_bags: int) -> np.ndarray:
    """K6's first launch (``cold_starts_kernel``): entry i (0 <= i <= C_pad)
    writes i into every g in (seg[i - 1], seg[i]] (seg[-1] = -1, seg[C_pad]
    = n_bags), clamped to [0, n_bags]: a range of fewer than 8 bags by its
    thread, up to 255 by its warp (lane l: g = lo + l + 32 k), longer by its
    block (thread t: lo + t + 256 k). Asserts that every g is written once."""
    out = np.full(n_bags + 1, -1, np.int64)
    writes = np.zeros(n_bags + 1, int)
    for i in range(seg.size + 1):
        prev = -1 if i == 0 else int(seg[i - 1])
        cur = n_bags if i == seg.size else int(seg[i])
        lo, hi = max(prev + 1, 0), min(cur, n_bags)
        width = 1 if hi - lo + 1 < 8 else 32 if hi - lo + 1 < 256 else 256
        gs = [g for t in range(width) for g in range(lo + t, hi + 1, width)]
        out[gs] = i
        np.add.at(writes, gs, 1)
    assert (writes == 1).all()
    return out


def _simulate_k6(plan, n_bags, L, hot_mask, seg):
    """The rows K6 reads under ``plan`` (``k6_launch_plan``'s): (hot reads a
    hot slot, cold reads a cold entry, cold reads by slots past the last
    bag, which store nothing). Asserts that every cold entry a slot reads is
    its own bag's, that each step's rows come from the window's ids of the
    slot's own bag, and (long bags) that every column of every real bag is
    stored once and no lane of a bag past the last stores."""
    geo = plan.geometry
    hot_reads = np.zeros(hot_mask.size, int)
    cold_reads = np.zeros(seg.size, int)
    stray = 0
    cs = _cold_starts(seg, n_bags)
    warps = emb.K6_WARPS_PER_BLOCK * plan.grid
    tasks = -(-n_bags // plan.bags_per_warp)
    by_warp = [list(range(w, tasks, warps)) for w in range(warps)]
    assert sorted(t for ts in by_warp for t in ts) == list(range(tasks))
    if plan.rows_per_slot == 0:  # G bags a warp, windows of 32 / G * NI slots a bag
        G, NI = plan.bags_per_warp, plan.ids_per_lane
        P, S, U, V = geo.lanes_per_row, geo.slots, geo.rows_per_slot, geo.values_per_lane
        SPB, LB = S // G, 32 // G
        CH, win = SPB * U, LB * NI
        assert G == geo.bags_per_warp and S % G == 0 and win % CH == 0 and V % SPB == 0
        assert NI == emb.k6_window_ids(L, geo)
        lane = np.arange(32)
        bi, slot = lane // LB, lane // P
        s = slot % SPB
        below = (1 << lane) - 1
        seg_mask = np.array([0xFFFFFFFF if G == 1 else ((1 << LB) - 1) << (b * LB) for b in bi])
        bits = int(np.log2(SPB))
        share = np.array([int(format(x, f"0{bits}b")[::-1] or "0", 2) for x in s]) * (V // SPB)
        stored = np.zeros((n_bags, geo.values_per_lane * P), int)
        for task in range(tasks):
            bag = task * G + bi
            real = bag < n_bags
            lo = np.where(real, cs[np.minimum(bag, n_bags - 1)], 0)
            n_cold = np.where(real, cs[np.minimum(bag + 1, n_bags)] - lo, 0)
            carry = np.zeros(32, int)
            for w0 in range(0, L, win):
                code = [[None] * 32 for _ in range(NI)]  # ("hot", slot) or ("cold", entry)
                for r in range(NI):
                    ls = w0 + r * LB + lane % LB
                    inr = real & (ls < L)
                    at = np.where(inr, bag * L + np.minimum(ls, L - 1), 0)
                    hit = inr & hot_mask[at]
                    ball = int(sum(1 << int(x) for x in lane[inr & ~hit])) & 0xFFFFFFFF
                    mine = np.array([ball & int(m) for m in seg_mask])
                    rank = carry + np.array([bin(int(m) & int(bw)).count("1")
                                             for m, bw in zip(mine, below)])
                    carry = carry + np.array([bin(int(m)).count("1") for m in mine])
                    for ln in range(32):
                        if hit[ln]:
                            code[r][ln] = ("hot", int(at[ln]))
                        elif inr[ln] and not hit[ln] and rank[ln] < n_cold[ln]:
                            code[r][ln] = ("cold", int(lo[ln] + rank[ln]))
                for k in range(win // CH):
                    if w0 + k * CH >= L:
                        break
                    for u in range(U):
                        p0 = k * CH + u * SPB
                        for ln in range(0, 32, P):  # one read a slot (its P lanes load one row)
                            assert p0 % LB + s[ln] < LB  # the source lane is the bag's
                            c = code[p0 // LB][bi[ln] * LB + p0 % LB + s[ln]]
                            if c is None:
                                continue
                            if c[0] == "hot":
                                assert c[1] // L == bag[ln]
                                hot_reads[c[1]] += 1
                            else:
                                assert real[ln] and seg[c[1]] == bag[ln]
                                cold_reads[c[1]] += 1
            for ln in range(32):  # reduce_scatter over the bag's SPB slots, then the store
                if real[ln]:
                    col = (ln % P) * V + share[ln]
                    stored[bag[ln], col:col + V // SPB] += 1
        assert (stored == 1).all()
        return hot_reads, cold_reads, stray
    S, UB = geo.slots, plan.rows_per_slot  # a slot a bag
    nw = S * UB
    assert plan.bags_per_warp == S and L <= UB and plan.ids_per_lane == 1
    assert UB % geo.rows_per_slot == 0  # the bag's rows in whole steps
    for task in range(tasks):
        bag0 = task * S
        nb = min(S, n_bags - bag0)
        window = nb * L
        hcode = [bag0 * L + k if k < window and hot_mask[bag0 * L + k] else None
                 for k in range(nw)]
        st = [cs[bag0 + min(lane, nb)] for lane in range(32)]
        end, lo0 = cs[bag0 + nb], st[0]
        assert end - lo0 <= nw  # the cold window fits the lanes' ids
        for slot in range(S):
            first = st[slot]
            last = st[(slot + 1) & 31] if slot + 1 < nb else (end if slot < nb else first)
            rank, stop = first - lo0, last - lo0
            for u in range(L):
                h = hcode[min(slot * L + u, nw - 1)]
                if h is not None:
                    assert h == bag0 * L + slot * L + u
                    hot_reads[h] += 1
                    continue
                if rank < stop:
                    entry = lo0 + rank
                    assert rank < nw and seg[entry] == bag0 + slot
                    if bag0 + slot < n_bags:
                        cold_reads[entry] += 1
                    else:
                        stray += 1
                rank += 1
    return hot_reads, cold_reads, stray


def _check_k6_case(mode, itemsize, d, idx, offsets, hot, mask, pad=True, variant=None):
    """Splits ``idx`` over ``hot`` and simulates K6 on it (the shipped plan,
    or its long bags mapped ``variant``): every hot hit read once, every
    real cold entry once (by its own bag), no pad; returns the plan."""
    B, T, L = idx.shape
    s = ops_hc.split_hot_cold(idx, offsets, hot, cold_buckets=hotcold.cold_ladder(idx.size),
                              slot_mask=mask, pad=pad)
    plan = emb.k6_launch_plan(B * T, L, mode, d, itemsize)
    if variant is not None and plan.rows_per_slot == 0:
        G, U = variant
        geo = dataclasses.replace(plan.geometry, bags_per_warp=G, rows_per_slot=U)
        tasks = -(-B * T // G)
        plan = dataclasses.replace(plan, bags_per_warp=G, ids_per_lane=emb.k6_window_ids(L, geo),
                                   grid=max(1, -(-tasks // emb.K6_WARPS_PER_BLOCK)), geometry=geo)
    hot_mask = s["hot_mask"].reshape(-1)
    hot_reads, cold_reads, stray = _simulate_k6(plan, B * T, L, hot_mask, s["cold_seg"])
    np.testing.assert_array_equal(hot_reads, hot_mask.astype(int))
    n = s["n_cold"]
    assert (cold_reads[:n] == 1).all() and (cold_reads[n:] == 0).all() and stray == 0
    return plan, s


LAYOUTS = [("float", 2), ("float", 4), ("int8", 1), ("int8_rowwise", 1)]
# Long-bag mappings (G bags a warp, U rows a slot a step) simulated beside
# the shipped one for per-table int8, whose mappings pool several long bags
# a warp: U = 3 makes windows of 3 or 6 ids a lane.
INT8_VARIANTS = (None, (2, 2), (4, 4), (2, 3), (4, 3))


def _variants(mode):
    return INT8_VARIANTS if mode == "int8" else (None,)


@pytest.mark.parametrize("mode,itemsize", LAYOUTS)
@pytest.mark.parametrize("d", [32, 64])
def test_k6_index_arithmetic_covers_every_slot_once(mode, itemsize, d):
    """A simulation of K6's launches over the plans the wrapper picks
    (``k6_launch_plan``): every task is one warp's exactly once; every hot
    hit is read once, by its bag; every cold lookup once, by its bag (a
    warp a bag: the non-hot slot of rank r takes entry cold_start[g] + r; a
    slot a bag: its part of the task's cold window); a pad by no bag; a
    step's rows come from the window's ids of the slot's own bag; every
    column of a real bag is stored once. Per-table int8 also under long-bag
    mappings of 2 and 4 bags a warp (``INT8_VARIANTS``), where the number
    of bags is not always a multiple of G."""
    plans = set()
    for B, T, L, k in [(1, 1, 1, 0), (7, 3, 5, 20), (33, 5, 80, 200), (3, 2, 120, 1000),
                       (9, 4, 3, -1), (5, 7, 2, 30), (11, 3, 8, 9), (13, 2, 9, 0),
                       (40, 1, 1, 5), (21, 5, 4, 0)]:
        rows, offsets, idx, mask = _stream(B * L + k, B, T, L, rows=(120, 80, 300, 40, 77, 5, 9),
                                           masked=bool(k % 2))
        hot = (np.arange(rows.sum(), dtype=np.int64) if k < 0
               else ops_hc.select_hot_ids(idx, offsets, k))
        for variant in _variants(mode):
            plan, _ = _check_k6_case(mode, itemsize, d, idx, offsets, hot, mask, variant=variant)
            geo = plan.geometry
            assert geo.lanes_per_row * geo.slots == 32
            assert geo.chunk <= 32 // plan.bags_per_warp * plan.ids_per_lane or plan.rows_per_slot
            plans.add((plan.rows_per_slot, plan.bags_per_warp if plan.rows_per_slot == 0 else 0))
    long_bags = {g for u, g in plans if u == 0}
    assert {u for u, _ in plans} == {0, 1, 2, 4, 8}
    shipped = emb.k6_geometry(mode, d, itemsize).bags_per_warp
    assert long_bags == ({shipped, 2, 4} if mode == "int8" else {1})


def _edge_hot(case, rows, idx, offsets):
    flat = np.unique(idx.astype(np.int64) + offsets[None, :, None].astype(np.int64))
    if case in ("all hot", "all hot, no pads", "ragged, all hot"):
        return np.arange(rows.sum(), dtype=np.int64)
    if case in ("K = 0", "ragged, K = 0"):
        return np.empty(0, np.int64)
    if case == "bags with no cold lookup":  # table 0 hot: its bags have no cold entry
        return np.arange(rows[0], dtype=np.int64)
    return flat[::3] if case != "no pads" else ops_hc.select_hot_ids(idx, offsets, 25)


EDGE_CASES = ["no pads", "all hot", "all hot, no pads", "K = 0", "ragged", "ragged, all hot",
              "ragged, K = 0", "bags with no cold lookup"]


@pytest.mark.parametrize("mode,itemsize", LAYOUTS)
@pytest.mark.parametrize("L", [1, 3, 8, 9, 80, 120, 200])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_k6_index_arithmetic_edges(case, L, mode, itemsize):
    """K6's simulation at the edges of its front end: no pads (n_cold ==
    C_pad), C_pad == 0 (all hot, no pads), all hot with pads, K = 0 (all
    cold), ragged masks (slots masked out among live ones: with a hot set,
    with every row hot, where no non-hot slot is cold, and with K = 0, where
    fewer entries are cold than slots are non-hot) and bags with no cold
    lookup (long runs of cold_start); L past one window (200). Per-table
    int8 also at d = 64 (4 bags a warp, shipped) and under the long-bag
    mappings of ``INT8_VARIANTS`` (57 bags: no multiple of G)."""
    rng = np.random.default_rng(L + len(case))
    rows = np.array([60, 500, 90], np.int64)
    offsets = np.concatenate([[0], np.cumsum(rows)[:-1]]).astype(np.int32)
    B, T = 19, 3
    idx = (rng.zipf(1.3, size=(B, T, L)) % rows[None, :, None]).astype(np.int32)
    mask = None
    if case.startswith("ragged"):
        mask = rng.random(idx.shape) < 0.6
    elif case == "bags with no cold lookup":
        mask = np.ones(idx.shape, bool)
        mask[::2, 1] = False  # whole bags masked out: no lookups at all
    hot = _edge_hot(case, rows, idx, offsets)
    pad = "no pads" not in case
    runs = [(32, v) for v in _variants(mode)] + ([(64, None)] if mode == "int8" else [])
    for d, variant in runs:
        _, s = _check_k6_case(mode, itemsize, d, idx, offsets, hot, mask, pad=pad,
                              variant=variant)
    if not pad:
        assert s["cold_ids"].size == s["n_cold"]
    if case == "all hot, no pads":
        assert s["cold_ids"].size == 0
    if case == "K = 0":
        assert s["n_cold"] == idx.size
    if case == "ragged, all hot":
        assert s["n_cold"] == 0
    if case == "ragged, K = 0":
        assert s["n_cold"] == int(mask.sum()) < idx.size


@pytest.mark.parametrize("n_bags,counts", [
    (1, [0]), (7, [0] * 7), (5, [0, 0, 3, 0, 1]), (6, [1] * 6), (40, [0] * 39 + [2]),
    (300, [2] * 10 + [0] * 280 + [1] * 10), (1000, None)])
@pytest.mark.parametrize("pads", [0, 5])
def test_cold_start_build_equals_searchsorted(n_bags, counts, pads):
    """Launch 1's ranges (and the plain version, ``hotcold_cold_starts``
    on the CPU) equal np.searchsorted(cold_seg, arange(B*T + 1)): with and
    without pads, with C_pad == 0, and with long runs of bags with no cold
    entry (a warp writes those)."""
    if counts is None:
        counts = np.random.default_rng(3).poisson(0.7, n_bags)
    seg = np.concatenate([np.repeat(np.arange(n_bags), counts),
                          np.full(pads, n_bags)]).astype(np.int32)
    want = np.searchsorted(seg, np.arange(n_bags + 1))
    np.testing.assert_array_equal(_cold_starts(seg, n_bags), want)
    got = emb.hotcold_cold_starts(torch.from_numpy(seg), n_bags)
    assert got.dtype == torch.int32 and got.shape == (n_bags + 1,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_k6_geometry_mirrors_the_source():
    src = HOTCOLD_CU.read_text()
    assert re.search(rf"kWarpsPerBlock = {emb.K6_WARPS_PER_BLOCK};", src)
    assert "static constexpr int V = M == kRowwise ? 16 : 16 / (int)sizeof(TIn);" in src
    assert "static constexpr int G = M == kInt8 && !kShort && D == 64 ? 4 : 1;" in src
    assert re.search(r"static constexpr int U = kShort\s+\? 8\s+: M == kInt8\s+\? "
                     r"\(D == 64 \? 4 : 2\)\s+: M == kRowwise \? 16 / S"
                     r"\s+: \(D / 2 / S < 8 \? D / 2 / S : 8\);", src)
    assert "static constexpr int NI = M == kInt8 ? 1 : 4;" in src
    assert re.search(r"static constexpr int H = M != kFloat\s+\? 2\s+: kShort\s+\? 1"
                     r"\s+: D \* \(int\)sizeof\(TIn\) <= 64 \? 2\s+: 0;", src)
    modes = re.findall(r"enum Mode \{ kFloat = (\d), kInt8 = (\d), kRowwise = (\d) \}", src)
    assert modes == [tuple(str(emb._K6_MODES[m]) for m in ("float", "int8", "int8_rowwise"))]
    G = emb.K6Geometry
    assert emb.k6_geometry("float", 32, 2) == G(8, 4, 8, 2, 2)
    assert emb.k6_geometry("float", 64, 2) == G(8, 8, 4, 8, 0)
    assert emb.k6_geometry("float", 32, 4, True) == G(4, 8, 4, 8, 1)
    assert emb.k6_geometry("float", 64, 4) == G(4, 16, 2, 8, 0)
    # Per-table int8 long bags: K1-int8's mappings (k1_launch_plan(..., torch.int8)),
    # windows of one step; short bags every row at once; cold rows with the hint.
    assert emb.k6_geometry("int8", 32, 1) == G(16, 2, 16, 2, 2, 1, 1)
    assert emb.k6_geometry("int8", 64, 1) == G(16, 4, 8, 4, 2, 4, 1)
    assert emb.k6_geometry("int8", 64, 1, True) == G(16, 4, 8, 8, 2)
    for d in (32, 64):
        for L in (9, 80, 120):
            k1 = emb.k1_launch_plan(512, L, d, torch.int8)
            k6 = emb.k6_launch_plan(512, L, "int8", d, 1)
            assert k6.geometry.slots == k1.row_slots and k6.bags_per_warp == k1.bags_per_warp
            assert k6.geometry.rows_per_slot == k1.rows_per_lane and k6.ids_per_lane == 1
            assert k6.geometry.chunk == 32 // k6.bags_per_warp  # a window is one step
    assert emb.k6_geometry("int8_rowwise", 32, 1) == G(16, 2, 16, 1, 2)
    assert emb.k6_geometry("int8_rowwise", 64, 1, True) == G(16, 4, 8, 8, 2)
    assert "case 1: return launch<M, TIn, TC, D, SB::V, 1, 1, 0, 1, 1, TO>(a);" in src
    for u in (2, 4, 8):
        assert (f"case {u}: return launch<M, TIn, TC, D, SB::V, 1, U{u}, SB::H, {u}, 1, TO>(a);"
                in src)
        for mode, itemsize in (("int8", 1), ("float", 2), ("int8_rowwise", 1)):
            plan = emb.k6_launch_plan(100, u, mode, 32, itemsize)
            assert (plan.rows_per_slot, plan.geometry.rows_per_slot) == (u, u)  # all at once
    assert emb.k6_launch_plan(100, 1, "float", 32, 2).geometry.hint == 0
    assert emb.k6_launch_plan(100, 2, "float", 32, 2).geometry.hint == 1
    assert emb.k6_launch_plan(100, 1, "int8", 32, 1).geometry.hint == 0
    assert emb.k6_launch_plan(100, 2, "int8", 32, 1).geometry.hint == 2
    for n in (1, 2, 4, 8, 16):  # the windows the source builds, as k6_window_ids reckons them
        assert f"n{n} = window_ids<P, LB::U, LB::NI>({n})" in src
    assert "return ((p < NI ? p : NI) + U / gcd_of(U, P) - 1)" in src
    geo = dataclasses.replace(emb.k6_geometry("int8", 64, 1), ids_per_lane=4)
    assert [emb.k6_window_ids(L, geo) for L in (9, 16, 17, 120, 200)] == [2, 2, 4, 4, 4]
    geo3 = dataclasses.replace(geo, rows_per_slot=3)
    assert [emb.k6_window_ids(L, geo3) for L in (9, 17, 120)] == [3, 6, 6]
    assert emb.k6_window_ids(200, emb.k6_geometry("int8", 64, 1)) == 1
    assert emb.k6_window_ids(200, emb.k6_geometry("float", 32, 2)) == 4
    assert "lower_bounds" not in src and "cudaLaunchAttributeProgrammaticStreamSerialization" in src
    assert "griddepcontrol.wait" in src and "griddepcontrol.launch_dependents" in src
    for const in ("kStartThreads = 256", "kWarpRange = 8", "kBlockRange = 256"):  # _cold_starts'
        assert f"constexpr int {const};" in src


@pytest.mark.parametrize("start", [0, 4, 8, 12])
@pytest.mark.parametrize("short", [False, True])
@pytest.mark.parametrize("d", [32, 64])
def test_k6_rowwise_chunks_find_every_row_of_both_tables(d, short, start):
    """K6-rowwise's lanes load rows as K4 does (``_k4_lane_words``, at the
    geometry's lanes a row): for a code of each table (cold: table row c >=
    0; hot: hot row -2 - c), a hot and a cold table starting at different
    4-byte phases, every row at every phase gives each lane its words and
    the row's last lane the scale word."""
    geo = emb.k6_geometry("int8_rowwise", d, 1, short)
    lpr, nw, rb = geo.lanes_per_row, geo.values_per_lane // 4, d + 4
    assert lpr * geo.values_per_lane == d
    rng = np.random.default_rng(d + start + short)
    bufs, tables = {}, {}
    for name, at0, R in (("cold", start, 23), ("hot", (start + 4) % 16, 9)):
        tables[name] = rng.integers(0, 256, (R, rb), dtype=np.uint8)
        buf = np.zeros(-(-(at0 + R * rb) // 16) * 16, np.uint8)
        buf[at0:at0 + R * rb] = tables[name].reshape(-1)
        bufs[name] = (buf, at0)
    phases = {"cold": set(), "hot": set()}
    codes = [c for c in range(23)] + [-2 - h for h in range(9)]
    for code in codes:
        name, row = ("cold", code) if code >= 0 else ("hot", -2 - code)
        buf, at0 = bufs[name]
        at = at0 + row * rb
        phases[name].add((at >> 2) & 3)
        words = tables[name][row].view("<u4")
        for r in range(lpr):
            got = _k4_lane_words(buf, at, d, lpr, r)
            assert list(got[:nw]) == list(words[r * nw:(r + 1) * nw])
            if r == lpr - 1:
                assert got[nw] == words[d // 4]
    assert phases["cold"] == phases["hot"] == {0, 1, 2, 3}


# ---------------------------------------------------------------- models

def _cfgs(name, dtype, quant, **kw):
    args = dict(table_scale=SCALE, param_dtype=dtype, compute_dtype=dtype, table_quant=quant,
                **kw)
    return zoo.get_config(name, **args), jax_zoo.get_config(name, **args)


@functools.cache
def _model_case(name: str, quant: str):
    """Weights (``bridge.init_numpy``, f32 and bf16), a batch, a zipf batch
    and its hot set, shared by the model tests."""
    cfg, _ = _cfgs(name, "float32", quant)
    batch = RecDataGenerator(cfg, seed=1).generate_batch(fixture.ZOO_BATCH)
    idx = skew_bench.zipf_stream(cfg, fixture.ZOO_BATCH, seed=2)
    hot = ops_hc.select_hot_ids(idx, cfg.table_offsets, max(1, cfg.total_rows // 4))
    return batch, idx, hot


def _forward_pair(name, dtype, quant):
    cfg, jcfg = _cfgs(name, dtype, quant)
    batch, idx, hot = _model_case(name, quant)
    np_params = bridge.init_numpy(cfg, fixture.WEIGHT_SEED)
    jp = fixture._jax_params(np_params)
    model = get_model(cfg, "cpu")
    hc = hotcold.make_hotcold_model(model, hot)
    params = hc.convert_params(bridge.params_from_numpy(np_params, cfg, "cpu"))
    host = Batch(batch.dense, idx)
    split = hc.prepare(host)
    with torch.inference_mode():
        got = hc.apply(params, host.to("cpu"), _split_t(split)).float().numpy()
    jmodel = jax_get_model(jcfg)
    return cfg, jcfg, jmodel, jp, hot, host, split, got


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("name", zoo.MODEL_NAMES)
def test_hotcold_model_matches_jax_f32(name, quant):
    """The port's hot/cold model against JAX's on the same weights, hot set
    and zipf batch, in f32; the split the same arrays."""
    cfg, jcfg, jmodel, jp, hot, host, split, got = _forward_pair(name, "float32", quant)
    jhc = jax_hotcold.make_hotcold_model(jmodel, hot)
    jsplit = jhc.prepare(JaxBatch(host.dense, host.indices))
    for k in ("hot_sel", "hot_mask", "cold_ids", "cold_seg", "n_cold"):
        np.testing.assert_array_equal(np.asarray(split[k]), np.asarray(jsplit[k]), err_msg=k)
    want = np.asarray(jhc.apply(jhc.convert_params(jax.tree_util.tree_map(jnp.asarray, jp)),
                                JaxBatch(host.dense, jnp.asarray(host.indices)),
                                _split_j(jsplit)), dtype=np.float32)
    assert got.shape == want.shape == (fixture.ZOO_BATCH, cfg.out_dim)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("name", zoo.MODEL_NAMES)
def test_hotcold_model_bf16_matches_jax_direct(name, quant):
    """In bf16 the port's hot/cold model pools as its direct lookup does (f32
    sums of bf16 rows), so it is held to JAX's direct model at the zoo's
    bf16 limit."""
    cfg, jcfg, jmodel, jp, hot, host, split, got = _forward_pair(name, "bfloat16", quant)
    want = np.asarray(jax.jit(jmodel.apply)(jp, JaxBatch(host.dense, host.indices))
                      .astype(jnp.float32))
    np.testing.assert_allclose(got, want, rtol=0, atol=chip_smoke.bf16_atol(want))


@pytest.mark.parametrize("name", zoo.MODEL_NAMES)
def test_hot_ids_and_coverage_from_generator_equal_jax(name):
    cfg, jcfg = _cfgs(name, "float32", "none")
    for rows, n in ((64, 4), (1 << 20, 8)):
        got = hotcold.hot_ids_and_coverage_from_generator(cfg, 31, rows, n_batches=n,
                                                          batch_size=64)
        want = jax_hotcold.hot_ids_and_coverage_from_generator(jcfg, 31, rows, n_batches=n,
                                                               batch_size=64)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    np.testing.assert_array_equal(hotcold.hot_ids_from_generator(cfg, 3, 10, n_batches=2),
                                  jax_hotcold.hot_ids_from_generator(jcfg, 3, 10, n_batches=2))


def test_coverage_is_estimated_out_of_sample():
    """JAX tests/test_serving.py:1162: a budget past the sample's distinct
    ids reads in-sample 1.0 on a uniform stream; out of sample it does not."""
    hot, cov = hotcold.hot_ids_and_coverage_from_generator(
        zoo.get_config("ncf", table_scale=10), seed=31, hot_rows=16384)
    assert len(hot) < 16384 and cov < 0.5
    _, cov_all = hotcold.hot_ids_and_coverage_from_generator(
        zoo.get_config("rm1", table_scale=2000), seed=31, hot_rows=65536)
    assert cov_all > 0.9


@pytest.mark.parametrize("quant", QUANTS)
def test_masked_hotcold_matches_masked_direct(quant):
    """JAX tests/test_ops.py:488: the hot/cold model on a ragged batch (the
    mask consumed by the host split) equals the direct model's masked
    forward."""
    cfg, _ = _cfgs("rm1", "float32", quant)
    rng = np.random.default_rng(7)
    batch = RecDataGenerator(cfg, seed=3).generate_batch(8)
    lengths = rng.integers(0, cfg.num_indices_per_lookup + 1, size=(8, cfg.num_tables))
    mask = np.arange(cfg.num_indices_per_lookup)[None, None, :] < lengths[:, :, None]
    model = get_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    hot = ops_hc.select_hot_ids(batch.indices, cfg.table_offsets, 500)
    hc = hotcold.make_hotcold_model(model, hot)
    host = Batch(batch.dense, batch.indices, mask)
    split = hc.prepare(host)
    with torch.inference_mode():
        got = hc.apply(hc.convert_params(params), Batch(batch.dense, batch.indices).to("cpu"),
                       _split_t(split))
        want = model.apply(params, host.to("cpu"))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_hot_table_is_a_new_tensor_and_with_hot_ids_keeps_apply():
    cfg, _ = _cfgs("rm1", "float32", "none")
    model = get_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    hc = hotcold.make_hotcold_model(model, np.array([0, 5, 9], dtype=np.int64))
    p1 = hc.convert_params(params)
    assert p1["tables"] is params["tables"] and "hot_table" not in params
    torch.testing.assert_close(p1["hot_table"], params["tables"][[0, 5, 9]])
    assert p1["hot_table"].data_ptr() != params["tables"].data_ptr()
    hc2 = hotcold.with_hot_ids(hc, np.array([1, 2], dtype=np.int64))
    assert hc2.apply is hc.apply and list(hc2.hot_ids) == [1, 2]
    p2 = hc2.convert_params({k: v for k, v in p1.items() if k != "hot_table"})
    torch.testing.assert_close(p2["hot_table"], params["tables"][[1, 2]])
    torch.testing.assert_close(p1["hot_table"], params["tables"][[0, 5, 9]])  # untouched


# ---------------------------------------------------------------- skew_bench

@pytest.mark.parametrize("name", ["rm1", "ncf", "din"])
def test_skew_streams_and_auto_decision_equal_jax(name):
    for scale in (SCALE, 1):
        cfg = zoo.get_config(name, table_scale=scale, param_dtype="bfloat16")
        jcfg = jax_zoo.get_config(name, table_scale=scale, param_dtype="bfloat16")
        idx = skew_bench.zipf_stream(cfg, 16)
        np.testing.assert_array_equal(idx, jax_skew.zipf_stream(jcfg, 16))
        np.testing.assert_array_equal(skew_bench.drifted_zipf_stream(cfg, 16),
                                      jax_skew.drifted_zipf_stream(jcfg, 16))
        hot, cov = skew_bench._hot_set(cfg, idx)
        jhot, jcov = jax_skew._hot_set(jcfg, idx)
        np.testing.assert_array_equal(hot, jhot)
        assert cov == jcov == skew_bench.stream_coverage(cfg, idx, hot)
        got, want = skew_bench.resolve_auto_impl(cfg, idx), jax_skew.resolve_auto_impl(jcfg, idx)
        assert got[0] == want[0] and got[2] == want[2]


def test_measure_skewed_needs_a_card():
    with pytest.raises(RuntimeError, match="CUDA card"):
        skew_bench.measure_skewed("rm1", "cpu", table_scale=SCALE)
