"""K6's cold-only route and K5's planned ownership window, on the CPU.

K6 on a shard that counts no hot hit (every shard of a mesh but the first)
pools its cold stream alone: the plain version
(``embedding_bag_cold_partial_reference``) against the JAX shard body's
segment sum and against the hot/cold plain version with an all-false mask,
the mesh path's routing, and a simulation of the cold-only instance's
chunk arithmetic (``csrc/embedding_bag_hotcold.cu``). K5's window: its
plan (``k5_window_plan``) against the source, a simulation of launch 1's
slots and appends, and ``kernel_bench``'s yardsticks and bounds for both
kernels, and the window's plan and PDL sweep's build.

Tolerances: per-table int8 bit for bit (exact int32 sums); float and
row-wise layouts ``cold_tolerance``/``hotcold_tolerance`` (the same f32
terms summed in another order), f32 rtol 1e-5 against JAX's segment sum.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprecsys_tpu_torch import kernel_bench
from deeprecsys_tpu_torch.ops import embedding as emb
from deeprecsys_tpu_torch.ops import hotcold as ops_hc
from deeprecsys_tpu_torch.ops import sparse_adagrad as sa
from deeprecsys_tpu_torch.parallel import make_mesh, sharding

CSRC = Path(__file__).resolve().parents[1] / "deeprecsys_tpu_torch" / "ops" / "csrc"
QUANTS = ("none", "int8", "int8_rowwise")
MODE = {"none": "float", "int8": "int8", "int8_rowwise": "int8_rowwise"}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _table(quant: str, R: int, d: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    if quant == "none":
        return torch.randn((R, d), generator=g)
    q = torch.randint(-127, 128, (R, d + (4 if quant == "int8_rowwise" else 0)), generator=g,
                      dtype=torch.int8)
    if quant == "int8_rowwise":
        q[:, d:] = (torch.rand((R,), generator=g) * 1e-2 + 1e-4).view(torch.int8).reshape(R, 4)
    return q


def _shard_splits(seed: int, M: int = 4, B: int = 8, T: int = 3, L: int = 20, R: int = 600,
                  n_hot: int = 40):
    """A zipf stream split over M row shards (``split_hot_cold_sharded``)."""
    rng = np.random.default_rng(seed)
    offsets = np.array([0, 200, 400], dtype=np.int64)[:T]
    idx = (rng.zipf(1.3, size=(B, T, L)) % 200).astype(np.int32)
    hot = np.sort(rng.choice(R, size=n_hot, replace=False)).astype(np.int64)
    return ops_hc.split_hot_cold_sharded(idx, offsets, hot, M, R // M), idx, offsets, hot


def _cold_split(split: dict, m: int) -> dict:
    B, T, _ = split["hot_sel"].shape
    return {"cold_ids": _t(split["cold_local"][m]), "cold_seg": _t(split["cold_seg"][m]),
            "bags": (B, T)}


def _no_hits_split(split: dict, m: int) -> dict:
    return {"hot_sel": _t(split["hot_sel"]), "hot_mask": torch.zeros(split["hot_mask"].shape,
                                                                     dtype=torch.bool),
            "cold_ids": _t(split["cold_local"][m]), "cold_seg": _t(split["cold_seg"][m])}


def _hotcold_ref(quant, hot, shard, split):
    if quant == "none":
        return emb.embedding_bag_hotcold_reference(hot, shard, split, partial=True)
    if quant == "int8":
        return emb.embedding_bag_hotcold_int8_reference(hot, shard, None, split, partial=True)
    return emb.embedding_bag_hotcold_int8_rowwise_reference(hot, shard, split, partial=True)


@pytest.mark.parametrize("quant", QUANTS)
@pytest.mark.parametrize("seed", [0, 1])
def test_cold_partial_equals_the_hotcold_partial_with_no_hits(quant, seed):
    """The cold-only plain version of each shard m >= 1 against the hot/cold
    plain version with an all-false mask: int8 bit for bit, the others
    within ``hotcold_tolerance`` (and ``cold_tolerance``)."""
    split, _, _, hot_ids = _shard_splits(seed)
    table = _table(quant, 600, 32, seed)
    hot = table[_t(hot_ids)]
    for m in range(1, 4):
        shard = table[m * 150:(m + 1) * 150]
        got = emb.embedding_bag_cold_partial_reference(shard, _cold_split(split, m),
                                                       mode=MODE[quant])
        nohit = _no_hits_split(split, m)
        want = _hotcold_ref(quant, hot, shard, nohit)
        assert got.dtype == want.dtype and got.shape == want.shape
        if quant == "int8":
            assert torch.equal(got, want)
            continue
        rowwise = quant == "int8_rowwise"
        tol = emb.hotcold_tolerance(got, want, hot, shard, nohit, rowwise=rowwise)
        assert bool(((got - want).abs() <= tol).all())
        tol = emb.cold_tolerance(got, want, shard, _cold_split(split, m), rowwise=rowwise)
        assert bool(((got - want).abs() <= tol).all())


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_cold_partial_equals_the_jax_shard_body(quant):
    """JAX's ``local_fn`` (parallel/sharding.py:212-216): the shard's cold
    rows gathered and ``segment_sum``-ed into B*T + 1 bags, the last
    dropped; f32 rtol 1e-5, int8 exactly."""
    split, _, _, _ = _shard_splits(5)
    table = _table(quant, 600, 32, 5)
    B, T, _ = split["hot_sel"].shape
    for m in range(4):
        shard = table[m * 150:(m + 1) * 150]
        got = emb.embedding_bag_cold_partial_reference(shard, _cold_split(split, m),
                                                       mode=MODE[quant])
        rows = jnp.take(jnp.asarray(shard.numpy()), jnp.asarray(split["cold_local"][m]), axis=0)
        rows = rows.astype(jnp.int32 if quant == "int8" else jnp.float32)
        want = jax.ops.segment_sum(rows, jnp.asarray(split["cold_seg"][m]),
                                   num_segments=B * T + 1)[:B * T].reshape(B, T, -1)
        if quant == "int8":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        else:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("quant", QUANTS)
def test_cpu_shard_wrappers_take_the_cold_only_route(quant):
    """``hot_table=None``: the wrapper's plain cold-only partial on the CPU,
    and its checks."""
    split, _, _, _ = _shard_splits(2)
    shard = _table(quant, 600, 32, 2)[150:300]
    cold = _cold_split(split, 1)
    wrap = {"none": emb.embedding_bag_hotcold_shard, "int8": emb.embedding_bag_hotcold_int8_shard,
            "int8_rowwise": emb.embedding_bag_hotcold_int8_rowwise_shard}[quant]
    want = emb.embedding_bag_cold_partial_reference(shard, cold, mode=MODE[quant])
    assert torch.equal(wrap(None, shard, cold), want)
    with pytest.raises(TypeError):
        wrap(None, shard, dict(cold, cold_seg=cold["cold_seg"].long()))
    with pytest.raises(ValueError):
        wrap(None, shard, dict(cold, bags=(-1, 3)))


@pytest.mark.parametrize("D,M", [(1, 4), (2, 2), (1, 1)])
@pytest.mark.parametrize("quant", QUANTS)
def test_hotcold_row_sends_the_shards_past_the_first_down_the_cold_route(quant, D, M,
                                                                         monkeypatch):
    """``parallel/sharding.py::_hotcold_row``: shard 0 of each data row
    takes K6 with the hits, every other shard the cold-only route (no hot
    table, no hot arrays); the mesh lookup still equals the direct one."""
    from deeprecsys_tpu_torch import ops

    name = {"none": "embedding_bag_hotcold_shard", "int8": "embedding_bag_hotcold_int8_shard",
            "int8_rowwise": "embedding_bag_hotcold_int8_rowwise_shard"}[quant]
    calls, orig = [], getattr(ops, name)

    def record(hot, shard, split, **kw):
        calls.append((hot is None, sorted(split)))
        return orig(hot, shard, split, **kw)

    monkeypatch.setattr(ops, name, record)
    rng = np.random.default_rng(4)
    offsets = np.array([0, 200, 400], dtype=np.int64)
    idx = (rng.zipf(1.3, size=(8, 3, 20)) % 200).astype(np.int32)
    hot_ids = np.sort(rng.choice(600, size=40, replace=False)).astype(np.int64)
    table = _table(quant, 600, 32, 4)
    split = ops_hc.split_hot_cold_hybrid(idx, offsets, hot_ids, D, M, 600 // M)
    kw = {"table_scale": _t(np.full(3, 0.01, np.float32))} if quant == "int8" else {}
    mesh = make_mesh(D, M, devices=["cpu"] * (D * M))
    got = sharding.hybrid_embedding_bag_hotcold(table[_t(hot_ids)], table, split, mesh,
                                                rowwise=quant == "int8_rowwise", **kw)
    hits = ["cold_ids", "cold_seg", "hot_mask", "hot_sel"]
    assert calls == [(m > 0, hits if m == 0 else ["bags", "cold_ids", "cold_seg"])
                     for _ in range(D) for m in range(M)]
    off32, ids = _t(offsets.astype(np.int32)), _t(idx)
    if quant == "none":
        want = emb.embedding_bag(table, off32, ids)
    elif quant == "int8":
        want = emb.embedding_bag_int8(table, kw["table_scale"], off32, ids)
    else:
        want = emb.embedding_bag_int8_rowwise(table, off32, ids)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------- the cold-only instance, simulated

def _first_pad(seg: np.ndarray, hi: int, n_bags: int) -> int:
    """``first_pad``: 32 probes a round, spaced by ceil((hi - lo) / 32)."""
    lo = 0
    while lo < hi:
        step = -(-(hi - lo) // 32)
        probes = [lo + j * step for j in range(32)]
        pads = [p >= hi or seg[p] >= n_bags for p in probes]
        if not any(pads):
            lo += 31 * step + 1
            continue
        j = pads.index(True)
        hi = min(lo + j * step, hi)
        if j > 0:
            lo += (j - 1) * step + 1
    return lo


def _simulate_cold(seg: np.ndarray, n_bags: int, S: int, chunk: int = 32):
    """K6's cold-only instance (``embedding_bag_cold_partial_kernel``): a
    warp a chunk of ``chunk`` entries. A chunk of real entries owns the
    bags (seg[c0 - 1], its last real segment] (the last chunk's to
    n_bags - 1): the zero run before its first begun bag, then rounds of S
    begun bags, a slot a bag, each bag's entries [start, end) from the
    begin ballot (the last one's end past the chunk), then the zero run
    after each bag up to the next (the last one's up to the chunk's end).
    The pad-only chunks split the bags past the stream's last real entry.
    Returns each bag's writes and the entries its slot read."""
    C = seg.size
    segc = np.minimum(seg, n_bags)
    n_chunks = max(1, -(-C // chunk))

    def s(i):
        return int(segc[i]) if i < C else n_bags

    writes = np.zeros(n_bags, int)
    reads = [[] for _ in range(n_bags)]

    def zero(a, b):
        writes[max(a, 0):b + 1] += 1

    for ch in range(n_chunks):
        c0 = ch * chunk
        before = -1 if c0 == 0 else int(segc[c0 - 1])
        lane = [s(c0 + j) for j in range(chunk)]
        if lane[0] >= n_bags:  # pad-only
            pad = 0 if c0 == 0 else c0 if before < n_bags else _first_pad(segc, c0 - 1, n_bags)
            assert pad == int(np.searchsorted(segc, n_bags))
            last_real = -1 if pad == 0 else int(segc[pad - 1])
            k0 = -(-pad // chunk)
            share = -(-(n_bags - 1 - last_real) // (n_chunks - k0))
            lo = last_real + 1 + (ch - k0) * share
            zero(lo, min(lo + share, n_bags) - 1)
            continue
        begins = [j for j in range(chunk)
                  if lane[j] != (before if j == 0 else lane[j - 1]) and lane[j] < n_bags]
        lo = before + 1
        real = [j for j in range(chunk) if lane[j] < n_bags]
        hi = n_bags - 1 if c0 + chunk >= C else lane[real[-1]]
        if not begins:
            zero(lo, hi)
            continue
        zero(lo, lane[begins[0]] - 1)
        last = lane[begins[-1]]
        end = c0 + begins[-1] + 1
        while s(end) == last:
            end += 1
        for k0 in range(0, len(begins), S):  # S begun bags a round, a slot a bag
            for k in range(k0, min(k0 + S, len(begins))):
                bag = lane[begins[k]]
                start = c0 + begins[k]
                stop = c0 + begins[k + 1] if k + 1 < len(begins) else end
                assert all(int(segc[e]) == bag for e in range(start, stop))
                reads[bag] += list(range(start, stop))
                writes[bag] += 1
            for k in range(k0, min(k0 + S, len(begins))):  # the zero runs, in turn
                nxt = lane[begins[k + 1]] if k + 1 < len(begins) else hi + 1
                zero(lane[begins[k]] + 1, nxt - 1)
    return writes, reads


def _cold_stream(case: str, n_bags: int, rng) -> np.ndarray:
    if case == "empty":
        return np.zeros(0, np.int32)
    if case == "pads":  # a shard that owns no cold entry: every bag zero
        return np.full(640, n_bags, np.int32)
    if case == "many_pads":  # a few real entries, then 20 chunks of pads
        return np.r_[np.sort(rng.integers(0, n_bags // 3, 45)),
                     np.full(640, n_bags)].astype(np.int32)
    if case == "long":  # one bag of 150 entries across five chunks, between short ones
        return np.sort(np.r_[np.full(150, n_bags // 2), rng.integers(0, n_bags, 40),
                             np.full(9, n_bags)]).astype(np.int32)
    if case == "no_pads":
        return np.sort(rng.integers(0, n_bags, 96)).astype(np.int32)
    if case == "tail":  # entries only in the last bags, then pads
        return np.r_[np.full(5, n_bags - 2), np.full(3, n_bags - 1),
                     np.full(24, n_bags)].astype(np.int32)
    counts = rng.poisson(2.5, n_bags) * (rng.random(n_bags) < 0.8)  # ragged, some empty
    seg = np.repeat(np.arange(n_bags), counts)
    return np.r_[seg, np.full(-seg.size % 64 + 7, n_bags)].astype(np.int32)


@pytest.mark.parametrize("S", [2, 4, 8, 16])
@pytest.mark.parametrize("case", ["ragged", "empty", "pads", "many_pads", "long", "no_pads",
                                  "tail"])
def test_k6_cold_chunks_write_every_bag_once(case, S):
    rng = np.random.default_rng(len(case) + S)
    n_bags = 77
    seg = _cold_stream(case, n_bags, rng)
    writes, reads = _simulate_cold(seg, n_bags, S)
    assert (writes == 1).all()
    for bag in range(n_bags):
        assert reads[bag] == list(np.flatnonzero(seg == bag))


@pytest.mark.parametrize("seed", range(6))
def test_k6_cold_first_pad_search_finds_the_first_pad(seed):
    rng = np.random.default_rng(seed)
    n_bags, C = 50, int(rng.integers(1, 5000))
    seg = np.sort(rng.integers(0, n_bags + 1, C))
    seg[-1] = n_bags
    assert _first_pad(seg, C - 1, n_bags) == int(np.searchsorted(seg, n_bags))


def test_k6_cold_instance_mirrors_the_source():
    src = (CSRC / "embedding_bag_hotcold.cu").read_text()
    assert f"constexpr int kColdChunk = {emb.K6_COLD_CHUNK};" in src
    assert "constexpr int U = M == kRowwise ? kColdRows / 2 : kColdRows;" in src
    assert "for (int k0 = 0; k0 < c.nb; k0 += S) {" in src
    assert "int drs_embedding_bag_cold_partial(int mode, int table_dtype, int d," in src
    assert emb.k6_cold_grid(0) == 1 and emb.k6_cold_grid(1) == 1
    assert emb.k6_cold_grid(emb.K6_COLD_CHUNK * emb.K6_WARPS_PER_BLOCK) == 1
    assert emb.k6_cold_grid(emb.K6_COLD_CHUNK * emb.K6_WARPS_PER_BLOCK + 1) == 2
    assert emb.k6_cold_grid(122_880) == 480


def test_k6_cold_bound_counts_the_stream_the_rows_and_the_partial():
    split, _, _, _ = _shard_splits(3)
    shard = _table("none", 600, 32, 3)[150:300]
    cold = _cold_split(split, 1)
    b = kernel_bench.k6_cold_bound(shard, cold)
    B, T = cold["bags"]
    real = cold["cold_seg"] < B * T
    rows = torch.unique(cold["cold_ids"][real]).numel()
    assert b["bytes"] == cold["cold_ids"].numel() * 8 + rows * 32 * 4 + B * T * 32 * 4
    assert b["flops"] == int(real.sum()) * 32
    rw = kernel_bench.k6_cold_bound(_table("int8_rowwise", 600, 32, 3)[150:300], cold,
                                    "int8_rowwise")
    assert rw["bytes"] == cold["cold_ids"].numel() * 8 + rows * 36 + B * T * 32 * 4
    assert rw["flops"] == 2 * b["flops"]


# --------------------------------------------------------------- K5's window

def test_k5_window_plan_mirrors_the_source():
    """The plan's lanes are K5's (``k5_launch_plan``) or, at the general
    instance's widths, the power of two >= L up to 32; the C entry takes
    the plan and a bf16 shard's one count, which it zeroes by a memset on
    the stream ahead of launch 1 (so a CUDA graph replays the zeroing), and
    its keys, which it sets to -1 the same way (no scratch is kept between
    calls); launch 1 takes a window of S slots of a bag a task."""
    src = (CSRC / "sparse_adagrad.cu").read_text()
    assert re.search(r"int lanes_per_bag, int general,\s+void\* count, void\* keys", src)
    assert re.search(r"void\* merged, void\* stream\)", src)
    assert "cudaMemsetAsync(w.count, 0, sizeof(int32_t), a.stream)" in src
    assert "if (err == 0)\n    err = (int)cudaMemsetAsync(w.keys, 0xff," in src
    assert "fill_keys" not in src
    assert src.count("zero_count(a, w)") == 2  # the vector and the general windows'
    for zero, launch1 in (("int err = zero_count(a, w);",
                           "err = launch_window_accumulate<TG, D>(a, D, w);"),
                          ("int err = merge ? zero_count(a, w) : 0;",
                           "err = launch_window_accumulate<TG, 0>(a, d, w);")):
        assert src.index(zero) < src.index(launch1)
    assert "const int64_t task = t / S;" in src and "const int64_t bag = task / windows;" in src
    f32, bf16 = torch.float32, torch.bfloat16
    for L in (1, 3, 8, 20, 80, 120, 200):
        for d, dt in ((32, f32), (64, bf16), (8, f32), (12, f32), (100, bf16)):
            p = sa.k5_window_plan(128 * 8, L, d, dt, f32)
            k5 = sa.k5_launch_plan(128 * 8, L, d, dt, f32)
            assert p.general == k5.general
            if k5.general:
                assert p.lanes_per_bag == min(32, 1 << max(0, L - 1).bit_length())
            else:
                assert p.lanes_per_bag == k5.lanes_per_bag


@pytest.mark.parametrize("L", [1, 3, 8, 80, 120, 200])
@pytest.mark.parametrize("d,dt", [(32, torch.float32), (64, torch.bfloat16), (12, torch.float32)])
def test_k5_window_launch1_reads_every_slot_once_and_lists_the_owned(L, d, dt):
    """Launch 1's slots, shipped and measured. Shipped
    (``window_accumulate_kernel``): thread t takes task t / S (a window of
    S slots of bag task / windows), slot (task % windows) * S + t % S of it.
    Measured (``experiments/k5w_sweep.py``, a bag a task): thread t takes
    bag t / S and, in chunks of ``ROUNDS`` rounds of S slots, slot c + r *
    S + t % S; its list holds each owned slot once, a warp appending once a
    chunk in which it owns a slot (once a bag of up to 128 slots). Both
    read every slot of the stream once."""
    from deeprecsys_tpu_torch.experiments import k5w_sweep

    n_bags = 37
    S = sa.k5_window_plan(n_bags, L, d, dt, torch.float32).lanes_per_bag
    rng = np.random.default_rng(L)
    owned = rng.random((n_bags, L)) < 0.3
    seen = np.zeros((n_bags, L), int)
    windows = -(-L // S)
    threads = -(-n_bags * windows * S // sa.K5_THREADS) * sa.K5_THREADS
    for t in range(threads):
        task = t // S
        bag, l = task // windows, (task % windows) * S + t % S
        if bag < n_bags and l < L:
            seen[bag, l] += 1
    assert (seen == 1).all()

    R = k5w_sweep.ROUNDS
    seen[:] = 0
    listed, adds, chunks = [], 0, 0
    threads = -(-n_bags * S // sa.K5_THREADS) * sa.K5_THREADS
    for w0 in range(0, threads, 32):  # a warp
        for c in range(0, L, R * S):
            chunks += 1
            ball = []
            for r in range(R):
                for t in range(w0, w0 + 32):
                    bag, l = t // S, c + r * S + t % S
                    if bag < n_bags and l < L:
                        seen[bag, l] += 1
                        if owned[bag, l]:
                            ball.append((bag, l))
            adds += bool(ball)
            listed += ball
    assert (seen == 1).all()
    assert sorted(listed) == [tuple(x) for x in np.argwhere(owned)]
    assert adds <= chunks == threads // 32 * -(-L // (R * S))
    if L > 32:  # a warp a bag
        assert S == 32 and adds <= n_bags * -(-L // (R * 32))


def test_k5w_bf16_library_is_the_once_rounded_step():
    """``kernel_bench.k5w_library_bf16`` on the owned slots' prepared rows
    computes the plain version's bf16 window step exactly."""
    R, d, lo, rows = 600, 32, 150, 150
    g = torch.Generator().manual_seed(8)
    offsets = torch.tensor([0, 200, 400], dtype=torch.int32)
    ids = torch.randint(0, 200, (16, 3, 20), generator=g, dtype=torch.int32) % 40
    grad = torch.randn((16, 3, d), generator=g) * 1e-2
    shard = ((torch.rand((rows, d), generator=g) - 0.5) * 0.1).bfloat16()
    acc = torch.rand((rows,), generator=g) * 1e-3
    want_t, want_a = shard.clone(), acc.clone()
    sa.sparse_adagrad_step_reference(want_t, want_a, offsets, ids, grad, 0.1,
                                     window=(lo, lo + rows))
    got_t, got_a = shard.clone(), acc.clone()
    p = kernel_bench.window_g_rows(grad, offsets, ids, lo, rows)
    kernel_bench.k5w_library_bf16(got_t, got_a, 0.1)(*p, *torch.unique(p[2], return_inverse=True))
    assert torch.equal(got_t, want_t) and torch.equal(got_a, want_a)


def test_k6w_inputs_split_the_shards_as_the_mesh_path_does():
    """``kernel_bench.hotcold_shard_inputs`` at a small scale: the hot set
    fitted on a warm-up batch, the splits of the later batches; shard 0's
    split holds the hits, shard 1's its cold stream and ``bags``; each
    bench call equals its plain version (the CPU takes the plain path), and
    the bound averages over the same batches."""
    inp = kernel_bench.hotcold_shard_inputs("rm1", "none", torch.device("cpu"), n_batches=2,
                                            table_scale=20_000)
    assert len(inp["splits"]) == len(inp["ids"]) == 2
    s = inp["splits"][0]
    assert set(s[0]) == {"hot_sel", "hot_mask", "cold_ids", "cold_seg"}
    assert set(s[1]) == {"cold_ids", "cold_seg", "bags"}
    assert s[1]["bags"] == tuple(s[0]["hot_sel"].shape[:2])
    for call, m in (("with_hits", 0), ("no_hits", 1)):
        fns = kernel_bench.k6_shard_calls("none", inp["hot"], inp["shards"][m])[call]
        assert torch.equal(fns[0](s[m]), fns[1](s[m]))
    bounds = [kernel_bench.k6_cold_bound(inp["shards"][1], sp[1]) for sp in inp["splits"]]
    mean = kernel_bench.mean_bound(bounds)
    assert mean["bytes"] == pytest.approx(sum(b["bytes"] for b in bounds) / 2)
    assert mean["bound_ms"] == pytest.approx(sum(b["bound_ms"] for b in bounds) / 2)


def test_k6_cold_sweep_variants_apply_to_the_shipped_source():
    """``experiments/k6_cold_sweep.py``: each variant's substitution still
    matches the source once, so each unit differs from the shipped one."""
    from deeprecsys_tpu_torch.experiments import k6_cold_sweep
    from deeprecsys_tpu_torch.ops import _build

    units = list(k6_cold_sweep.units(_build.CSRC / "embedding_bag_hotcold.cu").values())
    assert len(units) == len(k6_cold_sweep.VARIANTS)
    assert len(set(units)) == len(units)


def test_k6_shard0_sweep_units_build_the_shipped_source():
    """``experiments/k6_shard0_sweep.py``: every unit holds the shipped K6
    source whole (its header inlined), one case a key over the pool alone
    without PDL, and the host pointer; the shipped mapping of each layout
    is ``k6_launch_plan``'s at the model's shard-0 shape."""
    from deeprecsys_tpu_torch import zoo
    from deeprecsys_tpu_torch.experiments import k6_shard0_sweep as sw
    from deeprecsys_tpu_torch.ops import _build

    keys = []
    for name in sw.MODELS:
        cfg = zoo.get_config(name)
        d, L = cfg.sparse_feature_size, cfg.num_indices_per_lookup
        for layout in sw.LAYOUTS:
            ship = sw.key_of(layout, d, L, sw.shipped(layout, d))
            plan = emb.k6_launch_plan(512 * cfg.num_tables, L, MODE[layout], d,
                                      2 if layout == "none" else 1)
            assert ship[2:] == (plan.ids_per_lane, plan.geometry.values_per_lane,
                                plan.bags_per_warp, plan.geometry.rows_per_slot,
                                plan.geometry.hint)
            keys += [ship] + [sw.key_of(layout, d, L, i) for i in sw.instances(layout, d)]
    keys = list(dict.fromkeys(keys))
    units = sw.units(_build.CSRC, keys)
    src = (_build.CSRC / "embedding_bag_hotcold.cu").read_text().replace(
        '#include "pooled_rows.cuh"', (_build.CSRC / "pooled_rows.cuh").read_text())
    assert all(u.startswith(src) and u.endswith(sw.POINTER_SOURCE) for u in units.values())
    cases = [u[len(src):].count("    case ") for u in units.values()]
    assert sum(cases) == len(keys) and "(a, false);" in "".join(units.values())


@pytest.fixture(scope="module")
def k6s0_pointer(tmp_path_factory):
    """``k6_shard0_sweep.POINTER_SOURCE`` built with the host's g++."""
    import ctypes
    import subprocess

    from deeprecsys_tpu_torch.experiments import k6_shard0_sweep as sw

    out = tmp_path_factory.mktemp("k6s0_pointer")
    cpp = out / "pointer.cpp"
    cpp.write_text("#include <cstdint>\n" + sw.POINTER_SOURCE)
    subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(out / "pointer.so"), str(cpp)],
                   check=True)
    lib = ctypes.CDLL(str(out / "pointer.so"))
    getattr(lib, sw.POINTER).restype = None
    getattr(lib, sw.POINTER).argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_void_p]
    return lib


@pytest.mark.parametrize("case", ["zipf", "ragged", "all pads", "no pads", "hybrid D = 2"])
def test_k6_shard0_sweep_host_pointers_match_the_reference(k6s0_pointer, case):
    """Design (a)'s host pointers in ``experiments/k6_shard0_sweep.py`` (the
    native one-pass loop and numpy's ``bincount``/``cumsum``) equal
    ``hotcold_cold_starts_reference`` on shard 0's cold stream of
    ``split_hot_cold_sharded`` (a ragged mask, every row hot so the stream
    is all pads, the whole table as one shard with no pads) and on each
    data shard's cell of ``split_hot_cold_hybrid``."""
    from deeprecsys_tpu_torch.experiments import k6_shard0_sweep as sw

    rng = np.random.default_rng(len(case))
    B, T, L, rows = 24, 3, 17, 300
    idx = (rng.zipf(1.2, size=(B, T, L)) % rows).astype(np.int32)
    off64 = np.arange(T, dtype=np.int64) * rows
    mask = rng.random((B, T, L)) < 0.5 if case == "ragged" else None
    hot_ids = (np.arange(rows * T, dtype=np.int64) if case == "all pads"
               else ops_hc.select_hot_ids(idx, off64, 20))
    if case == "hybrid D = 2":
        sp = ops_hc.split_hot_cold_hybrid(idx, off64, hot_ids, 2, 4, rows * T // 4)
        cells, n_bags = [sp["cold_seg"][0, 0], sp["cold_seg"][1, 0]], B // 2 * T
    elif case == "no pads":
        sp = ops_hc.split_hot_cold(idx, off64, hot_ids, pad=False)
        cells, n_bags = [sp["cold_seg"]], B * T
    else:
        sp = ops_hc.split_hot_cold_sharded(idx, off64, hot_ids, 4, rows * T // 4, slot_mask=mask)
        cells, n_bags = [sp["cold_seg"][0]], B * T
    for seg in cells:
        seg = np.ascontiguousarray(seg, dtype=np.int32)
        want = emb.hotcold_cold_starts_reference(_t(seg), n_bags).numpy()
        np.testing.assert_array_equal(sw.host_pointer(k6s0_pointer, seg, n_bags), want)
        np.testing.assert_array_equal(sw.numpy_pointer(seg, n_bags), want)
        if case == "all pads":
            assert not want.any()
        if case == "no pads":
            assert want[-1] == seg.size > 0


def test_k5w_sweep_builds_the_shipped_source_and_one_without_pdl():
    """``experiments/k5w_sweep.py``: its units hold the shipped K5 source
    whole, the measured design and its entry point added; the second has
    ``Shipped::kPdl`` false and differs in nothing else."""
    from deeprecsys_tpu_torch.experiments import k5w_sweep
    from deeprecsys_tpu_torch.ops import _build

    src = (_build.CSRC / "sparse_adagrad.cu").read_text()
    units = k5w_sweep.units(_build.CSRC / "sparse_adagrad.cu")
    pdl, no_pdl = units["k5w_pdl"], units["k5w_no_pdl"]
    head, tail = src.split("}  // namespace\n")
    assert pdl.count(head) == 1 and tail in pdl and "bag_accumulate_kernel" in pdl
    assert f"constexpr int kBagRounds = {k5w_sweep.ROUNDS};" in pdl
    assert 'extern "C" int drs_k5w_bag(' in pdl
    assert no_pdl != pdl and no_pdl.replace(*k5w_sweep.PDL[::-1]) == pdl
