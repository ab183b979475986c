"""K1b's, K1-int8's and K4's ownership windows over the tables that meet
a shard, on the CPU.

A row shard ``[row_lo, row_lo + rows)`` of the fused table meets a
contiguous range of tables, known on the host before an id is read
(``ops.embedding.table_range``); the windows of K1b, K1-int8 and K4 launch
only over the bags of those tables, and only the range's two end tables,
where they straddle a shard edge, test each slot against the window
(``csrc/window_tables.cuh``). Here: the range against a brute force over
every fused row, the ranges the mesh path hands the wrappers (given,
derived, refused where they do not fit), Python mirrors of the kernels'
task mappings (every owned slot visited once, no foreign bag read, the
foreign bags zero), the premise on the plain versions (a bag of a table
outside the range adds nothing), and the bounds and timing helpers that
count only the meeting tables' ids.

Tolerances: the mirrors add the same f32 terms as the plain versions in
another order, so they are held within ``backward_tolerance`` and
``rowwise_tolerance`` of the window; K1-int8's int32 pool is exact, so its
mirror and wrapper equal the plain version bit for bit; the premise checks
are exact zeros.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from deeprecsys_tpu_torch import kernel_bench, zoo
from deeprecsys_tpu_torch.experiments import parent_turns
from deeprecsys_tpu_torch.models.base import Batch
from deeprecsys_tpu_torch.ops import embedding as emb
from deeprecsys_tpu_torch.parallel import make_mesh, sharding

CSRC = Path(__file__).resolve().parents[1] / "deeprecsys_tpu_torch" / "ops" / "csrc"
SCALE = 40  # rm1: 8 tables of 100,000 rows; dien: 41 of 12,500 and 2 of 125,000


def _brute_range(offsets, total: int, row_lo: int, rows: int):
    """The meeting tables and the straddling ones, from the table of every
    fused row: ``(lo, hi, lo_straddles, hi_straddles)``."""
    table_of = np.searchsorted(np.asarray(offsets), np.arange(total), side="right") - 1
    inside = (np.arange(total) >= row_lo) & (np.arange(total) < row_lo + rows)
    meet = np.unique(table_of[inside])
    if meet.size == 0:
        return 0, 0, False, False
    outside = set(np.unique(table_of[~inside]).tolist())
    return int(meet[0]), int(meet[-1]) + 1, int(meet[0]) in outside, int(meet[-1]) in outside


def _ranges():
    out = []
    for name, shards in (("rm1", (2, 4, 8)), ("rm2", (2, 4, 8)), ("dien", (4,)),
                         ("mtwnd", (4,))):
        cfg = zoo.get_config(name, table_scale=SCALE)
        for M in shards:
            rps = cfg.total_rows // M
            out += [(name, m * rps, rps) for m in range(M)]
    rm1 = zoo.get_config("rm1", table_scale=SCALE)
    t = rm1.scaled_rows[0]
    out += [("rm1", 10, t // 2),                           # inside one table
            ("rm1", t // 2, 2 * t),                        # across three
            ("rm1", rm1.total_rows - t, t),                # the last table
            ("rm1", rm1.total_rows - t - 5, t + 5),        # the last table and a straddler
            ("rm1", 3 * t, 0)]                             # an empty shard
    return out


@pytest.mark.parametrize("name,row_lo,rows", _ranges())
def test_table_range_matches_a_brute_force(name, row_lo, rows):
    cfg = zoo.get_config(name, table_scale=SCALE)
    R = cfg.total_rows
    want = _brute_range(cfg.table_offsets, R, row_lo, rows)
    got = emb.table_range(cfg.table_offsets, row_lo, rows, R)
    assert (got.lo, got.hi, got.lo_edge, got.hi_edge) == want
    # Without the fused rows the last table counts as straddling.
    derived = emb.table_range_of(torch.as_tensor(cfg.table_offsets), row_lo, rows)
    last = got.hi == cfg.num_tables and rows > 0
    assert derived == (got if not last else emb.TableRange(got.lo, got.hi, got.lo_edge, True))


def test_shard_table_ranges_are_made_once_and_reach_the_wrappers(monkeypatch):
    """The mesh path's ranges (``shard_table_ranges``, from the config on
    the host) match the brute force and reach K4's window (``sharded_apply``'s
    lookup) and K1b's window (the dense step's backward) unchanged."""
    cfg = zoo.get_config("dien", table_scale=1000)
    M, R = 4, cfg.total_rows
    rps = R // M
    ranges = sharding.shard_table_ranges(cfg, rps, M)
    assert ranges is sharding.shard_table_ranges(cfg, rps, M)  # cached a placement
    for m, tr in enumerate(ranges):
        assert (tr.lo, tr.hi, tr.lo_edge, tr.hi_edge) == _brute_range(cfg.table_offsets, R,
                                                                       m * rps, rps)
    mesh = make_mesh(1, M, devices=["cpu"] * M)
    offsets = sharding.Replicated(mesh, torch.as_tensor(cfg.table_offsets, dtype=torch.int32))
    g = torch.Generator().manual_seed(0)
    idx = torch.stack([torch.randint(0, n, (8, 1), generator=g) for n in cfg.scaled_rows],
                      dim=1).to(torch.int32)
    batch = Batch(dense=None, indices=idx, mask=None)
    seen = {"k4": [], "k1b": []}

    def record(key, fn):
        def call(*args, **kw):
            seen[key].append(kw.get("table_range"))
            return fn(*args, **kw)
        return call

    monkeypatch.setattr(emb, "embedding_bag_int8_rowwise_shard",
                        record("k4", emb.embedding_bag_int8_rowwise_shard))
    monkeypatch.setattr("deeprecsys_tpu_torch.ops.embedding_bag_int8_rowwise_shard",
                        emb.embedding_bag_int8_rowwise_shard)
    monkeypatch.setattr(emb, "embedding_bag_backward_shard",
                        record("k1b", emb.embedding_bag_backward_shard))
    qrows = emb.quantize_rowwise_int8(torch.randn((R, 32), generator=g))
    sp = sharding.shard_params({"tables": {"qrows": qrows}}, mesh)
    sharding.pooled_on_row(sp, 0, batch, cfg, offsets)
    table = torch.randn((R, 32), generator=g, requires_grad=True)
    sp = sharding.shard_params({"tables": table}, mesh)
    sharding.pooled_on_row(sp, 0, batch, cfg, offsets).sum().backward()
    # The backward runs the shards' windows last first.
    assert seen["k4"] == list(ranges) and seen["k1b"] == list(ranges)[::-1]


def test_host_offsets_copy_once_per_tensor(monkeypatch):
    offsets = torch.tensor([0, 10, 30], dtype=torch.int32)
    copies = []
    real = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist", lambda t: copies.append(1) or real(t))
    for _ in range(3):
        assert emb.host_offsets(offsets) == (0, 10, 30)
    assert len(copies) == 1
    offsets[1] = 20  # an in-place change bumps the version: copied again
    assert emb.host_offsets(offsets) == (0, 20, 30) and len(copies) == 2
    other = offsets.clone()
    emb.host_offsets(other)
    assert len(copies) == 3
    with torch.inference_mode():  # an inference tensor keeps no version: copied once
        frozen = torch.tensor([0, 7], dtype=torch.int32)
        assert emb.host_offsets(frozen) == emb.host_offsets(frozen) == (0, 7)
    assert len(copies) == 4


# ------------------------------------------------- the kernels' task mappings

def _source_int(path: Path, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", path.read_text())
    assert m, name
    return int(m.group(1))


def test_mirrored_constants_match_the_sources():
    assert emb.K4W_ZERO_BAGS == _source_int(CSRC / "embedding_bag_int8.cu", "kZeroBags")
    assert emb.K1B_WARPS_PER_BLOCK == _source_int(CSRC / "embedding_bag_backward.cu",
                                                  "kWarpsPerBlock")
    assert _source_int(CSRC / "embedding_bag_backward.cu", "kRedFloats") == 4


def _tested(t: int, tr: emb.TableRange) -> bool:
    return (t == tr.lo and tr.lo_edge) or (t == tr.hi - 1 and tr.hi_edge)


def _window_bag(k: int, T: int, tr: emb.TableRange) -> int:
    nt = tr.hi - tr.lo
    return (k // nt) * T + tr.lo + k % nt


def _inputs(name: str, B: int, seed: int, masked: bool):
    cfg = zoo.get_config(name, table_scale=1000)
    g = torch.Generator().manual_seed(seed)
    idx = torch.stack([torch.randint(0, n, (B, cfg.num_indices_per_lookup), generator=g)
                       for n in cfg.scaled_rows], dim=1).to(torch.int32)
    mask = torch.rand(idx.shape, generator=g) < 0.7 if masked else None
    return cfg, torch.as_tensor(cfg.table_offsets, dtype=torch.int32), idx, mask, g


CELLS = [("rm1", 4, 1), ("rm1", 4, 2), ("dien", 4, 1), ("dien", 4, 2), ("rm2", 4, 0),
         ("rm1", 4, "shifted")]


def _window(cfg, M: int, m):
    rps = cfg.total_rows // M
    if m == "shifted":
        return rps + cfg.scaled_rows[0] // 2, rps
    return m * rps, rps


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name,M,m", CELLS)
def test_k1b_window_mirror_visits_each_owned_slot_once(name, M, m, masked):
    """A mirror of ``embedding_bag_backward_window_kernel``'s mapping: tasks
    over B * nt * ceil(L / 32) (a bag of a meeting table and 32 of its
    slots), the window test only where the table straddles. Every owned
    slot adds once, an untested slot always lies in the shard, no bag of
    another table is read, and the gradient matches the plain version."""
    cfg, offsets, idx, mask, g = _inputs(name, 5, seed=len(name) + M, masked=masked)
    B, T, L = idx.shape
    d = 8
    row_lo, rows = _window(cfg, M, m)
    tr = emb.table_range(cfg.table_offsets, row_lo, rows, cfg.total_rows)
    grad_in = torch.randn((B, T, d), generator=g)
    chunks, nt = -(-L // 32), tr.hi - tr.lo
    off = cfg.table_offsets
    got = torch.zeros((rows, d))
    visits = np.zeros((B, T, L), dtype=np.int64)
    for task in range(B * nt * chunks):
        k, c = divmod(task, chunks)
        bag = _window_bag(k, T, tr)
        b, t = divmod(bag, T)
        assert tr.lo <= t < tr.hi
        for l in range(c * 32, min(L, c * 32 + 32)):
            visits[b, t, l] += 1
            if mask is not None and not mask[b, t, l]:
                continue
            local = int(off[t]) + int(idx[b, t, l]) - row_lo
            inside = 0 <= local < rows
            if _tested(t, tr) and not inside:
                continue
            assert inside, "a slot of an untested table fell outside the shard"
            got[local] += grad_in[b, t]
    assert visits[:, tr.lo:tr.hi].min() == 1 and visits.max() == 1
    assert visits[:, :tr.lo].sum() == 0 and visits[:, tr.hi:].sum() == 0
    assert emb._k1b_grid(idx, nt) == -(-B * nt * chunks // emb.K1B_WARPS_PER_BLOCK)
    w = (row_lo, row_lo + rows)
    want = emb.embedding_bag_backward_reference(grad_in, offsets, idx, rows, mask=mask, window=w)
    assert bool(((got - want).abs()
                 <= emb.backward_tolerance(grad_in, offsets, idx, rows, mask, window=w)).all())


@pytest.mark.parametrize("D", [32, 64, 128, 256])
def test_k1b_window_vector_lanes_cover_each_row_once(D):
    """``add_slots``' lanes at kRedFloats 4: LPR lanes a row, 32 / LPR rows a
    warp instruction, each lane CPL chunks of 4 f32: over a task's 32
    slots every (slot, column) is added exactly once."""
    E = _source_int(CSRC / "embedding_bag_backward.cu", "kRedFloats")
    LPR = min(32, D // E)
    CPL = D // E // LPR
    for n in (32, 17, 1):
        cover = np.zeros((32, D), dtype=np.int64)
        for j0 in range(0, n, 32 // LPR):
            for lane in range(32):
                j = j0 + lane // LPR  # the slot lane j0 + sub's id names
                if j >= n:
                    continue
                col = (lane % LPR) * E
                for c in range(CPL):
                    for e in range(E):
                        cover[j, c * LPR * E + col + e] += 1
        assert (cover[:n] == 1).all() and (cover[n:] == 0).all()


@pytest.mark.parametrize("d", [32, 64, 8])
@pytest.mark.parametrize("name,M,m", CELLS)
def test_k4_window_mirror_zeroes_foreign_bags_and_reads_none(name, M, m, d):
    """A mirror of K4's window (``embedding_bag_int8_rowwise_kernel`` and the
    general instance with kWindow): ``k4_window_plan``'s groups of G bags
    over the meeting tables' B * nt bags, then zero tasks of K4W_ZERO_BAGS
    foreign bags (the general instance a warp a bag). Every bag is written
    once, a foreign bag's row is zero and its ids are never read, an
    untested slot lies in the shard, and the partial matches the plain
    version."""
    cfg, offsets, idx, mask, g = _inputs(name, 9, seed=d + M, masked=True)
    B, T, L = idx.shape
    row_lo, rows = _window(cfg, M, m)
    tr = emb.table_range(cfg.table_offsets, row_lo, rows, cfg.total_rows)
    qrows = emb.quantize_rowwise_int8(torch.randn((rows, d), generator=g))
    plan = emb.k4_window_plan(B, T, tr.hi - tr.lo, L, d)
    got = _mirror_window(plan, cfg, idx, mask, tr, row_lo, rows,
                         emb.dequant_packed_rows(qrows), torch.float32)
    w = (row_lo, row_lo + rows)
    want = emb.embedding_bag_int8_rowwise_reference(qrows, offsets, idx, mask=mask, window=w)
    assert bool(((got - want).abs()
                 <= emb.rowwise_tolerance(got, want, qrows, offsets, idx, mask, window=w)).all())


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("d", [32, 64, 8])
@pytest.mark.parametrize("name,M,m", CELLS)
def test_k1_int8_window_mirror_covers_every_bag_once(name, M, m, d, masked):
    """A mirror of K1-int8's window (``embedding_bag_int8_kernel`` and the
    general instance with kWindow), as K4's above: ``k1i_window_plan``'s
    groups of G bags over the meeting tables' B * nt bags, then its zero
    tasks (the general instance a warp a bag): the groups and the zero
    tasks together write every bag once, read no foreign id, and the int32
    pool equals the plain version bit for bit."""
    cfg, offsets, idx, mask, g = _inputs(name, 9, seed=2 * d + M, masked=masked)
    B, T, L = idx.shape
    row_lo, rows = _window(cfg, M, m)
    tr = emb.table_range(cfg.table_offsets, row_lo, rows, cfg.total_rows)
    q = torch.randint(-127, 128, (rows, d), generator=g, dtype=torch.int8)
    plan = emb.k1i_window_plan(B, T, tr.hi - tr.lo, L, d)
    assert plan.general == (d not in emb.TUNED_WIDTHS)
    assert plan.grid == -(-plan.tasks // emb.K1_WARPS_PER_BLOCK)
    got = _mirror_window(plan, cfg, idx, mask, tr, row_lo, rows, q.to(torch.int32), torch.int32)
    want = emb.embedding_bag_int8_reference(q, None, offsets, idx, mask=mask,
                                            window=(row_lo, row_lo + rows))
    assert torch.equal(got, want)


def _mirror_window(plan, cfg, idx, mask, tr, row_lo: int, rows: int, vals, dtype):
    """The partial a window plan over the meeting tables computes
    (K1-int8's and K4's kernels with kWindow): groups of G bags over the
    B * nt meeting bags, each adding ``vals`` of the slots it owns (the
    window test only on a straddling table), then zero tasks of
    K4W_ZERO_BAGS foreign bags (the general instance: a warp a bag of
    either kind). Asserts that every bag is written once, that no foreign
    bag's id is read, and that an untested slot lies in the shard."""
    B, T, L = idx.shape
    d = vals.shape[1]
    nt = tr.hi - tr.lo
    G = 1 if plan.general else plan.bags_per_warp
    n_own, n_foreign = B * nt, B * (T - nt)
    own_tasks = -(-n_own // G)
    zero_bags = 1 if plan.general else emb.K4W_ZERO_BAGS
    assert plan.tasks == own_tasks + -(-n_foreign // zero_bags)
    out = torch.full((B * T, d), float("nan")).to(dtype)
    writes = np.zeros(B * T, dtype=np.int64)
    read = np.zeros((B, T), dtype=bool)
    off = cfg.table_offsets
    for task in range(plan.tasks):
        if task >= own_tasks:
            for f in range((task - own_tasks) * zero_bags,
                           min(n_foreign, (task - own_tasks + 1) * zero_bags)):
                b, j = divmod(f, T - nt)
                bag = b * T + (j if j < tr.lo else j + nt)
                out[bag] = 0
                writes[bag] += 1
            continue
        for bi in range(G):
            k = task * G + bi
            if k >= n_own:
                continue
            bag = _window_bag(k, T, tr)
            b, t = divmod(bag, T)
            read[b, t] = True
            acc = torch.zeros(d, dtype=dtype)
            for l in range(L):
                if mask is not None and not mask[b, t, l]:
                    continue
                local = int(off[t]) + int(idx[b, t, l]) - row_lo
                inside = 0 <= local < rows
                if _tested(t, tr) and not inside:
                    continue
                assert inside, "a slot of an untested table fell outside the shard"
                acc += vals[local]
            out[bag] = acc
            writes[bag] += 1
    assert (writes == 1).all()
    assert read[:, tr.lo:tr.hi].all() and not read[:, :tr.lo].any() and not read[:, tr.hi:].any()
    got = out.reshape(B, T, d)
    assert bool((got[:, :tr.lo] == 0).all()) and bool((got[:, tr.hi:] == 0).all())
    return got


@pytest.mark.parametrize("place", ["1/4", "1/4 + half a table"])
def test_int8_windows_take_a_given_or_derived_range_and_refuse_one_that_does_not_fit(place):
    """K1-int8's and K4's window wrappers (the plain versions on the CPU)
    with the range a placement makes and with the one they derive from the
    offsets: the same partial, K1-int8's the plain int32 pool bit for bit;
    a range past the tables raises on either device's path."""
    cfg, offsets, idx, mask, g = _inputs("rm1", 6, seed=11, masked=True)
    row_lo, rows = _window(cfg, 4, 1 if place == "1/4" else "shifted")
    w = (row_lo, row_lo + rows)
    q = torch.randint(-127, 128, (rows, 32), generator=g, dtype=torch.int8)
    qrows = emb.quantize_rowwise_int8(torch.randn((rows, 32), generator=g))
    placed = emb.table_range(cfg.table_offsets, row_lo, rows, cfg.total_rows)
    assert placed.hi - placed.lo == (2 if place == "1/4" else 3)
    want = emb.embedding_bag_int8_reference(q, None, offsets, idx, mask=mask, window=w)
    want4 = emb.embedding_bag_int8_rowwise_reference(qrows, offsets, idx, mask=mask, window=w)
    for tr in (placed, None):
        assert torch.equal(emb.embedding_bag_int8_shard(q, offsets, idx, row_lo, mask=mask,
                                                        table_range=tr), want)
        assert torch.equal(emb.embedding_bag_int8_rowwise_shard(
            qrows, offsets, idx, row_lo, mask=mask, table_range=tr), want4)
    bad = emb.TableRange(cfg.num_tables - 1, cfg.num_tables + 1, False, True)
    with pytest.raises(ValueError, match="does not fit"):
        emb.embedding_bag_int8_shard(q, offsets, idx, row_lo, table_range=bad)
    with pytest.raises(ValueError, match="does not fit"):
        emb.embedding_bag_int8_rowwise_shard(qrows, offsets, idx, row_lo, table_range=bad)


def test_shard_table_ranges_reach_the_k1_int8_window(monkeypatch):
    """``sharded_apply``'s lookup over per-table int8 tables hands each
    shard's K1-int8 window the placement's range (``shard_table_ranges``),
    and the combined pool equals the direct K1-int8 bit for bit."""
    cfg = zoo.get_config("dien", table_scale=1000)
    M, R = 4, cfg.total_rows
    rps = R // M
    ranges = sharding.shard_table_ranges(cfg, rps, M)
    mesh = make_mesh(1, M, devices=["cpu"] * M)
    offsets = sharding.Replicated(mesh, torch.as_tensor(cfg.table_offsets, dtype=torch.int32))
    g = torch.Generator().manual_seed(1)
    idx = torch.stack([torch.randint(0, n, (8, 1), generator=g) for n in cfg.scaled_rows],
                      dim=1).to(torch.int32)
    seen = []
    real = emb.embedding_bag_int8_shard

    def record(*args, **kw):
        seen.append(kw.get("table_range"))
        return real(*args, **kw)

    monkeypatch.setattr("deeprecsys_tpu_torch.ops.embedding_bag_int8_shard", record)
    tables = emb.quantize_pertable_int8(torch.randn((R, 32), generator=g), cfg.scaled_rows)
    sp = sharding.shard_params({"tables": tables}, mesh)
    got = sharding.pooled_on_row(sp, 0, Batch(dense=None, indices=idx, mask=None), cfg, offsets)
    assert seen == list(ranges)
    want = emb.embedding_bag_int8(tables["q"], tables["scale"], offsets.on(torch.device("cpu")),
                                  idx, compute_dtype=got.dtype)
    assert torch.equal(got, want)


@pytest.mark.parametrize("name,M", [("dien", 4), ("rm1", 4)])
def test_the_range_drops_no_work_on_the_plain_versions(name, M):
    """The premise, on the plain versions at dien's straddling 1/4 shards
    and rm1's aligned ones: a bag of a table outside the shard's range has
    a zero K4 partial row, and its gradient adds nothing to K1b's window."""
    cfg, offsets, idx, mask, g = _inputs(name, 16, seed=M, masked=False)
    B, T, L = idx.shape
    rps = cfg.total_rows // M
    table = torch.randn((cfg.total_rows, 8), generator=g)
    qrows = emb.quantize_rowwise_int8(table)
    for m, tr in enumerate(sharding.shard_table_ranges(cfg, rps, M)):
        w = (m * rps, (m + 1) * rps)
        part = emb.embedding_bag_int8_rowwise_reference(qrows[w[0]:w[1]], offsets, idx, window=w)
        assert bool((part[:, :tr.lo] == 0).all()) and bool((part[:, tr.hi:] == 0).all())
        foreign = torch.randn((B, T, 8), generator=g)
        foreign[:, tr.lo:tr.hi] = 0
        grad = emb.embedding_bag_backward_reference(foreign, offsets, idx, rps, window=w)
        assert bool((grad == 0).all())


# ------------------------------------------------ the bounds and the timings

def test_window_bounds_count_the_meeting_tables_only():
    cfg, offsets, idx, _, g = _inputs("rm1", 16, seed=3, masked=False)
    B, T, L = idx.shape
    rps = cfg.total_rows // 4
    meet = kernel_bench.meeting_ids(offsets, idx, rps, rps)
    assert torch.equal(meet, idx[:, 2:4])  # rm1's shard 1 of 4 holds tables 2 and 3
    gr = torch.randn((B, T, 32), generator=g)
    flat = (idx.long() + offsets.long()[None, :, None]).reshape(-1)
    owned = (flat >= rps) & (flat < 2 * rps)
    rows = torch.unique(flat[owned]).numel()
    k1b = kernel_bench.k1b_window_bound(gr, offsets, idx, rps, rps)
    assert k1b["bytes"] == rows * 32 * 8 + B * 2 * 32 * 4 + B * 2 * L * 4
    shard = torch.zeros((rps, 36), dtype=torch.int8)
    k4 = kernel_bench.window_bound(shard, rps, offsets, idx, 32, 2)
    assert k4["bytes"] == rows * 36 + B * 2 * L * 4 + B * T * 32 * 4
    assert k4["flops"] == int(owned.sum()) * 32 * 2


@pytest.mark.parametrize("place", [p for _, p in parent_turns.WINDOW_PLACES[:3]])
def test_turns_calls_hold_the_plain_versions(place):
    """``parent_turns``' window calls (those ``kernel_bench --only k1bw,k4w``
    times too) at a small scale on the CPU: each is checked against its plain
    version when made, and the shifted place meets three tables."""
    cpu = torch.device("cpu")
    inp = parent_turns.window_inputs("rm1", place, 8, cpu, n_batches=2, table_scale=1000)
    tr = emb.table_range_of(inp["offsets"], inp["row_lo"], inp["rows"])
    assert tr.hi - tr.lo == (3 if place.endswith("half a table") else 2)
    fn, args, plain, grad = parent_turns.k1bw_call(inp, cpu)
    fn(*args[0])  # both add into the kept gradient
    got = grad.clone()
    grad.zero_()
    plain(*args[0])
    assert torch.equal(got, grad) and bool(got.abs().sum() > 0)
    fn, args, plain, _ = parent_turns.k4w_call(inp, cpu)
    assert torch.equal(fn(*args[0]), plain(*args[0]))


@pytest.mark.parametrize("place", [p for _, p in parent_turns.WINDOW_PLACES[:3]])
def test_k1iw_turns_call_holds_the_plain_version(place):
    """``parent_turns.k1iw_call`` (which ``kernel_bench --only k1iw`` times
    too) at a small scale on the CPU: its call and plain version give the
    same int32 pool, zero on the tables outside the window."""
    cpu = torch.device("cpu")
    inp = parent_turns.window_inputs("rm1", place, 8, cpu, n_batches=2, table_scale=1000)
    fn, args, plain, shard = parent_turns.k1iw_call(inp, cpu)
    got = fn(*args[1])
    tr = emb.table_range_of(inp["offsets"], inp["row_lo"], inp["rows"])
    assert torch.equal(got, plain(*args[1])) and got.dtype == torch.int32
    assert bool(got[:, tr.lo:tr.hi].abs().sum() > 0)
    assert not bool(got[:, :tr.lo].any()) and not bool(got[:, tr.hi:].any())


def test_the_sweeps_build_one_substitution_each():
    """``experiments/k1bw_sweep.py`` and ``k4w_sweep.py`` build the shipped
    source (headers made reachable from ``build/``) and one unit a design,
    each differing from it by its substituted lines alone."""
    from deeprecsys_tpu_torch.experiments import k1bw_sweep, k4w_sweep
    from deeprecsys_tpu_torch.ops import _build

    for mod, units in ((k1bw_sweep, k1bw_sweep.units(_build.CSRC / "embedding_bag_backward.cu")),
                       (k4w_sweep, k4w_sweep.units(_build.CSRC))):
        assert len(units) == len(mod.DESIGNS)
        shipped, *others = units.values()
        assert '#include "window_tables.cuh"' not in shipped
        for text, design in zip(others, list(mod.DESIGNS.values())[1:]):
            subs = design if mod is k1bw_sweep else design[0]  # (subs, zero bags, U)
            assert text != shipped
            for old, new in subs:
                assert text == shipped.replace(old, new)
