"""The mesh paths across several CUDA cards of one host: every shard on its
own card, the partials moved between cards and combined, the engine's
stream on each card. Without two cards these tests skip; the CPU tests
(``tests/test_torch_parallel.py``) run the same paths on one device. The
file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_mesh_gpu.py

Each output is held to the single-device forward on the first card, on the
same f32 weights: rtol 2e-4, atol 2e-5 (the JAX mesh tests'), the sharded
sums differing only in their order; per-table int8 pools bit for bit.
A dense and a sparse mesh training step (every shard and every copy of the
towers on its own card, the gradients of the copies added across cards) are
held to the single-device step: the loss rtol 1e-5, the table and the
accumulator the JAX sharded-step test's limits (rtol 1e-4, atol 1e-6 and
1e-7), every copy of a replicated leaf (and, dense, of a table shard) equal
to the first. The trainer over several cards replays a graph a part of the
step on each card (``parallel/sharding.py::mesh_train_stages``): over four
steps it stays within ``chip_smoke.py``'s ``GRAPH_*`` limits of the step
function called eagerly on the same cards (the two differ only in the order
of K1b's and K5's atomic adds), and a replayed step makes no host
synchronization.

An engine over several cards (``ComputeEngine(mesh=)`` on 2x2, 1x4 and 1x2
meshes of distinct cards, as many as there are cards): every program a
graph a card's part, each first replay the engine's eager forward bit for
bit (max |err| 0.0) and the reference's scores within the limits above,
payloads as the single-device forward, launches around a run its
executions times the captures' tally (one lookup launch a shard on its
card, dien's scans on each row's card); the int8 layouts, hot/cold and
dien; a same-size refresh writes every card's hot table in place; a reload
under queued replays captures the programs again; a replayed execution
makes no host synchronization.

Across processes of one card each (two cards or more): two spawned
processes over ``nccl`` form one 1x2 mesh, and each trainer (dense and
sparse, adagrad), built eager for its replays' measured slowdown, takes
its programs and replays a CUDA graph a step that holds its NCCL
collectives; over four steps its losses and params stay within the
``GRAPH_*`` limits of the step function called eagerly in the same
processes and of one process's 1x2 mesh over the same two cards; every
child reports within ``NCCL_WAIT_S`` or is killed.

Across processes (four cards or more): two spawned processes of two cards
each over ``nccl`` form one 1x4 mesh; the forward is held to the
single-device forward, the hot/cold tensor-parallel model (on zipf(1.2)
ids) and the table-wise model to one process's 1x4 mesh (rtol 2e-4, atol
2e-5), one sparse step to the single-process 1x4 mesh's (the loss rtol
1e-5, the whole table the JAX sharded-step limits).
"""

import multiprocessing as mp
import queue
import socket
import time
import traceback

import numpy as np
import pytest
import torch

from deeprecsys_tpu_torch import ServingConfig, bridge, ops, train, zoo
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.experiments.skew_bench import zipf_stream
from deeprecsys_tpu_torch.models import get_model
from deeprecsys_tpu_torch.models.base import Batch, table_offsets
from deeprecsys_tpu_torch.models.hotcold import hot_ids_from_generator, make_hotcold_model
from deeprecsys_tpu_torch.ops import embedding_bag_int8
from deeprecsys_tpu_torch.parallel import (
    distributed_init, make_mesh, shard_params, sharded_apply, unshard_params)
from deeprecsys_tpu_torch.parallel import sharding
from deeprecsys_tpu_torch.parallel.api import make_tablewise_model
from deeprecsys_tpu_torch.serving import engine, packets
from deeprecsys_tpu_torch.train_programs import NCCL_SLOWER

pytestmark = pytest.mark.gpu

SCALE = 100
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture
def cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards or more")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _axes(n: int) -> list:
    return [(1, n), (n, 1)] + ([(2, n // 2)] if n % 2 == 0 and n > 2 else [])


def _model(first, quant="none"):
    cfg = zoo.get_config("rm1", table_scale=SCALE, table_quant=quant)
    model = get_model(cfg, first)
    params = model.init(torch.Generator(device=first).manual_seed(0))
    return cfg, model, params


@pytest.mark.parametrize("quant", ["none", "int8", "int8_rowwise"])
def test_sharded_apply_across_cards(cards, quant):
    """Each shard on its own card (shard_params copies it there); the
    forward matches the single-device forward, and a per-table int8 data
    row's pooled lookup is K1-int8's bits."""
    cfg, model, params = _model(cards[0], quant)
    batch = RecDataGenerator(cfg, seed=1).generate_batch(64)
    want = model.apply(params, batch.to(cards[0])).cpu().numpy()
    for D, M in _axes(len(cards)):
        mesh = make_mesh(D, M, devices=cards[:D * M])
        sp = shard_params(params, mesh)
        for d in range(D):
            for m in range(M):
                leaf = sp.entry(d, m)["tables"]
                leaf = leaf if quant == "none" else next(
                    v for v in leaf.values() if v.dim() == 2)
                assert leaf.device == mesh.device(d, m)
        got = sharded_apply(model, mesh, has_dense=True)(sp, batch)
        assert got.device == cards[0]
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=RTOL, atol=ATOL)
        if quant == "int8":
            offs = sharding.Replicated(mesh, table_offsets(cfg, "cpu"))
            for d, sl in enumerate(sharding.split_batch(batch.to(cards[0]), mesh)):
                pooled = sharding.pooled_on_row(sp, d, sl, cfg, offs)
                assert torch.equal(pooled.to(cards[0]), embedding_bag_int8(
                    params["tables"]["q"], params["tables"]["scale"], offs.on(cards[0]),
                    sl.indices, compute_dtype=torch.float32))


@pytest.mark.parametrize("quant", ["none", "int8", "int8_rowwise"])
def test_hotcold_across_cards(cards, quant):
    """The tensor-parallel and hybrid hot/cold lookups with each shard's K6
    on its own card, on zipf(1.2) ids: the single-device direct forward."""
    cfg, model, params = _model(cards[0], quant)
    idx = zipf_stream(cfg, 64, seed=5)
    dense = np.random.default_rng(5).random((64, cfg.dense_dim), dtype=np.float32)
    want = model.apply(params, Batch(dense=dense, indices=idx).to(cards[0])).cpu().numpy()
    hot_ids = hot_ids_from_generator(cfg, seed=5, hot_rows=256, n_batches=2, batch_size=64)
    for D, M in _axes(len(cards)):
        mesh = make_mesh(D, M, devices=cards[:D * M])
        hc = make_hotcold_model(model, hot_ids, mesh=mesh)
        sp = shard_params(hc.convert_params(params), mesh)
        split = hc.prepare(Batch(dense=dense, indices=idx))
        got = hc.apply(sp, Batch(dense=torch.from_numpy(dense), indices=None), split)
        np.testing.assert_allclose(got.cpu().numpy(), want, rtol=RTOL, atol=ATOL)


# The meshes of distinct cards an engine is held on, as many as the cards allow.
ENGINE_AXES = [(2, 2), (1, 4), (1, 2)]


def _engine_axes(cards, axes):
    D, M = axes
    if D * M > len(cards):
        pytest.skip(f"a {D}x{M} mesh of distinct cards needs {D * M} cards")
    return make_mesh(D, M, devices=cards[:D * M])


class _Engine:
    """A started mesh engine and its queues."""

    def __init__(self, cfg, scfg, mesh, params=None):
        self.req_q, self.resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
        self.eng = engine.ComputeEngine(0, cfg, scfg, self.req_q, self.resp_q, ready_q,
                                        params=params, mesh=mesh)
        self.eng.start()
        ready = ready_q.get(timeout=600)
        assert not isinstance(ready, Exception), ready
        self.n = 0

    def send(self, idx, dense=None, mask=None):
        self.req_q.put(packets.ServiceRequest(
            batch_id=self.n, batch_size=len(idx), arrival_time=time.time(),
            payload=Batch(dense=dense, indices=np.asarray(idx, np.int32), mask=mask)))
        self.n += 1

    def answer(self):
        r = self.resp_q.get(timeout=120)
        assert r.error_code == 0, r.error_code
        return r.scores

    def stop(self):
        self.req_q.put(None)
        self.eng.join(timeout=120)
        assert not self.eng.is_alive() and self.eng.error is None


def _check_graphs(eng, reference) -> float:
    """Every program captured, a graph a card's part; each first replay at
    0.0 from the engine's own eager forward and within RTOL/ATOL of
    ``reference(key, warm rows)``; each part's capture tallied one launch a
    shard it pools. Returns the largest error against the reference."""
    plan = eng._plan
    assert eng.eager_reason is None and eng.graph_captures == len(eng.programs)
    assert set(eng.graph_pool_bytes_by_card) <= {d.index for d in eng.mesh.distinct_devices}
    assert eng.graph_pool_bytes == sum(eng.graph_pool_bytes_by_card.values()) > 0
    worst = 0.0
    for prog in eng.programs:
        assert len(prog.graphs) == len(plan), prog.key
        assert [d for d, _ in prog.stage_launches] == [p.device for p in plan]
        for part, (_, tally) in zip(plan, prog.stage_launches):
            pooled = len(part.shards) + sum(
                1 for d in part.rows for m in range(eng.mesh.shape["model"])
                if eng.mesh.device(d, m) == part.device)
            assert sum(n for w, n in tally.items() if w.__name__ in SHARD_WRAPPERS) == pooled, (
                prog.key, part, tally)
        assert prog.warm_err == 0.0, (prog.key, prog.warm_err)
        want = reference(prog.key, eng.warm_inputs(prog.key))
        np.testing.assert_allclose(prog.first_scores, want, rtol=RTOL, atol=ATOL)
        worst = max(worst, float(np.abs(prog.first_scores - want).max()))
    return worst


@pytest.mark.parametrize("axes", ENGINE_AXES, ids=lambda a: f"{a[0]}x{a[1]}")
@pytest.mark.parametrize("impl", ["xla", "hotcold"])
def test_mesh_engine_across_cards(cards, impl, axes):
    """An engine whose mesh spans distinct cards (a stream on each, an event
    on each an execution) captures every program as a graph a card's part,
    with no eager reason; each first replay is the engine's eager forward
    bit for bit and ``model.apply``'s scores; payload and ragged requests
    score as the single-device forward; the launches read around the run
    are the executions times the captures' tally; the hot/cold engine
    refreshes its hot set from the shards on their cards."""
    mesh = _engine_axes(cards, axes)
    D, M = axes
    cfg = zoo.get_config("rm1", table_scale=SCALE, embedding_impl=impl, hot_set_rows=64)
    base = cfg.replace(embedding_impl="xla")
    model = get_model(base, cards[0])
    params = model.init(torch.Generator(device=cards[0]).manual_seed(0))
    scfg = ServingConfig(engine_backend="gpu", batch_buckets=(8, 32), max_mini_batch_size=32,
                         accept_ragged=True, hotcold_refresh_interval=4 if impl == "hotcold"
                         else 0, hotcold_refresh_window=8)
    shard, k6 = ops.embedding_bag_shard, ops.embedding_bag_hotcold_shard
    before = shard.kernel_launches + k6.kernel_launches
    e = _Engine(cfg, scfg, mesh, params=params)
    eng = e.eng

    def reference(key, rows):
        with torch.inference_mode():
            if key[0] == "hotcold":
                split = {k: rows[k].to(cards[0]) for k in ("hot_sel", "hot_mask", "cold_local",
                                                          "cold_seg")}
                out = eng._hotcold.apply(eng.params, Batch(dense=rows["dense"].to(cards[0]),
                                                           indices=None), split)
            else:
                out = model.apply(params, Batch(dense=rows["dense"], indices=rows["indices"],
                                                mask=rows.get("mask")).to(cards[0]))
            return out.float().cpu().numpy()

    rng = np.random.default_rng(3)
    try:
        counted = shard.kernel_launches + k6.kernel_launches - before
        _check_graphs(eng, reference)
        during = shard.kernel_launches + k6.kernel_launches - before - counted
        for i in range(12):
            n_rows = 32 if i % 3 else 8
            idx = zipf_stream(cfg, n_rows, seed=50 + i) if impl == "hotcold" else \
                RecDataGenerator(cfg, seed=50 + i).generate_batch(n_rows).indices
            dense = rng.random((n_rows, cfg.dense_dim), dtype=np.float32)
            mask = rng.random(idx.shape) < 0.6 if i % 2 else None
            e.send(idx, dense, mask)
            got = e.answer()
            with torch.inference_mode():
                want = model.apply(params, Batch(dense=dense, indices=idx, mask=mask)
                                   .to(cards[0])).cpu().numpy()
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        if impl == "hotcold":
            assert eng.hot_refreshes >= 1
            hot = eng.params.entry(D - 1, M - 1)["hot_table"]
            assert hot.device == cards[D * M - 1]
            assert torch.equal(hot.to(cards[0]), params["tables"].index_select(
                0, torch.as_tensor(np.asarray(eng._hotcold.hot_ids), device=cards[0])))
    finally:
        e.stop()
    executions = sum(eng.bucket_counts.values()) + eng.warmup_executions
    # the references of the hot/cold programs ran the mesh lookup once a program
    assert (shard.kernel_launches + k6.kernel_launches - before - during
            == D * M * executions)


# The mesh lookups' kernel wrappers: a window (K1, K1-int8, K4) or K6 on a shard.
SHARD_WRAPPERS = ("embedding_bag_shard", "embedding_bag_int8_shard",
                  "embedding_bag_int8_rowwise_shard", "embedding_bag_hotcold_shard",
                  "embedding_bag_hotcold_int8_shard", "embedding_bag_hotcold_int8_rowwise_shard")


def _shard_launches() -> int:
    return sum(getattr(ops, w).kernel_launches for w in SHARD_WRAPPERS)


@pytest.mark.parametrize("name,quant,impl", [
    ("rm1", "int8", "xla"), ("rm1", "int8_rowwise", "xla"), ("rm1", "int8", "hotcold"),
    ("rm1", "int8_rowwise", "hotcold"), ("dien", "none", "xla")])
def test_mesh_engine_across_cards_layouts_and_dien(cards, name, quant, impl):
    """Per-table and row-wise int8 tables (K1-int8's and K4's windows;
    K6-int8 and K6-rowwise on a shard with a refreshing engine's direct
    windows beside them) and dien (K3 in each data row's tail, on that
    row's first card) over the largest mesh of distinct cards: a graph a
    card's part a program, each first replay the engine's eager forward bit
    for bit and within RTOL/ATOL of the reference; payloads score as
    ``model.apply``; the launches of a served run are its executions times
    the captures' tally (K3: one a data row)."""
    mesh = _engine_axes(cards, (2, 2) if len(cards) >= 4 else (1, 2))
    D, M = mesh.shape["data"], mesh.shape["model"]
    cfg = zoo.get_config(name, table_scale=SCALE, table_quant=quant, embedding_impl=impl,
                         hot_set_rows=64)
    model = get_model(cfg.replace(embedding_impl="xla"), cards[0])
    params = model.init(torch.Generator(device=cards[0]).manual_seed(0))
    k3 = ops.rnn_scan.kernel_launches  # dien's scans a forward, from one forward
    with torch.inference_mode():
        model.apply(params, RecDataGenerator(cfg, seed=3).generate_batch(8).to(cards[0]))
    k3 = ops.rnn_scan.kernel_launches - k3
    scfg = ServingConfig(engine_backend="gpu", batch_buckets=(8, 32), max_mini_batch_size=32,
                         accept_ragged=impl == "xla",
                         hotcold_refresh_interval=4 if impl == "hotcold" else 0,
                         hotcold_refresh_window=8)
    e = _Engine(cfg, scfg, mesh, params=params)
    eng = e.eng

    def reference(key, rows):
        with torch.inference_mode():
            if key[0] == "hotcold":
                split = {k: rows[k].to(cards[0]) for k in ("hot_sel", "hot_mask", "cold_local",
                                                          "cold_seg")}
                out = eng._hotcold.apply(eng.params, Batch(dense=rows["dense"].to(cards[0]),
                                                           indices=None), split)
            else:
                out = model.apply(params, Batch(dense=rows.get("dense"), indices=rows["indices"],
                                                mask=rows.get("mask")).to(cards[0]))
            return out.float().cpu().numpy()

    rng = np.random.default_rng(7)
    try:
        _check_graphs(eng, reference)
        for prog in eng.programs:
            for part, (_, tally) in zip(eng._plan, prog.stage_launches):
                scans = sum(n for w, n in tally.items() if w.__name__ == "rnn_scan")
                assert scans == k3 * len(part.rows), (prog.key, tally)
        shard0, k3_0 = _shard_launches(), ops.rnn_scan.kernel_launches
        served0 = sum(eng.bucket_counts.values())
        for i in range(10):
            n_rows = 32 if i % 3 else 8
            idx = zipf_stream(cfg, n_rows, seed=70 + i) if impl == "hotcold" else \
                RecDataGenerator(cfg, seed=70 + i).generate_batch(n_rows).indices
            dense = (rng.random((n_rows, cfg.dense_dim), dtype=np.float32)
                     if cfg.dense_dim else None)
            mask = rng.random(idx.shape) < 0.6 if impl == "xla" and i % 2 else None
            e.send(idx, dense, mask)
            got = e.answer()
            with torch.inference_mode():
                want = model.apply(params, Batch(dense=dense, indices=idx, mask=mask)
                                   .to(cards[0])).float().cpu().numpy()
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    finally:
        e.stop()
    served = sum(eng.bucket_counts.values()) - served0
    assert served == 10
    assert _shard_launches() - shard0 == D * M * served
    # each data row's tail, and each payload's reference
    assert ops.rnn_scan.kernel_launches - k3_0 == k3 * (D + 1) * served
    if impl == "hotcold":
        assert eng.hot_refreshes >= 1


@pytest.mark.parametrize("axes", ENGINE_AXES, ids=lambda a: f"{a[0]}x{a[1]}")
def test_mesh_refresh_across_cards_writes_every_cards_hot_table_in_place(cards, axes):
    """A same-size refresh gathers the new hot rows from the shards and
    writes them into the hot table the graphs read on every card, the same
    tensors; the programs are not rebuilt and the next scores are the
    direct model's."""
    mesh = _engine_axes(cards, axes)
    cfg = zoo.get_config("ncf", table_scale=500).replace(embedding_impl="hotcold",
                                                          hot_set_rows=64)
    scfg = ServingConfig(engine_backend="gpu", batch_buckets=(8,), max_mini_batch_size=8,
                         hotcold_refresh_window=8, hotcold_scan_async=False,
                         hotcold_refresh_interval=4, hotcold_refresh_margin=0.05)
    e = _Engine(cfg, scfg, mesh)
    eng = e.eng
    tables = {dev: eng.params.entry(*_entry_on(mesh, dev))["hot_table"]
              for dev in mesh.distinct_devices}
    progs, captures = eng.programs, eng.graph_captures
    hot = set(int(i) for i in eng._hotcold.hot_ids)
    pools = [[i for i in range(r) if int(off) + i not in hot][:6]
             for off, r in zip(cfg.table_offsets, cfg.scaled_rows)]
    rng = np.random.default_rng(0)

    def batch():
        return np.stack([rng.choice(p, size=(8, 1)) for p in pools], axis=1).astype(np.int32)
    try:
        for _ in range(8):
            e.send(batch())
            e.answer()
            if eng.hot_refreshes:
                break
        assert eng.hot_refreshes == 1 and eng._hotcold_active
        idx = batch()
        e.send(idx)
        got = e.answer()
    finally:
        e.stop()
    assert eng.programs is progs and eng.graph_captures == captures
    want_rows = sharding.gather_rows(eng.params, eng._hotcold.hot_ids)
    for dev, table in tables.items():
        assert table.device == dev
        assert eng.params.entry(*_entry_on(mesh, dev))["hot_table"] is table
        assert torch.equal(table.to(cards[0]), want_rows)
    D, M = axes
    full = {k: v for k, v in eng.params.entry(0, 0).items() if k != "hot_table"}
    full["tables"] = torch.cat([eng.params.entry(0, m)["tables"].to(cards[0])
                                for m in range(M)])
    with torch.inference_mode():
        want = eng.model.apply(full, Batch(dense=None, indices=idx).to(cards[0]))
    np.testing.assert_allclose(got, want.float().cpu().numpy(), rtol=RTOL, atol=ATOL)


def _entry_on(mesh, dev) -> tuple:
    return next((d, m) for d in range(mesh.shape["data"]) for m in range(mesh.shape["model"])
                if mesh.device(d, m) == dev)


def test_mesh_reload_across_cards_under_queued_replays(cards, tmp_path):
    """A reload while replays are queued on every card's stream: requests
    sent after it was scheduled get the new checkpoint's scores, the
    programs are captured again (a graph a card), the caller's params are
    not written."""
    from deeprecsys_tpu_torch import bridge
    from deeprecsys_tpu_torch.utils.checkpoint import save_params

    mesh = _engine_axes(cards, (2, 2) if len(cards) >= 4 else (1, 2))
    cfg = zoo.get_config("rm1", table_scale=SCALE)
    model = get_model(cfg, cards[0])
    old, new = bridge.init_numpy(cfg, 1), bridge.init_numpy(cfg, 2)
    save_params(str(tmp_path / "ckpt"), new)
    caller = bridge.params_from_numpy(old, cfg, cards[0])
    leaves = [caller["tables"]] + [t for layer in caller["bot"] + caller["top"]
                                   for t in layer.values()]
    before = [(t.clone(), t._version) for t in leaves]
    new_params = bridge.params_from_numpy(new, cfg, cards[0])
    scfg = ServingConfig(engine_backend="gpu", batch_buckets=(32,), max_mini_batch_size=32)
    e = _Engine(cfg, scfg, mesh, params=caller)
    first = e.eng.programs
    batches = [(RecDataGenerator(cfg, seed=10 + i).generate_batch(32)) for i in range(24)]
    try:
        for b in batches[:16]:
            e.send(b.indices, b.dense)
        handle = e.eng.request_reload(str(tmp_path / "ckpt"))
        for b in batches[16:]:
            e.send(b.indices, b.dense)
        got = [e.answer() for _ in batches]
        assert handle.event.wait(timeout=60) and handle.error is None
    finally:
        e.stop()
    eng = e.eng
    assert eng.programs is not first and eng.last_reload_ms > 0
    assert eng.graph_captures == 2 * len(eng.programs)
    assert all(len(p.graphs) == len(eng._plan) and p.warm_err == 0.0 for p in eng.programs)
    for i, (b, scores) in enumerate(zip(batches, got)):
        with torch.inference_mode():
            want_new = model.apply(new_params, b.to(cards[0])).cpu().numpy()
            want_old = model.apply(caller, b.to(cards[0])).cpu().numpy()
        if i >= 16:  # sent after the reload was scheduled
            np.testing.assert_allclose(scores, want_new, rtol=RTOL, atol=ATOL)
        else:
            assert (np.allclose(scores, want_old, rtol=RTOL, atol=ATOL)
                    or np.allclose(scores, want_new, rtol=RTOL, atol=ATOL)), i
    for t, (value, version) in zip(leaves, before):
        assert t._version == version and torch.equal(t, value)


@pytest.mark.parametrize("impl", ["xla", "hotcold"])
def test_mesh_across_cards_replay_makes_no_host_sync(cards, impl):
    """A replayed execution over every card (the rows copied into each
    card's inputs, a graph a card, the partials and slices copied between
    them) makes no host synchronization."""
    mesh = _engine_axes(cards, (2, 2) if len(cards) >= 4 else (1, 2))
    cfg = zoo.get_config("rm1", table_scale=SCALE, embedding_impl=impl, hot_set_rows=256)
    scfg = ServingConfig(engine_backend="gpu", batch_buckets=(8, 32), max_mini_batch_size=32)
    e = _Engine(cfg, scfg, mesh)
    runs = sum(p.runs for p in e.eng.programs)
    b = RecDataGenerator(cfg, seed=5).generate_batch(20)
    try:
        torch.cuda.set_sync_debug_mode("error")
        try:
            e.send(b.indices, b.dense)
            scores = e.answer()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    finally:
        e.stop()
    assert scores.shape == (20, 1) and np.isfinite(scores).all()
    assert sum(p.runs for p in e.eng.programs) == runs + 1


# The graphed step against the eager step on the same cards: chip_smoke.py's
# GRAPH_* limits (tests/test_torch_train.py's between the port and JAX):
# losses rtol 1e-5; params rtol 1e-5, atol 1e-6, a sparse table's atol 1e-3
# of the steps' reach (lr x steps); row accumulators 1e-4 of the largest.
GRAPH_STEPS = 4
GRAPH_LOSS_RTOL, GRAPH_PARAM_RTOL, GRAPH_PARAM_ATOL = 1e-5, 1e-5, 1e-6
GRAPH_SPARSE_REACH, GRAPH_ACC_RTOL = 1e-3, 1e-4


@pytest.mark.parametrize("sparse", [False, True])
def test_mesh_training_step_across_cards(cards, sparse, monkeypatch):
    """The trainer over distinct cards replays a graph a part of its step:
    its first step (the parts run eagerly) against the single-device step,
    then four steps against the step function called eagerly on the same
    cards, within the GRAPH_* limits; one K1b window launch a (d, m) a
    dense step, one K5 window launch a shard on copy (0, m) a sparse one."""
    from deeprecsys_tpu_torch.ops import embedding_bag_backward_shard, sparse_adagrad_step_shard

    n = len(cards)
    D, M = (2, n // 2) if n >= 4 else (1, n)
    cfg, model, start = _model(cards[0])
    lr, tlr = 0.05, 0.01
    kw = dict(optimizer="adagrad", learning_rate=lr, sparse_tables=sparse,
              table_learning_rate=tlr, params=start)
    single = train.Trainer(cfg, device=cards[0], **kw)
    tr = train.Trainer(cfg, mesh=make_mesh(D, M, devices=cards[:D * M]), **kw)
    ev = train.Trainer(cfg, mesh=make_mesh(D, M, devices=cards[:D * M]), **kw)
    # a trainer over several cards takes a graph a part of its step
    assert tr.eager_reason is None and tr.step_program.cut is not None
    hosts = [RecDataGenerator(cfg, seed=1 + i).generate_batch(64) for i in range(GRAPH_STEPS)]
    labels = [single._labels(h, None) for h in hosts]
    k5_calls = []

    def k5_recorded(*args):
        k5_calls.append(args)
        return sparse_adagrad_step_shard(*args)

    monkeypatch.setattr(train, "sparse_adagrad_step_shard", k5_recorded)
    k1b, k5 = embedding_bag_backward_shard.kernel_launches, sparse_adagrad_step_shard.kernel_launches
    want = float(single.step(hosts[0], labels[0]))
    got = float(tr.step(hosts[0], labels[0]))
    torch.cuda.synchronize()
    assert got == pytest.approx(want, rel=1e-5)
    if sparse:
        assert sparse_adagrad_step_shard.kernel_launches - k5 == M  # one a shard, on copy (0, m)
    else:
        assert embedding_bag_backward_shard.kernel_launches - k1b == D * M
    # Each data row's copy of the table (and of the accumulator) against the
    # single-device step, within the JAX tests' limits.
    for d in range(D):
        table = torch.cat([tr.params.entry(d, m)["tables"].cpu() for m in range(M)])
        np.testing.assert_allclose(table.numpy(), single.params["tables"].cpu().numpy(),
                                   rtol=1e-4, atol=1e-6)
        if sparse:
            acc = torch.cat([tr.opt_state[1].part(d, m).cpu() for m in range(M)])
            np.testing.assert_allclose(acc.numpy(), single.opt_state[1].cpu().numpy(),
                                       rtol=1e-4, atol=1e-7)
    # Graphed against eager on the same cards over GRAPH_STEPS steps.
    losses = [got] + [float(tr.step(h, lab)) for h, lab in zip(hosts[1:], labels[1:])]
    eager = [float(ev._step(ev.params, ev.opt_state, h.to(cards[0]), ev._targets(lab)))
             for h, lab in zip(hosts, labels)]
    np.testing.assert_allclose(losses, eager, rtol=GRAPH_LOSS_RTOL)
    (prog,) = tr.step_program.programs.values()
    assert prog.runs == GRAPH_STEPS and len(prog.graphs) == len(prog.stages) > 1
    reach = GRAPH_STEPS * (tlr if sparse else lr)
    for ((path, _), xs), (_, ys) in zip(sharding.leaf_groups(tr.params),
                                        sharding.leaf_groups(ev.params)):
        atol = GRAPH_SPARSE_REACH * reach if sparse and path == "tables" else GRAPH_PARAM_ATOL
        for x, y in zip(xs, ys):
            np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(), rtol=GRAPH_PARAM_RTOL,
                                       atol=atol, err_msg=path)
    if sparse:
        for m in range(M):
            a, b = tr.opt_state[1].part(0, m).cpu(), ev.opt_state[1].part(0, m).cpu()
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=GRAPH_ACC_RTOL * b.max().item())
    np.testing.assert_array_equal(tr.full_params()["tables"].numpy(),
                                  torch.cat([tr.params.entry(0, m)["tables"].cpu()
                                             for m in range(M)]).numpy())
    # Every copy takes the same gradient and the same update (K10 is
    # deterministic), and in sparse mode each table shard is updated once,
    # on copy (0, m), whose touched rows are copied into the others: every
    # data row's copy of the table and the accumulator equals copy 0 bit for
    # bit, as JAX's one array a shard.
    for copies in sharding.leaf_copies(tr.params):
        for c in copies[1:]:
            assert torch.equal(c.cpu(), copies[0].cpu())
    for m in range(M) if sparse else ():
        assert any(a[0] is tr.params.entry(0, m)["tables"] for a in k5_calls)
        acc0 = tr.opt_state[1].part(0, m).cpu()
        for d in range(1, D):
            assert torch.equal(tr.opt_state[1].part(d, m).cpu(), acc0)


@pytest.mark.parametrize("sparse", [False, True])
def test_mesh_training_across_cards_replay_makes_no_host_sync(cards, sparse):
    """A replayed step over every card (the batch copied into each card's
    inputs, a graph a part of the step, the partials, gradients and rows
    copied between them) makes no host synchronization."""
    mesh = _engine_axes(cards, (2, 2) if len(cards) >= 4 else (1, 2))
    cfg, model, start = _model(cards[0])
    tr = train.Trainer(cfg, mesh=mesh, optimizer="adagrad", learning_rate=0.05,
                       sparse_tables=sparse, table_learning_rate=0.01, params=start)
    host = RecDataGenerator(cfg, seed=2).generate_batch(64)
    labels = tr._labels(host, None)
    tr.step(host, labels)  # the parts run eagerly, then captured
    (prog,) = tr.step_program.programs.values()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = tr.step(host, labels)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert prog.runs == 2 and len(prog.graphs) == len(prog.stages) > 1
    assert np.isfinite(float(loss))


def _two_process_run(first: torch.device, mesh) -> dict:
    """rm1's forward on a 64-row batch, the hot/cold tensor-parallel model on
    64 rows of zipf(1.2) ids, the table-wise model on the batch and one
    sparse adagrad step on the batch over ``mesh``, from the seed's params
    made on ``first``."""
    cfg, model, params = _model(first)
    batch = RecDataGenerator(cfg, seed=1).generate_batch(64)
    scores = sharded_apply(model, mesh, has_dense=True)(shard_params(params, mesh), batch)
    idx = zipf_stream(cfg, 64, seed=5)
    dense = np.random.default_rng(5).random((64, cfg.dense_dim), dtype=np.float32)
    hc = make_hotcold_model(model, hot_ids_from_generator(cfg, seed=5, hot_rows=256,
                                                          n_batches=2, batch_size=64), mesh=mesh)
    hotcold = hc.apply(shard_params(hc.convert_params(params), mesh),
                       Batch(dense=torch.from_numpy(dense), indices=None),
                       hc.prepare(Batch(dense=dense, indices=idx)))
    tw = make_tablewise_model(model, mesh)
    tablewise = tw.apply(tw.convert_params(params), batch)
    tr = train.Trainer(cfg, mesh=mesh, optimizer="adagrad", learning_rate=0.05,
                       sparse_tables=True, table_learning_rate=0.01, params=params)
    loss = float(tr.step(batch, tr._labels(batch, None)))
    return {"scores": scores.cpu().numpy(), "hotcold": hotcold.cpu().numpy(),
            "tablewise": tablewise.cpu().numpy(), "loss": loss,
            "table": unshard_params(tr.params)["tables"].numpy(),
            "start": float(params["tables"].double().sum())}


def _nccl_worker(rank: int, port: int, q):
    """One of two processes, each with two cards (2 * rank, 2 * rank + 1)."""
    import torch.distributed as dist

    try:
        cards = [torch.device("cuda", 2 * rank), torch.device("cuda", 2 * rank + 1)]
        torch.cuda.set_device(cards[0])
        distributed_init(f"127.0.0.1:{port}", num_processes=2, process_id=rank, backend="nccl")
        mesh = make_mesh(1, 4, devices=cards)
        q.put((rank, "ok", {"ranks": mesh.ranks.tolist(),
                            **_two_process_run(cards[0], mesh)}))
    except Exception:  # surfaced by the test
        q.put((rank, "error", traceback.format_exc()[-3000:]))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_two_processes_of_two_cards_over_nccl(cards):
    """The 1x4 mesh over two processes (nccl): the forward within rtol
    2e-4, atol 2e-5 of the single-device forward, the hot/cold
    tensor-parallel (the row sum crosses the processes) and table-wise (the
    row's cells cross) models within the same limits of the single-process
    1x4 mesh's, one sparse step as the single-process 1x4 mesh's."""
    if len(cards) < 4:
        pytest.skip("needs four CUDA cards: two processes of two")
    want = _two_process_run(cards[0], make_mesh(1, 4, devices=cards[:4]))
    cfg, model, params = _model(cards[0])
    single = model.apply(params, RecDataGenerator(cfg, seed=1).generate_batch(64)
                         .to(cards[0])).cpu().numpy()
    del params
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_nccl_worker, args=(r, port, q)) for r in range(2)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in procs:
            rank, status, detail = q.get(timeout=600)
            assert status == "ok", (rank, detail)
            results[rank] = detail
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.terminate()
    for rank, got in sorted(results.items()):
        assert got["ranks"] == [[0, 0, 1, 1]]
        assert got["start"] == want["start"], rank  # the same seeded params
        np.testing.assert_allclose(got["scores"], single, rtol=RTOL, atol=ATOL)
        for path in ("hotcold", "tablewise"):
            np.testing.assert_allclose(got[path], want[path], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{path} on process {rank}")
        assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
        np.testing.assert_allclose(got["table"], want["table"], rtol=1e-4, atol=1e-6)


NCCL_WAIT_S = 300
GRAPH_STEPS = 4


def _one_card_steps(mesh, card: torch.device, sparse: bool) -> dict:
    """rm1 (f32, adagrad) on ``mesh`` from the seed's params made on
    ``card``, GRAPH_STEPS steps of 32 rows, in two arms: the trainer's
    programs and its step function called eagerly. Returns both arms'
    losses and full params (host), the graphed trainer's eager reason as
    built, and the programs' captures and graphs. Across processes the
    trainer is built eager (``NCCL_SLOWER``) and takes its programs
    (``take_programs``)."""
    cfg, model, params = _model(card)
    kw = dict(optimizer="adagrad", learning_rate=0.01, sparse_tables=sparse, params=params)
    graphed, eager = (train.Trainer(cfg, mesh=mesh, **kw) for _ in range(2))
    reason = graphed.eager_reason
    if mesh.multi_process:
        graphed.take_programs()
    gen = RecDataGenerator(cfg, seed=1)
    got, want = [], []
    for _ in range(GRAPH_STEPS):
        host = gen.generate_batch(32)
        labels = graphed._labels(host, None)
        got.append(float(graphed.step(host, labels)))
        want.append(float(eager._step(eager.params, eager.opt_state, host.to(card),
                                      eager._targets(labels))))
    progs = graphed.step_program
    return {"graphed": got, "eager": want, "reason": reason,
            "captures": None if progs is None else progs.captures,
            "graphs": None if progs is None else [p.graph is not None
                                                  for p in progs.programs.values()],
            "params": _flat(graphed.params), "eager_params": _flat(eager.params)}


def _flat(sp) -> dict:
    """A mesh trainer's full params as host arrays by leaf path."""
    return {k: v.numpy() for k, v in bridge.flatten(unshard_params(sp)).items()}


def _nccl_one_card_worker(rank: int, port: int, q):
    """One of two processes, each with card ``rank``: the 1x2 mesh's dense
    and sparse trainers (``_one_card_steps``)."""
    import torch.distributed as dist

    try:
        card = torch.device("cuda", rank)
        torch.cuda.set_device(card)
        distributed_init(f"127.0.0.1:{port}", num_processes=2, process_id=rank, backend="nccl")
        mesh = make_mesh(1, 2, devices=[card])
        q.put((rank, "ok", {mode: _one_card_steps(mesh, card, mode == "sparse")
                            for mode in ("dense", "sparse")}))
    except Exception:  # surfaced by the test
        q.put((rank, "error", traceback.format_exc()[-3000:]))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _assert_graph_limits(got: dict, want: dict, sparse: bool, who: str):
    """``chip_smoke.py``'s GRAPH_* limits over GRAPH_STEPS adagrad steps."""
    reach = GRAPH_STEPS * 0.01
    for key, w in want.items():
        atol = 1e-3 * reach if sparse and key == "tables" else 1e-6
        np.testing.assert_allclose(got[key], w, rtol=1e-5, atol=atol, err_msg=f"{who} {key}")


def test_processes_of_one_card_over_nccl_replay_their_steps(cards):
    """Two processes, one card each, over nccl: each dense and sparse
    trainer is built eager for the replays' measured slowdown
    (``NCCL_SLOWER``), then takes its programs (``take_programs``: one
    graph a process, its collectives inside) and replays them; graphed
    against eager in each process and against one process's 1x2 mesh over
    the same cards (a graph a part)."""
    want = {mode: _one_card_steps(make_mesh(1, 2, devices=cards[:2]), cards[0],
                                  mode == "sparse") for mode in ("dense", "sparse")}
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_nccl_one_card_worker, args=(r, port, q)) for r in range(2)]
    for p in procs:
        p.start()
    results = {}
    try:
        for _ in procs:
            rank, status, detail = q.get(timeout=NCCL_WAIT_S)
            assert status == "ok", (rank, detail)
            results[rank] = detail
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert sorted(results) == [0, 1]
    for rank, res in sorted(results.items()):
        for mode, got in res.items():
            who, sparse = f"{mode} on process {rank}", mode == "sparse"
            assert got["reason"] == NCCL_SLOWER, who
            assert got["captures"] == 1 and got["graphs"] == [True], who
            np.testing.assert_allclose(got["graphed"], got["eager"], rtol=1e-5, err_msg=who)
            np.testing.assert_allclose(got["graphed"], want[mode]["graphed"], rtol=1e-5,
                                       err_msg=who)
            _assert_graph_limits(got["params"], got["eager_params"], sparse, who)
            _assert_graph_limits(got["params"], want[mode]["params"], sparse, who)
