"""The mesh engines' serve-time programs (``serving/programs.py``) on the CPU,
against the JAX package's mesh engine.

A ``ComputeEngine(mesh=)`` serves every execution through one program a
bucket (a masked twin, a mesh cold rung): on one card's virtual shards a
CUDA graph replayed over static inputs, here the same program's eager
forward over the same static buffers, so these tests reach the copy-in of
the rows and of the mesh split, the slicing and the copy-out that a card
replays. The port runs on ``make_mesh(D, M, devices=["cpu"] * (D * M))``,
the JAX package on its 8 virtual CPU devices (``tests/conftest.py``); the
same seeded requests go through both engines on the same weights
(``bridge.init_numpy``), tables cut by ``table_scale=2000`` (``ncf`` at 500
for the refresh, as ``tests/test_torch_parallel.py``).

Tolerances: scores rtol and atol 1e-5 (f32, the same sums in another order:
the shards' partials added in shard order against XLA's ``psum``; measured
6e-8); launch counts, keys, hot sets and the refreshed hot table exact. The
card's own checks (replay against the eager mesh forward, a reload under
queued replays, sync-free replays) are in
``tests/test_torch_mesh_engine_graphs_gpu.py``.
"""

import queue
import threading
import time

import jax
import numpy as np
import pytest
import torch

from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu.config import ServingConfig as JaxServingConfig
from deeprecsys_tpu.models import get_model as jax_get_model
from deeprecsys_tpu.models.base import Batch as JaxBatch
from deeprecsys_tpu.parallel import make_mesh as jax_make_mesh
from deeprecsys_tpu.serving import engine as jax_engine
from deeprecsys_tpu.serving import packets as jax_packets
from deeprecsys_tpu_torch import ServingConfig, bridge, ops, zoo
from deeprecsys_tpu_torch.models.base import Batch
from deeprecsys_tpu_torch.models.hotcold import cold_buckets_for
from deeprecsys_tpu_torch.parallel import make_mesh, sharding
from deeprecsys_tpu_torch.serving import engine, packets, programs

SCALE = 2000
RTOL = ATOL = 1e-5
MESHES = [(2, 4), (1, 8)]


def _meshes(D: int, M: int):
    """The port's mesh of one device and the JAX package's of its virtual ones."""
    return (make_mesh(D, M, devices=["cpu"] * (D * M)),
            jax_make_mesh(data=D, model=M, devices=jax.devices()[:D * M]))


def _rows(cfg, n: int, seed: int, masked: bool = False, hot=None):
    """Seeded payload rows; with ``hot`` (fused ids) every id drawn from it."""
    rng = np.random.default_rng(seed)
    T, L = cfg.num_tables, cfg.num_indices_per_lookup
    if hot is None:
        rows = np.asarray(cfg.scaled_rows, dtype=np.int64)
        idx = rng.integers(0, rows[None, :, None], size=(n, T, L))
    else:
        offsets = np.asarray(cfg.table_offsets, dtype=np.int64)
        idx = np.empty((n, T, L), np.int64)
        for t in range(T):
            own = hot[(hot >= offsets[t]) & (hot < offsets[t] + cfg.scaled_rows[t])] - offsets[t]
            idx[:, t] = (rng.choice(own, size=(n, L)) if own.size
                         else rng.integers(0, cfg.scaled_rows[t], size=(n, L)))
    dense = rng.random((n, cfg.dense_dim), dtype=np.float32) if cfg.dense_dim else None
    mask = (rng.random((n, T, L)) < 0.6) if masked else None
    return dense, idx.astype(np.int32), mask


def _serve(cls, cfg, scfg, payloads, **kw):
    """One engine answering ``payloads`` (queued before it starts), by batch_id."""
    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    port = cls is engine.ComputeEngine
    batch = Batch if port else JaxBatch
    request = packets.ServiceRequest if port else jax_packets.ServiceRequest
    for i, (dense, idx, mask) in enumerate(payloads):
        req_q.put(request(batch_id=i, batch_size=len(idx), arrival_time=1.0,
                          payload=batch(dense=dense, indices=idx, mask=mask)))
    eng = cls(0, cfg, scfg, req_q, resp_q, ready_q, **kw)
    eng.start()
    ready = ready_q.get(timeout=300)
    assert not isinstance(ready, Exception), ready
    req_q.put(None)
    got = {}
    for _ in payloads:
        r = resp_q.get(timeout=120)
        got[r.batch_id] = r
    eng.join(timeout=120)
    assert not eng.is_alive() and eng.error is None
    return eng, got


def _port_and_jax(name, quant, impl, axes, scfg_kw, payloads_of, **cfg_kw):
    """The port's and the JAX package's mesh engines on the same weights and
    requests: ``((engine, responses), (engine, responses))``."""
    port_cfg = zoo.get_config(name, table_scale=SCALE, table_quant=quant, embedding_impl=impl,
                              **cfg_kw)
    jax_cfg = jax_zoo.get_config(name, table_scale=SCALE, table_quant=quant,
                                 embedding_impl=impl, **cfg_kw)
    base = port_cfg.replace(embedding_impl="xla")
    np_params = bridge.init_numpy(base, 5)
    payloads = payloads_of(port_cfg)
    mesh, jax_mesh = _meshes(*axes)
    port = _serve(engine.ComputeEngine, port_cfg, ServingConfig(**scfg_kw), payloads,
                  params=bridge.params_from_numpy(np_params, base, "cpu"), mesh=mesh)
    want = _serve(jax_engine.ComputeEngine, jax_cfg, JaxServingConfig(**scfg_kw), payloads,
                  params=np_params, mesh=jax_mesh)
    return port, want


def _assert_same_scores(got: dict, want: dict):
    for i in want:
        assert got[i].error_code == want[i].error_code == 0
        assert got[i].out_batch_size == want[i].out_batch_size
        np.testing.assert_allclose(got[i].scores, want[i].scores, rtol=RTOL, atol=ATOL)


CASES = {
    # 5 and 3 rows padded to bucket 8, 12 to bucket 16
    "padded": ("rm1", "none", {"batch_buckets": (8, 16)},
               lambda cfg: [_rows(cfg, 5, 1), _rows(cfg, 12, 2), _rows(cfg, 3, 3)]),
    "ragged": ("rm1", "none", {"batch_buckets": (8,), "accept_ragged": True},
               lambda cfg: [_rows(cfg, 6, 4, masked=True), _rows(cfg, 8, 5)]),
    "int8": ("rm1", "int8", {"batch_buckets": (8,)}, lambda cfg: [_rows(cfg, 7, 6)]),
    "int8_rowwise": ("rm1", "int8_rowwise", {"batch_buckets": (8,)},
                     lambda cfg: [_rows(cfg, 8, 7)]),
}


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: f"{a[0]}x{a[1]}")
@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_program_scores_equal_jax(case, axes):
    """Each execution runs the program of its bucket (the masked twin for a
    ragged request, the int8 layouts' window lookups) and answers the JAX
    mesh engine's scores for the same rows; every program was built at
    set-up, one warm-up execution a program, and no card, no eager reason."""
    name, quant, kw, payloads_of = CASES[case]
    scfg = dict(engine_backend="cpu", max_mini_batch_size=max(kw["batch_buckets"]), **kw)
    (port, got), (jx, want) = _port_and_jax(name, quant, "xla", axes, scfg, payloads_of)
    _assert_same_scores(got, want)
    assert port.bucket_counts == jx.bucket_counts
    keys = [("direct", b) for b in kw["batch_buckets"]]
    if kw.get("accept_ragged"):
        keys = [k for b in kw["batch_buckets"] for k in (("direct", b), ("masked", b))]
    assert list(port.programs.programs) == keys
    assert port.warmup_executions == len(keys) == port.programs.executions
    assert port.eager_reason is None
    assert port.graph_captures == 0 and port.graph_pool_bytes is None  # no card here
    runs = {k: p.runs for k, p in port.programs.programs.items()}
    assert sum(runs.values()) == sum(port.bucket_counts.values())
    if case == "ragged":
        assert runs == {("direct", 8): 1, ("masked", 8): 1}


def _one_cell(cfg, n: int, seed: int, hot: np.ndarray):
    """``n`` rows of ncf whose tables 0 and 1 draw cold ids of fused rows
    63-83 (what shard 3 of a 1x8 mesh and shard 1 of a 2x4 mesh own), the
    other tables any cold id (a hit where a table is all hot): one cell's
    cold stream past the smallest rung."""
    rng = np.random.default_rng(seed)
    hot = set(int(i) for i in hot)
    idx = np.empty((n, cfg.num_tables, 1), np.int32)
    for t, (off, rows) in enumerate(zip(cfg.table_offsets, cfg.scaled_rows)):
        lo, hi = {0: (63, 70), 1: (0, 14)}.get(t, (0, rows))
        cold = [i for i in range(lo, hi) if int(off) + i not in hot] or list(range(lo, hi))
        idx[:, t, 0] = rng.choice(cold, size=n)
    return None, idx, None


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: f"{a[0]}x{a[1]}")
def test_mesh_hotcold_programs_at_two_cold_rungs_equal_jax(axes):
    """A hot/cold mesh engine (tensor-parallel on 1x8, hybrid on 2x4): a
    request of hot ids takes the smallest mesh cold rung and one whose cold
    lookups crowd one cell the top rung; both programs answer the JAX mesh
    engine's scores, and every rung was warmed on real rows (the mesh split
    of the bucket's rows, each cell's stream cut or padded to the rung;
    scores finite)."""
    D, M = axes
    hot = {}

    def payloads_of(cfg):
        from deeprecsys_tpu_torch.models.hotcold import hot_ids_from_generator

        # The engine's hot set: the JAX engine's rule on the same stream.
        hot["ids"] = hot_ids_from_generator(cfg, seed=31, hot_rows=64)
        return [_rows(cfg, 16, 8, hot=hot["ids"]), _one_cell(cfg, 16, 9, hot["ids"])]

    scfg = dict(engine_backend="cpu", batch_buckets=(16,), max_mini_batch_size=16)
    (port, got), (jx, want) = _port_and_jax("ncf", "none", "hotcold", axes, scfg, payloads_of,
                                            hot_set_rows=64)
    np.testing.assert_array_equal(port._hotcold.hot_ids, hot["ids"])
    np.testing.assert_array_equal(port._hotcold.hot_ids, jx._hotcold.hot_ids)
    _assert_same_scores(got, want)
    cfg = port.model_cfg
    rungs = cold_buckets_for(16 * cfg.num_tables * cfg.num_indices_per_lookup, port.mesh)
    assert len(rungs) == 2
    assert list(port.programs.programs) == [("hotcold", 16, c) for c in rungs]
    runs = {k[2]: p.runs for k, p in port.programs.programs.items()}
    assert port.warmup_executions == len(rungs) and runs == {c: 1 for c in rungs}
    cold = port._static.split["cold_local"]
    assert cold.numel() == port.mesh.size * max(rungs)  # a stream a cell at the top rung
    for p in port.programs:
        shape = (M, p.key[2]) if D == 1 else (D, M, p.key[2])
        assert tuple(p.inputs["cold_local"].shape) == shape
        assert p.inputs["cold_local"].data_ptr() == cold.data_ptr()
        assert p.first_scores.shape == (16, cfg.out_dim) and np.isfinite(p.first_scores).all()


def test_mesh_reload_rebuilds_programs_and_leaves_callers_params(tmp_path):
    """On a 2x4 mesh: a request sent after a reload was scheduled gets the
    new checkpoint's scores (the JAX model's on it); the programs are built
    again against the new, sharded params, and the caller's ``params=``
    tensors (whose shards the first programs read as views) keep their
    values and versions."""
    from deeprecsys_tpu_torch.utils.checkpoint import save_params

    cfg = zoo.get_config("rm1", table_scale=SCALE)
    jax_cfg = jax_zoo.get_config("rm1", table_scale=SCALE)
    old, new = bridge.init_numpy(cfg, 1), bridge.init_numpy(cfg, 2)
    path = str(tmp_path / "ckpt.new")
    save_params(path, new)
    caller = bridge.params_from_numpy(old, cfg, "cpu")
    leaves = list(_leaves(caller))
    before = [(t.clone(), t._version) for t in leaves]
    dense, idx, _ = _rows(cfg, 8, 3)
    scfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,), max_mini_batch_size=8)
    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    eng = engine.ComputeEngine(0, cfg, scfg, req_q, resp_q, ready_q, params=caller,
                               mesh=_meshes(2, 4)[0])
    eng.start()
    assert not isinstance(ready_q.get(timeout=300), Exception)
    first, first_params = eng.programs, eng.params
    got = []
    try:
        for i in range(2):
            if i == 1:
                h = eng.request_reload(path)
            req_q.put(packets.ServiceRequest(batch_id=i, batch_size=8, arrival_time=time.time(),
                                             payload=Batch(dense=dense, indices=idx)))
            got.append(resp_q.get(timeout=120))
        assert h.event.wait(timeout=60) and h.error is None and eng.last_reload_ms > 0
    finally:
        req_q.put(None)
        eng.join(timeout=120)
    assert eng.error is None and eng.programs is not first and eng.params is not first_params
    assert isinstance(eng.params, sharding.ShardedParams)
    assert eng.params.rows_per_shard == cfg.total_rows // 4
    assert eng.warmup_executions == 2  # one program, built twice
    model = jax_get_model(jax_cfg)
    for r, weights in zip(got, (old, new)):
        want = np.asarray(model.apply(jax.tree_util.tree_map(jax.numpy.asarray, weights),
                                      JaxBatch(dense=dense, indices=idx)), np.float32)
        assert r.error_code == 0
        np.testing.assert_allclose(r.scores, want, rtol=RTOL, atol=ATOL)
    for t, (value, version) in zip(leaves, before):
        assert t._version == version and torch.equal(t, value)


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: f"{a[0]}x{a[1]}")
def test_mesh_refresh_writes_new_hot_rows_into_the_programs_table(axes):
    """A same-size refresh on a mesh engine writes the hot rows, gathered
    from the shards that own them, into the hot table its programs were
    built on (one tensor on the one device, no rebuild); the next request
    scores the JAX model's values on the same weights, which a program
    reading the old rows would miss."""
    cfg = zoo.get_config("ncf", table_scale=500).replace(embedding_impl="hotcold",
                                                          hot_set_rows=64)
    base = cfg.replace(embedding_impl="xla")
    np_params = bridge.init_numpy(base, 3)
    scfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,), max_mini_batch_size=8,
                         hotcold_refresh_window=8, hotcold_scan_async=False,
                         hotcold_refresh_interval=4, hotcold_refresh_margin=0.05)
    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    eng = engine.ComputeEngine(0, cfg, scfg, req_q, resp_q, ready_q,
                               params=bridge.params_from_numpy(np_params, base, "cpu"),
                               mesh=_meshes(*axes)[0])
    eng.start()
    assert not isinstance(ready_q.get(timeout=300), Exception)
    table, progs = eng.params.entry(0, 0)["hot_table"], eng.programs
    D, M = axes
    assert eng.params.entry(D - 1, M - 1)["hot_table"] is table
    hot = set(int(i) for i in eng._hotcold.hot_ids)
    pools = [[i for i in range(r) if int(off) + i not in hot][:6]
             for off, r in zip(cfg.table_offsets, cfg.scaled_rows)]
    rng = np.random.default_rng(0)

    def drift():
        return np.stack([rng.choice(p, size=(8, 1)) for p in pools], axis=1).astype(np.int32)

    def predict(idx):
        req_q.put(packets.ServiceRequest(batch_id=0, batch_size=8, arrival_time=time.time(),
                                         payload=Batch(dense=None, indices=idx)))
        r = resp_q.get(timeout=120)
        assert r.error_code == 0
        return r.scores

    try:
        for _ in range(8):
            predict(drift())
            if eng.hot_refreshes:
                break
        assert eng.hot_refreshes == 1 and eng._hotcold_active
        assert eng.programs is progs and eng.graph_captures == 0
        assert eng.params.entry(D - 1, M - 1)["hot_table"] is table
        assert torch.equal(table, sharding.gather_rows(eng.params, eng._hotcold.hot_ids))
        assert hot.isdisjoint(int(i) for i in eng._hotcold.hot_ids[:8])  # a new head
        idx = drift()
        got = predict(idx)
    finally:
        req_q.put(None)
        eng.join(timeout=120)
    assert eng.error is None
    jax_cfg = jax_zoo.get_config("ncf", table_scale=500)
    want = np.asarray(jax_get_model(jax_cfg).apply(
        jax.tree_util.tree_map(jax.numpy.asarray, np_params), JaxBatch(dense=None, indices=idx)),
        np.float32)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,impl,wrapper", [("rm1", "xla", "embedding_bag_shard"),
                                               ("ncf", "hotcold", "embedding_bag_hotcold_shard")])
def test_mesh_engine_counts_a_launch_a_shard_per_execution(monkeypatch, name, impl, wrapper):
    """With a counting lookup in place of the shard wrapper (the mesh paths
    look it up in ``ops`` at each call), every execution of a 2x4 mesh
    engine, warm-up included, makes one window (or K6) call a (data, model)
    cell: the invariant chip_smoke.py holds on the card, where each replay
    adds its capture's tally once."""
    lock, orig = threading.Lock(), getattr(ops, wrapper)

    def counting(*args, **kwargs):
        with lock:
            counting.kernel_launches += 1
        return orig(*args, **kwargs)
    counting.kernel_launches = 0
    monkeypatch.setattr(ops, wrapper, counting)
    cfg = zoo.get_config(name, table_scale=SCALE, embedding_impl=impl, hot_set_rows=64)
    scfg = ServingConfig(engine_backend="cpu", batch_buckets=(4, 8), max_mini_batch_size=8,
                         accept_ragged=impl == "xla")
    mesh = _meshes(2, 4)[0]
    eng, _ = _serve(engine.ComputeEngine, cfg, scfg,
                    [_rows(cfg, 3, 11), _rows(cfg, 8, 12, masked=impl == "xla")], mesh=mesh)
    executions = sum(eng.bucket_counts.values()) + eng.warmup_executions
    assert eng.warmup_executions == len(eng.programs) and sum(eng.bucket_counts.values()) == 2
    assert counting.kernel_launches == mesh.size * executions


def test_eager_reason_is_one_rule_for_engines_and_trainers():
    """Programs over a mesh of one process are captured, whether its entries
    name one card or several (a graph a card, for the engines and the
    trainers alike). Across processes the engines' reason goes by backend
    (an engine raises before it asks, ``Mesh.require_one_process``): over
    gloo the engines and the trainers share it; over nccl a trainer of one
    card a process could capture its step but keeps it eager for the
    replays' measured slowdown, an engine gives its own reason.
    ``tests/test_torch_distributed.py`` reads a real trainer's reason across
    processes."""
    import types

    from deeprecsys_tpu_torch import train_programs

    one = make_mesh(2, 2, devices=["cpu"] * 4)
    two_cards = make_mesh(1, 2, devices=[torch.device("cuda", 0), torch.device("cuda", 1)])
    assert programs.eager_reason(None) is None and programs.eager_reason(one) is None
    assert programs.eager_reason(two_cards) is None
    assert train_programs.eager_reason(two_cards) is None
    gloo = types.SimpleNamespace(multi_process=True, backend="gloo",
                                 distinct_devices=[torch.device("cpu")])
    reason = programs.eager_reason(gloo)
    assert "across processes" in reason and "gloo" in reason
    assert train_programs.eager_reason(gloo) == reason
    nccl = types.SimpleNamespace(multi_process=True, backend="nccl",
                                 distinct_devices=[torch.device("cuda", 0)])
    assert "one process" in programs.eager_reason(nccl)
    assert train_programs.capture_reason(nccl) is None
    assert train_programs.eager_reason(nccl) == train_programs.NCCL_SLOWER
    assert train_programs.eager_reason(one) is None
    scfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,), max_mini_batch_size=8)
    qs = [queue.Queue() for _ in range(3)]
    assert engine.ComputeEngine(0, zoo.get_config("ncf", table_scale=SCALE), scfg, *qs,
                                mesh=one).eager_reason is None


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
