"""The engines' serve-time programs (``serving/programs.py``) on the CPU,
against the JAX package's engine.

An engine without a mesh serves every execution through one program a
bucket (a masked twin, a cold rung): on a card a CUDA graph replayed over
static inputs, here the same program's eager forward over the same static
buffers, so these tests reach the copy-in, the slicing and the copy-out a
card replays. The same seeded requests go through the port's and the JAX
package's ``ComputeEngine`` on the same weights (``bridge.init_numpy``, f32:
rtol and atol 1e-5, the same math in another summation order). Tables are
cut by ``table_scale=2000``. The card's own checks (replay against the
eager forward, reloads under queued replays, sync-free replays) are in
``tests/test_torch_engine_graphs_gpu.py``.
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
from deeprecsys_tpu.serving import engine as jax_engine
from deeprecsys_tpu.serving import packets as jax_packets
from deeprecsys_tpu_torch import ServingConfig, bridge, ops, zoo
from deeprecsys_tpu_torch.models.base import Batch
from deeprecsys_tpu_torch.models.hotcold import cold_buckets_for
from deeprecsys_tpu_torch.ops import _build
from deeprecsys_tpu_torch.serving import engine, packets

SCALE = 2000
RTOL = ATOL = 1e-5


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
    batch = Batch if cls is engine.ComputeEngine else JaxBatch
    request = packets.ServiceRequest if cls is engine.ComputeEngine else jax_packets.ServiceRequest
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


def _port_and_jax(name, quant, impl, scfg_kw, payloads_of, seed=5, **cfg_kw):
    port_cfg = zoo.get_config(name, table_scale=SCALE, table_quant=quant, embedding_impl=impl,
                              **cfg_kw)
    jax_cfg = jax_zoo.get_config(name, table_scale=SCALE, table_quant=quant,
                                 embedding_impl=impl, **cfg_kw)
    np_params = bridge.init_numpy(port_cfg, seed)
    payloads = payloads_of(port_cfg)
    port = _serve(engine.ComputeEngine, port_cfg, ServingConfig(**scfg_kw), payloads,
                  device="cpu", params=bridge.params_from_numpy(np_params, port_cfg, "cpu"))
    want = _serve(jax_engine.ComputeEngine, jax_cfg, JaxServingConfig(**scfg_kw), payloads,
                  device=jax.devices("cpu")[0], params=np_params)
    return port, want


CASES = {
    # 5 and 3 rows padded to bucket 8, 20 to bucket 32
    "padded": ("rm1", "none", "xla", {"batch_buckets": (8, 32)},
               lambda cfg: [_rows(cfg, 5, 1), _rows(cfg, 20, 2), _rows(cfg, 3, 3)]),
    "ragged": ("rm1", "none", "xla", {"batch_buckets": (8,), "accept_ragged": True},
               lambda cfg: [_rows(cfg, 6, 4, masked=True), _rows(cfg, 8, 5)]),
    "int8": ("rm1", "int8", "xla", {"batch_buckets": (8,)},
             lambda cfg: [_rows(cfg, 7, 6)]),
    "int8_rowwise": ("rm1", "int8_rowwise", "xla", {"batch_buckets": (8,)},
                     lambda cfg: [_rows(cfg, 8, 7)]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_program_scores_equal_jax(case):
    """Each execution runs the program of its bucket (the masked twin for a
    ragged request, the int8 layouts' lookups) and answers the JAX engine's
    scores for the same rows; every program was warmed at set-up, one
    warm-up execution a program."""
    name, quant, impl, kw, payloads_of = CASES[case]
    scfg = dict(engine_backend="cpu", max_mini_batch_size=max(kw["batch_buckets"]), **kw)
    (port, got), (jx, want) = _port_and_jax(name, quant, impl, scfg, payloads_of)
    for i in want:
        assert got[i].error_code == want[i].error_code == 0
        assert got[i].out_batch_size == want[i].out_batch_size
        np.testing.assert_allclose(got[i].scores, want[i].scores, rtol=RTOL, atol=ATOL)
    assert port.bucket_counts == jx.bucket_counts
    keys = [("direct", b) for b in kw["batch_buckets"]]
    if kw.get("accept_ragged"):
        keys = [k for b in kw["batch_buckets"] for k in (("direct", b), ("masked", b))]
    assert list(port.programs.programs) == keys
    assert port.warmup_executions == len(keys) == port.programs.executions
    assert port.graph_captures == 0 and port.graph_pool_bytes is None  # no card here
    runs = {k: p.runs for k, p in port.programs.programs.items()}
    assert sum(runs.values()) == sum(port.bucket_counts.values())
    if case == "ragged":
        assert runs == {("direct", 8): 1, ("masked", 8): 1}


def test_hotcold_programs_at_two_cold_rungs_equal_jax():
    """A hot/cold engine: a request of hot ids takes the smallest cold rung
    and a uniform one a larger rung; both programs answer the JAX hot/cold
    engine's scores, and every rung was warmed on real rows (a split of the
    bucket's rows cut to the rung, scores finite)."""
    name, kw = "ncf", {"batch_buckets": (8,)}
    port_cfg = zoo.get_config(name, table_scale=SCALE, embedding_impl="hotcold",
                              hot_set_rows=32)
    hot = {}

    def payloads_of(cfg):
        # The engine's hot set: the JAX engine's rule on the same stream.
        from deeprecsys_tpu_torch.models.hotcold import hot_ids_from_generator

        hot["ids"] = hot_ids_from_generator(cfg, seed=31, hot_rows=32)
        return [_rows(cfg, 8, 8, hot=hot["ids"]), _rows(cfg, 8, 9)]

    scfg = dict(engine_backend="cpu", max_mini_batch_size=8, **kw)
    (port, got), (jx, want) = _port_and_jax(name, "none", "hotcold", scfg, payloads_of,
                                            hot_set_rows=32)
    np.testing.assert_array_equal(port._hotcold.hot_ids, hot["ids"])
    np.testing.assert_array_equal(port._hotcold.hot_ids, jx._hotcold.hot_ids)
    for i in want:
        assert got[i].error_code == want[i].error_code == 0
        np.testing.assert_allclose(got[i].scores, want[i].scores, rtol=RTOL, atol=ATOL)
    rungs = cold_buckets_for(8 * port_cfg.num_tables * port_cfg.num_indices_per_lookup)
    assert len(rungs) >= 2
    runs = {k[2]: p.runs for k, p in port.programs.programs.items()}
    assert set(runs) == set(rungs) and port.warmup_executions == len(rungs)
    served = sorted(rung for rung, n in runs.items() if n)
    assert served[0] == rungs[0] and len(served) == 2 and sum(runs.values()) == 2
    for p in port.programs:
        assert p.first_scores.shape == (8, port_cfg.out_dim) and np.isfinite(p.first_scores).all()


def test_reload_rebuilds_programs_and_leaves_callers_params(tmp_path):
    """A request sent after a reload was scheduled gets the new
    checkpoint's scores (the JAX model's on it); the programs are built
    again against the new params, and the caller's ``params=`` tensors keep
    their values and versions: nothing is written into them."""
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
    eng = engine.ComputeEngine(0, cfg, scfg, req_q, resp_q, ready_q, device="cpu", params=caller)
    eng.start()
    assert not isinstance(ready_q.get(timeout=300), Exception)
    first = eng.programs
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
    assert eng.error is None and eng.programs is not first
    assert eng.warmup_executions == 2  # one program, built twice
    model = jax_get_model(jax_cfg)
    for r, weights in zip(got, (old, new)):
        want = np.asarray(model.apply(jax.tree_util.tree_map(jax.numpy.asarray, weights),
                                      JaxBatch(dense=dense, indices=idx)), np.float32)
        assert r.error_code == 0
        np.testing.assert_allclose(r.scores, want, rtol=RTOL, atol=ATOL)
    for t, (value, version) in zip(leaves, before):
        assert t._version == version and torch.equal(t, value)


def test_refresh_writes_new_hot_rows_into_the_programs_table():
    """A refresh of the same size writes the new hot rows into the hot
    table the programs were built on (no rebuild); the next executions
    score the direct model's values, which a program reading the old rows
    would miss."""
    cfg = zoo.get_config("ncf", table_scale=500).replace(embedding_impl="hotcold",
                                                          hot_set_rows=64)
    scfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,), max_mini_batch_size=8,
                         hotcold_refresh_window=8, hotcold_scan_async=False,
                         hotcold_refresh_interval=4, hotcold_refresh_margin=0.05)
    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    eng = engine.ComputeEngine(0, cfg, scfg, req_q, resp_q, ready_q, device="cpu")
    eng.start()
    assert not isinstance(ready_q.get(timeout=300), Exception)
    table, progs = eng.params["hot_table"], eng.programs
    hot = set(int(i) for i in eng._hotcold.hot_ids)
    pools = [[i for i in range(r) if int(off) + i not in hot][:6]
             for off, r in zip(cfg.table_offsets, cfg.scaled_rows)]
    rng = np.random.default_rng(0)

    def predict(idx):
        req_q.put(packets.ServiceRequest(batch_id=0, batch_size=8, arrival_time=time.time(),
                                         payload=Batch(dense=None, indices=idx)))
        r = resp_q.get(timeout=120)
        assert r.error_code == 0
        return r.scores

    try:
        for _ in range(8):
            predict(np.stack([rng.choice(p, size=(8, 1)) for p in pools], axis=1).astype(np.int32))
            if eng.hot_refreshes:
                break
        assert eng.hot_refreshes == 1 and eng._hotcold_active
        assert eng.params["hot_table"] is table and eng.programs is progs
        hot_ids = torch.as_tensor(np.asarray(eng._hotcold.hot_ids, dtype=np.int64))
        assert torch.equal(table, eng.params["tables"][hot_ids])
        idx = np.stack([rng.choice(p, size=(8, 1)) for p in pools], axis=1).astype(np.int32)
        got = predict(idx)
    finally:
        req_q.put(None)
        eng.join(timeout=120)
    assert eng.error is None
    direct = {k: v for k, v in eng.params.items() if k != "hot_table"}
    with torch.inference_mode():
        want = eng.model.apply(direct, Batch(dense=None, indices=torch.from_numpy(idx))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_replay_tallies_captured_launches_once_per_execution():
    """Launches made while a thread records (a graph capture, where nothing
    runs) reach the counters only through ``count_replay``, once a replay;
    another thread's launches meanwhile count as usual."""
    def wrapper():
        pass
    wrapper.kernel_launches = 0
    with _build.recording_launches() as tally:
        _build.count_launch(wrapper)
        other = threading.Thread(target=_build.count_launch, args=(wrapper,))
        other.start()
        other.join(timeout=10)
        _build.count_launch(wrapper)
    assert tally == {wrapper: 2} and wrapper.kernel_launches == 1
    for _ in range(3):
        _build.count_replay(tally)
    assert wrapper.kernel_launches == 7
    _build.count_launch(wrapper)
    assert wrapper.kernel_launches == 8


def test_engine_counts_one_lookup_per_execution(monkeypatch):
    """With a counting lookup in place of K1's wrapper (the models look it
    up at each call), an engine's executions, warm-up included, each make
    one lookup: the invariant chip_smoke.py holds on the card, where each
    replay adds its capture's tally."""
    lock = threading.Lock()

    def counting(*args, **kwargs):
        with lock:
            counting.kernel_launches += 1
        return ops.embedding_bag_reference(*args, **kwargs)
    counting.kernel_launches = 0
    monkeypatch.setattr(ops, "embedding_bag", counting)
    cfg = zoo.get_config("rm1", table_scale=SCALE)
    scfg = ServingConfig(engine_backend="cpu", batch_buckets=(4, 8), max_mini_batch_size=8,
                         accept_ragged=True)
    eng, got = _serve(engine.ComputeEngine, cfg, scfg,
                      [_rows(cfg, 3, 11), _rows(cfg, 8, 12, masked=True)], device="cpu")
    executions = sum(eng.bucket_counts.values()) + eng.warmup_executions
    assert eng.warmup_executions == 4 and executions == 6
    assert counting.kernel_launches == executions


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree

