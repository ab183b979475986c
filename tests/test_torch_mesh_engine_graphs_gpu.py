"""A mesh engine's CUDA graphs on one card: every program a
``ComputeEngine(mesh=)`` of the card's virtual shards captured at warm-up
replays what the eager mesh forward computes.

These tests need a card; without one they skip. The file imports no JAX
(``--noconftest`` skips ``tests/conftest.py``, which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_mesh_engine_graphs_gpu.py

- rm1 and dien (bf16, ``table_scale`` 2000 and 2500) on ``accept_ragged``
  engines over a 2x2 and a 1x4 mesh whose entries are all the card: each program's
  first replay against the eager forward the engine ran before capturing
  it (``warm_err``, expected 0.0: the same kernels on the same inputs) and
  against the single-device ``model.apply`` on the program's warm rows,
  payload requests (padded, masked) against ``model.apply``, all within two
  bf16 ulps of the output's largest magnitude (the zoo's bf16 limit); the
  window kernel launched once a shard an execution, warm-up included.
- A hot/cold engine (rm1, tensor-parallel 1x4 and hybrid 2x2) at every
  mesh cold rung, the same way, K6 once a shard an execution.
- A reload while replays are queued on the engine's stream: requests sent
  after it was scheduled get the new checkpoint's scores (f32: rtol 1e-5,
  atol 1e-6), the caller's params are not written.
- A refresh of the same size writes the new hot rows into the captured hot
  table (the same tensor) and the next scores are the direct model's.
- A replayed execution makes no host synchronization
  (``torch.cuda.set_sync_debug_mode("error")``), direct and hot/cold.
"""

import queue
import time

import numpy as np
import pytest
import torch

from deeprecsys_tpu_torch import ServingConfig, bridge, ops, zoo
from deeprecsys_tpu_torch.models import get_model
from deeprecsys_tpu_torch.models.base import Batch
from deeprecsys_tpu_torch.models.hotcold import cold_buckets_for
from deeprecsys_tpu_torch.parallel import make_mesh, sharding
from deeprecsys_tpu_torch.serving import engine, packets

pytestmark = pytest.mark.gpu

SCALE = 2000
MESHES = [(2, 2), (1, 4)]
SPLIT_KEYS = ("hot_sel", "hot_mask", "cold_local", "cold_seg")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def bf16_atol(want: np.ndarray) -> float:
    """Two bf16 ulps of the largest |value| of ``want``."""
    big = max(float(np.abs(want).max()), float(np.finfo(np.float32).tiny))
    return 2.0 * 2.0 ** (np.floor(np.log2(big)) - 7)


def _mesh(device, D: int, M: int):
    return make_mesh(D, M, devices=[device] * (D * M))


class _Engine:
    """A started mesh engine on the card and its queues."""

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


def _rows(cfg, n: int, seed: int, masked: bool = False):
    rng = np.random.default_rng(seed)
    rows = np.asarray(cfg.scaled_rows, dtype=np.int64)
    T, L = cfg.num_tables, cfg.num_indices_per_lookup
    idx = rng.integers(0, rows[None, :, None], size=(n, T, L)).astype(np.int32)
    dense = rng.random((n, cfg.dense_dim), dtype=np.float32) if cfg.dense_dim else None
    mask = (rng.random((n, T, L)) < 0.6) if masked else None
    return idx, dense, mask


def _apply(model, params, device, idx, dense=None, mask=None) -> np.ndarray:
    with torch.inference_mode():
        out = model.apply(params, Batch(dense=dense, indices=idx, mask=mask).to(device))
        return out.float().cpu().numpy()


def _check_programs(e: _Engine, reference) -> float:
    """Each program's first replay against its eager forward and against
    ``reference(key, warm rows)``; every program captured. Returns the
    largest error."""
    worst = 0.0
    for prog in e.eng.programs:
        assert prog.graph is not None and prog.launches, prog.key
        want = reference(prog.key, e.eng.warm_inputs(prog.key))
        err = float(np.abs(prog.first_scores - want).max())
        assert prog.warm_err <= bf16_atol(want) and err <= bf16_atol(want), (prog.key, err)
        worst = max(worst, err, prog.warm_err)
    assert e.eng.eager_reason is None
    assert e.eng.graph_captures == len(e.eng.programs) and e.eng.capture_ms > 0
    assert e.eng.graph_pool_bytes > 0
    return worst


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: f"{a[0]}x{a[1]}")
@pytest.mark.parametrize("name", ["rm1", "dien"])
def test_mesh_replays_match_the_eager_forward(cuda, name, axes):
    # dien at 2500: its rows divide the model axis (at 2000 they would be
    # replicated, with the JAX package's warning)
    cfg = zoo.get_config(name, table_scale=SCALE if name == "rm1" else 2500,
                         param_dtype="bfloat16", compute_dtype="bfloat16")
    model = get_model(cfg, cuda)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    mesh = _mesh(cuda, *axes)
    scfg = ServingConfig(engine_backend="gpu", batch_buckets=(8, 32), max_mini_batch_size=32,
                         accept_ragged=True)
    before = {"embedding_bag_shard": ops.embedding_bag_shard.kernel_launches,
              "embedding_bag": ops.embedding_bag.kernel_launches}
    e = _Engine(cfg, scfg, mesh, params=params)
    try:
        _check_programs(e, lambda key, rows: _apply(
            model, params, cuda, rows["indices"], rows.get("dense"), rows.get("mask")))
        assert len(e.eng.programs) == 4  # two buckets, each with its masked twin
        payloads = [_rows(cfg, 5, 1), _rows(cfg, 20, 2, masked=True)]
        for p in payloads:
            e.send(*p)
        for p in payloads:
            got, want = e.answer(), _apply(model, params, cuda, *p)
            assert np.abs(got - want).max() <= bf16_atol(want)
    finally:
        e.stop()
    executions = sum(e.eng.bucket_counts.values()) + e.eng.warmup_executions
    assert e.eng.warmup_executions == 2 * len(e.eng.programs)  # the eager forward, a replay
    launches = {k: getattr(ops, k).kernel_launches - v for k, v in before.items()}
    # the references above: one single-device forward a program and a payload
    assert launches == {"embedding_bag_shard": mesh.size * executions,
                        "embedding_bag": len(e.eng.programs) + len(payloads)}


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: f"{a[0]}x{a[1]}")
def test_mesh_hotcold_replays_match_the_eager_forward_at_every_rung(cuda, axes):
    cfg = zoo.get_config("rm1", table_scale=SCALE, param_dtype="bfloat16",
                         compute_dtype="bfloat16", embedding_impl="hotcold", hot_set_rows=256)
    direct = get_model(cfg.replace(embedding_impl="xla"), cuda)
    params = direct.init(torch.Generator(device=cuda).manual_seed(0))
    mesh = _mesh(cuda, *axes)
    scfg = ServingConfig(engine_backend="gpu", batch_buckets=(8, 32), max_mini_batch_size=32)
    before = ops.embedding_bag_hotcold_shard.kernel_launches
    e = _Engine(cfg, scfg, mesh, params=params)
    hc = e.eng._hotcold
    try:
        def reference(key, rows):
            split = {k: rows[k].to(cuda) for k in SPLIT_KEYS}
            with torch.inference_mode():
                out = hc.apply(e.eng.params, Batch(dense=rows["dense"].to(cuda), indices=None),
                               split)
                return out.float().cpu().numpy()
        _check_programs(e, reference)
        T, L = cfg.num_tables, cfg.num_indices_per_lookup
        assert [k for k in e.eng.programs.programs] == [
            ("hotcold", b, c) for b in (8, 32) for c in cold_buckets_for(b * T * L, mesh)]
        idx, dense, _ = _rows(cfg, 6, 3)
        e.send(idx, dense)
        got, want = e.answer(), _apply(direct, params, cuda, idx, dense)
        assert np.abs(got - want).max() <= bf16_atol(want)
    finally:
        e.stop()
    executions = sum(e.eng.bucket_counts.values()) + e.eng.warmup_executions
    # the reference above ran the mesh lookup once a program
    assert (ops.embedding_bag_hotcold_shard.kernel_launches - before
            == mesh.size * (executions + len(e.eng.programs)))


def test_mesh_reload_under_queued_replays(cuda, tmp_path):
    from deeprecsys_tpu_torch.utils.checkpoint import save_params

    cfg = zoo.get_config("rm1", table_scale=SCALE)
    model = get_model(cfg, cuda)
    old, new = bridge.init_numpy(cfg, 1), bridge.init_numpy(cfg, 2)
    save_params(str(tmp_path / "ckpt"), new)
    caller = bridge.params_from_numpy(old, cfg, cuda)
    leaves = [caller["tables"]] + [t for layer in caller["bot"] + caller["top"]
                                   for t in layer.values()]
    before = [(t.clone(), t._version) for t in leaves]
    new_params = bridge.params_from_numpy(new, cfg, cuda)
    scfg = ServingConfig(engine_backend="gpu", batch_buckets=(32,), max_mini_batch_size=32)
    e = _Engine(cfg, scfg, _mesh(cuda, 2, 2), params=caller)
    first = e.eng.programs
    batches = [_rows(cfg, 32, 10 + i) for i in range(24)]
    try:
        for p in batches[:16]:
            e.send(*p)
        handle = e.eng.request_reload(str(tmp_path / "ckpt"))
        for p in batches[16:]:
            e.send(*p)
        got = [e.answer() for _ in batches]
        assert handle.event.wait(timeout=60) and handle.error is None
    finally:
        e.stop()
    assert e.eng.programs is not first and e.eng.last_reload_ms > 0
    assert e.eng.graph_captures == 2 * len(e.eng.programs)
    for i, (p, scores) in enumerate(zip(batches, got)):
        want_new = _apply(model, new_params, cuda, *p)
        if i >= 16:  # sent after the reload was scheduled
            np.testing.assert_allclose(scores, want_new, rtol=1e-5, atol=1e-6)
        else:
            want_old = _apply(model, caller, cuda, *p)
            assert (np.allclose(scores, want_old, rtol=1e-5, atol=1e-6)
                    or np.allclose(scores, want_new, rtol=1e-5, atol=1e-6)), i
    for t, (value, version) in zip(leaves, before):
        assert t._version == version and torch.equal(t, value)


def test_mesh_refresh_writes_the_captured_hot_table_in_place(cuda):
    cfg = zoo.get_config("ncf", table_scale=500).replace(embedding_impl="hotcold",
                                                          hot_set_rows=64)
    scfg = ServingConfig(engine_backend="gpu", batch_buckets=(8,), max_mini_batch_size=8,
                         hotcold_refresh_window=8, hotcold_scan_async=False,
                         hotcold_refresh_interval=4, hotcold_refresh_margin=0.05)
    e = _Engine(cfg, scfg, _mesh(cuda, 1, 4))
    eng = e.eng
    table, progs = eng.params.entry(0, 0)["hot_table"], eng.programs
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
    assert eng.params.entry(0, 3)["hot_table"] is table and eng.programs is progs
    assert eng.graph_captures == len(progs)
    assert torch.equal(table, sharding.gather_rows(eng.params, eng._hotcold.hot_ids))
    full = {k: v for k, v in eng.params.entry(0, 0).items() if k != "hot_table"}
    full["tables"] = torch.cat([eng.params.entry(0, m)["tables"] for m in range(4)])
    want = _apply(eng.model, full, cuda, idx)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("impl", ["xla", "hotcold"])
def test_mesh_replayed_execution_makes_no_host_sync(cuda, impl):
    cfg = zoo.get_config("rm1", table_scale=SCALE, param_dtype="bfloat16",
                         compute_dtype="bfloat16", embedding_impl=impl, hot_set_rows=256)
    scfg = ServingConfig(engine_backend="gpu", batch_buckets=(8, 32), max_mini_batch_size=32)
    e = _Engine(cfg, scfg, _mesh(cuda, 2, 2))
    runs = sum(p.runs for p in e.eng.programs)
    try:
        torch.cuda.set_sync_debug_mode("error")
        try:
            e.send(*_rows(cfg, 20, 5)[:2])
            scores = e.answer()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    finally:
        e.stop()
    assert scores.shape == (20, 1) and np.isfinite(scores).all()
    assert sum(p.runs for p in e.eng.programs) == runs + 1
