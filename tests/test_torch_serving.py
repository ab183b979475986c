"""The port's serving stack against the JAX package's, on the CPU.

The same configs and seeds go through both packages: DeepRecSched's step
sequence for a scripted p95 feed, the load generator's request stream,
``run_serving``'s counts, the engines' answers to the same requests
(codes, rows, counters) and their payload scores on bridged weights (f32,
rtol and atol 1e-5: the same math in another summation order). Tables are
cut by ``table_scale``, as in ``tests/test_serving.py``.
"""

import dataclasses
import queue
import time

import jax
import numpy as np
import pytest
import torch

from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu.config import ServingConfig as JaxServingConfig
from deeprecsys_tpu.models.base import Batch as JaxBatch
from deeprecsys_tpu.serving import engine as jax_engine
from deeprecsys_tpu.serving import load_generator as jax_lg
from deeprecsys_tpu.serving import orchestrator as jax_orch
from deeprecsys_tpu.serving import packets as jax_packets
from deeprecsys_tpu.serving import scheduler as jax_sched
from deeprecsys_tpu.serving.engine import pick_bucket as jax_pick_bucket
from deeprecsys_tpu.serving.latency_model import LatencyModel as JaxLatencyModel
from deeprecsys_tpu_torch import ServingConfig, bridge, serving, zoo
from deeprecsys_tpu_torch.models.base import Batch
from deeprecsys_tpu_torch.serving import engine, load_generator, orchestrator, packets, scheduler
from deeprecsys_tpu_torch.serving.latency_model import LatencyModel

SCALE = 5000       # tests/test_serving.py's table scale
PARITY_SCALE = 2000
RTOL = ATOL = 1e-5


@pytest.mark.parametrize("max_batch", [32, 1024])
def test_pick_bucket_matches_engine(max_batch):
    scfg = ServingConfig(max_mini_batch_size=max_batch, sub_task_batch_size=32)
    buckets = tuple(b for b in sorted(serving.resolve_buckets(scfg)) if b <= max_batch)
    for n in range(1, 2 * max_batch + 1):
        assert serving.pick_bucket(buckets, n) == jax_pick_bucket(buckets, n)


# ------------------------------------------------------------ scheduler


def _feed(kind: str, n: int = 240) -> list[float]:
    """Scripted windowed-p95 values (ms) around a 10 ms target."""
    if kind == "under":
        return [2.0] * n
    if kind == "over":
        return [40.0] * n
    if kind == "stable":
        return [9.5] * n
    return list(np.random.default_rng(int(kind)).uniform(1.0, 25.0, n))


@pytest.mark.parametrize("mode", ["cpu", "accel"])
@pytest.mark.parametrize("feed", ["under", "over", "stable", "0", "1", "2"])
def test_scheduler_steps_equal_jax(mode, feed):
    """The same p95 feed gives the same arrival rates, tuning flags and
    drain-and-settle actions, the same per-config rates and the same pick."""
    kw = dict(batch_configs=(32, 64, 128, 256), accel_configs=(128, 256, 512),
              arr_steps=5, sched_timeout=4, target_latency_ms=10.0, min_arr_range=0.5,
              max_arr_range=20.0, avg_arrival_rate_ms=3.0, stable_region=0.1)
    port_state = scheduler.TuningState(64, 1024)
    jax_state = jax_sched.TuningState(64, 1024)
    port = scheduler.DeepRecScheduler(ServingConfig(**kw), port_state, mode=mode)
    want = jax_sched.DeepRecScheduler(JaxServingConfig(**kw), jax_state, mode=mode)
    for p95 in _feed(feed):
        got_step, want_step = port.step(p95), want.step(p95)
        assert dataclasses.astuple(got_step) == dataclasses.astuple(want_step)
        assert dataclasses.astuple(port_state) == dataclasses.astuple(jax_state)
    assert port.config_rates == want.config_rates and port.config_rates
    assert port.optimal_config == want.optimal_config is not None
    assert port.tuning is want.tuning is False
    with pytest.raises(ValueError, match="unsupported scheduling mode"):
        scheduler.DeepRecScheduler(ServingConfig(), port_state, mode="gpu")


# ------------------------------------------------------------ load generator


def _stream(lg_cls, cfg, n_ready: int):
    req_q, accel_q, pid_q, ready_q = (queue.Queue() for _ in range(4))
    for i in range(n_ready):
        ready_q.put(i)
    lg = lg_cls(cfg, req_q, accel_q, pid_q, ready_q, settle_s=0.0)
    lg.start()
    lg.join(timeout=120)
    assert not lg.is_alive() and lg.error is None

    def drain(q):
        out = []
        while not q.empty():
            r = q.get_nowait()
            out.append(None if r is None else (r.batch_id, r.epoch, r.batch_size, r.sub_id,
                                               r.total_sub_batches, r.exp_packet))
        return out

    return lg, drain(req_q), drain(accel_q)


@pytest.mark.parametrize("kw", [
    dict(batch_size_distribution="normal", avg_mini_batch_size=165, var_mini_batch_size=16,
         sub_task_batch_size=32, num_batches=120, seed=123),
    dict(batch_size_distribution="lognormal", avg_mini_batch_size=4.5, var_mini_batch_size=1.0,
         max_mini_batch_size=512, sub_task_batch_size=48, num_batches=150, nepochs=2,
         inference_engines=3, model_accel=True, accel_request_size_thres=200, seed=9),
    dict(batch_size_distribution="fixed", avg_mini_batch_size=70, sub_task_batch_size=16,
         num_batches=40, nepochs=3, inference_engines=2, seed=4),
])
def test_load_generator_stream_equals_jax(kw):
    """One seed, one request stream: the same queries, sizes, splits,
    routing, epochs and sentinels, and the same counts. (Arrivals ~0.05 ms
    apart: the Poisson delay is still drawn per query.)"""
    kw = dict(kw, avg_arrival_rate_ms=0.05)
    n_ready = kw.get("inference_engines", 1) + int(kw.get("model_accel", False))
    port, got_req, got_accel = _stream(load_generator.LoadGenerator, ServingConfig(**kw), n_ready)
    want, want_req, want_accel = _stream(jax_lg.LoadGenerator, JaxServingConfig(**kw), n_ready)
    assert got_req == want_req and got_accel == want_accel
    for attr in ("cpu_requests", "cpu_sub_requests", "accel_requests"):
        assert getattr(port, attr) == getattr(want, attr), attr
    assert port.cpu_requests == kw["num_batches"] * kw.get("nepochs", 1) - port.accel_requests
    assert len(port.pacing_errors_s) == kw["num_batches"] * kw.get("nepochs", 1)
    assert min(port.pacing_errors_s) > -1e-3  # time.sleep never returns early


class _LateClock:
    """A virtual clock for ``load_generator.time``: ``perf_counter()`` reads
    it and ``sleep(s)`` advances it by ``s`` plus ``late`` (a sleep that
    always wakes late). Times are dyadic, so every sum is exact."""

    def __init__(self, start: float, late: float):
        self.now, self.late, self.sleeps = start, late, 0

    def perf_counter(self) -> float:
        return self.now

    def sleep(self, s: float):
        self.sleeps += 1
        self.now += s + self.late


def test_pacing_overshoot_does_not_add_up(monkeypatch):
    """Twenty gaps of 2^-9 s (~2 ms) with a sleep that always wakes 2^-10 s
    (~1 ms) late, on a virtual clock: each wake-up is exactly 2^-10 s late
    and the schedule ends exactly 2^-10 s late, not twenty times that (the
    sum of the overshoots, as sleeping for each gap would); a deadline
    already passed returns its lateness without sleeping."""
    gap, late = 2.0 ** -9, 2.0 ** -10
    clock = _LateClock(1024.0, late)
    monkeypatch.setattr(load_generator, "time", clock)
    start = t_next = clock.perf_counter()
    woke = []
    for _ in range(20):
        t_next += gap
        woke.append(load_generator.sleep_until(t_next))
    assert woke == [late] * 20 and clock.sleeps == 20
    assert clock.perf_counter() - start - 20 * gap == late
    assert load_generator.sleep_until(clock.perf_counter() - 1.0) == 1.0  # already late
    assert clock.sleeps == 20


def test_load_generator_raises_on_engine_setup_failure():
    req_q, accel_q, pid_q, ready_q = (queue.Queue() for _ in range(4))
    ready_q.put(RuntimeError("no card"))
    lg = load_generator.LoadGenerator(ServingConfig(), req_q, accel_q, pid_q, ready_q)
    with pytest.raises(RuntimeError, match="engine failed during setup"):
        lg._run()  # in this thread


# ------------------------------------------------------------ engines


def _configs(name: str, scale: int):
    return zoo.get_config(name, table_scale=scale), jax_zoo.get_config(name, table_scale=scale)


def _run_engine(cls, model_cfg, scfg, requests, **kw):
    """One engine over ``requests``, all queued before it starts (so a
    coalescing drain sees them at once); its answers by batch_id."""
    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    for r in requests:
        req_q.put(r)
    eng = cls(0, model_cfg, scfg, req_q, resp_q, ready_q, **kw)
    eng.start()
    ready = ready_q.get(timeout=300)
    assert not isinstance(ready, Exception), ready
    req_q.put(None)
    got = {}
    for _ in requests:
        r = resp_q.get(timeout=120)
        got[r.batch_id] = r
    eng.join(timeout=120)
    assert not eng.is_alive() and eng.error is None
    return eng, got


def _both_engines(name, scale, scfg_kw, make_requests, seed=5, **engine_kw):
    """The port's and the JAX package's ComputeEngine (cpu) over the same
    requests, on the same weights (``bridge.init_numpy``, f32)."""
    port_cfg, jax_cfg = _configs(name, scale)
    np_params = bridge.init_numpy(port_cfg, seed)
    port = _run_engine(engine.ComputeEngine, port_cfg, ServingConfig(**scfg_kw),
                       make_requests(packets.ServiceRequest, Batch), device="cpu",
                       params=bridge.params_from_numpy(np_params, port_cfg, "cpu"), **engine_kw)
    want = _run_engine(jax_engine.ComputeEngine, jax_cfg, JaxServingConfig(**scfg_kw),
                       make_requests(jax_packets.ServiceRequest, JaxBatch),
                       device=jax.devices("cpu")[0], params=np_params, **engine_kw)
    return port, want


def _payload_rows(cfg, n: int, seed: int, masked: bool = False):
    rng = np.random.default_rng(seed)
    rows = np.asarray(cfg.scaled_rows, dtype=np.int64)
    T, L = cfg.num_tables, cfg.num_indices_per_lookup
    idx = rng.integers(0, rows[None, :, None], size=(n, T, L)).astype(np.int32)
    dense = rng.random((n, cfg.dense_dim), dtype=np.float32) if cfg.dense_dim else None
    mask = (rng.random((n, T, L)) < 0.6) if masked else None
    return dense, idx, mask


@pytest.mark.parametrize("name,mode", [
    ("ncf", "single"), ("ncf", "coalesced"), ("rm1", "single"), ("rm1", "coalesced"),
    ("rm1", "ragged"), ("dien", "single"), ("dien", "coalesced")])
def test_engine_payload_scores_equal_jax(name, mode):
    """Payload requests get the JAX engine's scores for their rows: alone at
    buckets 8 and 32, coalesced between load-modeling requests into one
    32-row execution, and masked on an ``accept_ragged`` engine."""
    port_cfg = zoo.get_config(name, table_scale=PARITY_SCALE)
    p1 = _payload_rows(port_cfg, 8, 1, masked=mode == "ragged")
    p2 = _payload_rows(port_cfg, 20, 2, masked=mode == "ragged")

    def requests(req, batch):
        def payload(i, p):
            return req(batch_id=i, batch_size=len(p[1]), arrival_time=1.0,
                       payload=batch(dense=p[0], indices=p[1], mask=p[2]))
        if mode == "coalesced":
            return [req(batch_id=0, batch_size=8, arrival_time=1.0), payload(1, p1),
                    req(batch_id=2, batch_size=8, arrival_time=1.0), payload(3, p2)]
        return [payload(1, p1), payload(3, p2)]

    scfg = dict(engine_backend="cpu", batch_buckets=(8, 32, 64), max_mini_batch_size=64,
                coalesce_requests=mode == "coalesced", max_coalesce=4,
                accept_ragged=mode == "ragged")
    (port, got), (jx, want) = _both_engines(name, PARITY_SCALE, scfg, requests)
    for i in got:
        assert got[i].error_code == want[i].error_code == 0
        assert got[i].out_batch_size == want[i].out_batch_size
        if want[i].scores is None:
            assert got[i].scores is None
        else:
            assert got[i].scores.dtype == np.float32
            np.testing.assert_allclose(got[i].scores, want[i].scores, rtol=RTOL, atol=ATOL)
    assert port.bucket_counts == jx.bucket_counts
    assert port.coalesced_requests == jx.coalesced_requests
    if mode == "coalesced":
        assert port.bucket_counts == {64: 1} and port.coalesced_requests == 4


def _answers(eng, got):
    return ({i: (r.error_code, r.out_batch_size, r.scores is None) for i, r in got.items()},
            {k: getattr(eng, k) for k in ("rejected_requests", "expired_requests",
                                          "clamped_requests", "bucket_counts")})


def _scenario(kind):
    """(ServingConfig kwargs, engine kwargs, requests) of the JAX package's
    engine tests (tests/test_serving.py:1442-1520, :1739)."""
    buckets = dict(engine_backend="cpu", batch_buckets=(8,))
    if kind == "clamp":
        return dict(buckets, max_mini_batch_size=32), {"strict_buckets": False}, \
            lambda req, batch: [req(batch_id=0, batch_size=20, arrival_time=1.0)]
    if kind == "strict":
        return dict(buckets, max_mini_batch_size=32), {}, lambda req, batch: [
            req(batch_id=0, batch_size=20, arrival_time=1.0),
            req(batch_id=1, batch_size=5, arrival_time=1.0)]
    if kind == "deadline":
        return dict(buckets, max_mini_batch_size=8), {}, lambda req, batch: [
            req(batch_id=0, batch_size=5, arrival_time=1.0, deadline=2.0),   # long expired
            req(batch_id=1, batch_size=5, arrival_time=1.0, deadline=4e9)]   # live
    cfg = zoo.get_config("ncf", table_scale=SCALE)
    T, L = cfg.num_tables, cfg.num_indices_per_lookup
    rng = np.random.default_rng(3)
    wrong_t = rng.integers(0, 4, size=(8, T + 1, L)).astype(np.int32)
    good = rng.integers(0, 4, size=(8, T, L)).astype(np.int32)
    return dict(buckets, max_mini_batch_size=8), {}, lambda req, batch: [
        req(batch_id=0, batch_size=8, arrival_time=1.0, payload=batch(None, wrong_t)),
        req(batch_id=1, batch_size=8, arrival_time=1.0,
            payload=batch(None, good, np.ones((8, T, L), bool))),  # mask, not ragged
        req(batch_id=2, batch_size=8, arrival_time=1.0, payload=batch(None, good))]


@pytest.mark.parametrize("kind", ["clamp", "strict", "deadline", "malformed"])
def test_engine_admission_equals_jax(kind):
    """Clamped and over-ladder requests, expired deadlines and malformed
    payloads: the same codes, executed rows and counters as the JAX engine.
    clamp: 20 rows run at the 8-row cap; strict: ERR_OVER_LADDER, then a
    5-row request still serves; deadline: ERR_DEADLINE before dispatch;
    malformed: a wrong table count and a mask on a non-ragged engine are
    ERR_PAYLOAD, a good payload still serves."""
    scfg, engine_kw, requests = _scenario(kind)
    (port, got), (jx, want) = _both_engines("ncf", SCALE, scfg, requests, **engine_kw)
    assert _answers(port, got) == _answers(jx, want)
    codes = {i: a[0] for i, a in _answers(port, got)[0].items()}
    assert codes == {"clamp": {0: 0}, "strict": {0: packets.ERR_OVER_LADDER, 1: 0},
                     "deadline": {0: packets.ERR_DEADLINE, 1: 0},
                     "malformed": {0: packets.ERR_PAYLOAD, 1: packets.ERR_PAYLOAD, 2: 0}}[kind]


def test_out_of_range_ids_port_rejects_jax_does_not():
    """A stated difference (ROADMAP.md Queue 3). The port checks ids on the
    host and answers ERR_PAYLOAD for an id outside [0, rows[t]). The JAX
    engine runs it: an id just past its own table reads the next table's
    first row (finite, wrong), an id past the fused table gives NaN."""
    cfg = zoo.get_config("rm1", table_scale=PARITY_SCALE)
    dense, idx, _ = _payload_rows(cfg, 8, 4)
    rows = cfg.scaled_rows
    next_table, past_all = idx.copy(), idx.copy()
    next_table[2, 0, 5] = rows[0]
    past_all[5, 7, 0] = rows[7] + cfg.total_rows
    negative = idx.copy()
    negative[1, 3, 2] = -1

    def requests(req, batch):
        return [req(batch_id=i, batch_size=8, arrival_time=1.0, payload=batch(dense, ids))
                for i, ids in enumerate((next_table, past_all, negative, idx))]

    scfg = dict(engine_backend="cpu", batch_buckets=(8,), max_mini_batch_size=8)
    (port, got), (_, want) = _both_engines("rm1", PARITY_SCALE, scfg, requests)
    assert [got[i].error_code for i in range(4)] == [packets.ERR_PAYLOAD] * 3 + [0]
    assert port.rejected_requests == 3 and got[3].scores is not None
    assert [want[i].error_code for i in range(4)] == [0] * 4
    assert np.isfinite(want[0].scores).all()
    assert np.isnan(want[1].scores[5]).all() and np.isfinite(np.delete(want[1].scores, 5, 0)).all()
    np.testing.assert_allclose(got[3].scores, want[3].scores, rtol=RTOL, atol=ATOL)


def test_gpu_engine_raises_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = zoo.get_config("ncf", table_scale=SCALE)
    qs = [queue.Queue() for _ in range(3)]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        engine.ComputeEngine(0, cfg, ServingConfig(), *qs)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serving.run_serving(cfg, ServingConfig(engine_backend="gpu"), settle_s=0.01)


@pytest.mark.parametrize("what,kw", [("arena", {"arena": object()})])
def test_engine_paths_not_ported_raise(what, kw):
    """The cpu-mp arena and control ring, once refused here, are taken
    (tests/test_torch_process_engines.py serves through them). A mesh, once
    refused here too, is served (tests/test_torch_parallel.py)."""
    cfg = zoo.get_config("ncf", table_scale=SCALE)
    scfg = ServingConfig(engine_backend="cpu")
    qs = [queue.Queue() for _ in range(3)]
    eng = engine.ComputeEngine(0, cfg, scfg, *qs, device="cpu", control_q=qs[0], **kw)
    assert eng.arena is kw["arena"] and eng.control_q is qs[0]


@pytest.mark.parametrize("what", ["hotcold", "refresh"])
def test_engine_hotcold_paths_serve(what):
    """The two paths the port once refused: a hot/cold engine, and one with
    refresh tracking, serve load-modeling requests (JAX
    tests/test_serving.py:554). Checkpoint reload, once refused as well, is
    ported: a reload of an exited engine fails its handle at once."""
    cfg = zoo.get_config("ncf", table_scale=SCALE, embedding_impl="hotcold", hot_set_rows=32)
    scfg = ServingConfig(engine_backend="cpu", batch_buckets=(8, 16), max_mini_batch_size=16,
                         hotcold_refresh_interval=4 if what == "refresh" else 0)
    eng, got = _run_engine(engine.ComputeEngine, cfg, scfg, [
        packets.ServiceRequest(batch_id=i, batch_size=n, arrival_time=time.time())
        for i, n in enumerate((3, 11, 16))], device="cpu")
    assert sorted(r.batch_size for r in got.values()) == [3, 11, 16]
    assert all(r.error_code == 0 and r.inference_end_time >= r.queue_start_time
               for r in got.values())
    assert eng._hotcold is not None and eng._hotcold_active
    # Every cold rung of both buckets warmed through the split; with refresh
    # tracking the direct lookup's too.
    rungs = sum(len(engine.cold_buckets_for(b * cfg.num_tables)) for b in (8, 16))
    assert eng.warmup_executions == rungs + (2 if what == "refresh" else 0)
    h = eng.request_reload("x")
    assert h.event.is_set() and "shut down" in str(h.error)


@pytest.mark.parametrize("impl,quant", [("xla", "none"), ("hotcold", "none"),
                                        ("xla", "int8_rowwise"), ("hotcold", "int8")])
def test_engine_reload_swaps_to_the_checkpoint(tmp_path, impl, quant):
    """request_reload from another thread: the engine applies the swap
    before its next request, whose scores are then the JAX model's on the
    checkpoint (f32, the table layout of the config); a hot/cold engine
    gathers its hot table from the new tables with the same hot ids."""
    from deeprecsys_tpu.models import get_model as jax_get_model
    from deeprecsys_tpu_torch.utils.checkpoint import save_params

    port_cfg, jax_cfg = (c.replace(table_quant=quant) for c in _configs("rm1", PARITY_SCALE))
    direct = port_cfg
    port_cfg = port_cfg.replace(embedding_impl=impl, hot_set_rows=32)
    old, new = bridge.init_numpy(direct, 1), bridge.init_numpy(direct, 2)
    save_params(tmp_path / "ckpt.new", new)
    dense, idx, _ = _payload_rows(direct, 8, 3)
    scfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,), max_mini_batch_size=8)
    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    eng = engine.ComputeEngine(0, port_cfg, scfg, req_q, resp_q, ready_q, device="cpu",
                               params=bridge.params_from_numpy(old, direct, "cpu"))
    eng.start()
    assert not isinstance(ready_q.get(timeout=300), Exception)
    hot_ids = None if eng._hotcold is None else np.asarray(eng._hotcold.hot_ids)
    assert (hot_ids is not None) == (impl == "hotcold")
    got = []
    try:
        for i in range(2):
            if i == 1:
                h = eng.request_reload(str(tmp_path / "ckpt.new"))
            req_q.put(packets.ServiceRequest(batch_id=i, batch_size=8, arrival_time=time.time(),
                                             payload=Batch(dense=dense, indices=idx)))
            got.append(resp_q.get(timeout=120))
        assert h.event.wait(timeout=60) and h.error is None and eng.last_reload_ms > 0
    finally:
        req_q.put(None)
        eng.join(timeout=120)
    model = jax_get_model(jax_cfg)
    for r, weights in zip(got, (old, new)):
        want = np.asarray(model.apply(jax.tree_util.tree_map(jax.numpy.asarray, weights),
                                      JaxBatch(dense=dense, indices=idx)), np.float32)
        assert r.error_code == 0
        np.testing.assert_allclose(r.scores, want, rtol=RTOL, atol=ATOL)
    if hot_ids is not None:
        assert np.array_equal(np.asarray(eng._hotcold.hot_ids), hot_ids)
        tables = eng.params["tables"]
        rows = tables if not isinstance(tables, dict) else (
            tables["qrows"] if "qrows" in tables else tables["q"])
        assert torch.equal(eng.params["hot_table"], rows[torch.as_tensor(hot_ids)])


def test_engine_reload_failure_keeps_serving_and_newest_wins(tmp_path):
    """A missing checkpoint fails its handle and the old params serve on; a
    newer request supersedes a pending one, whose handle fails at once."""
    cfg = zoo.get_config("ncf", table_scale=PARITY_SCALE)
    scfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,), max_mini_batch_size=8)
    qs = [queue.Queue() for _ in range(3)]
    eng = engine.ComputeEngine(0, cfg, scfg, *qs, device="cpu")
    first = eng.request_reload(str(tmp_path / "a"))
    second = eng.request_reload(str(tmp_path / "missing"))
    assert first.event.is_set() and "superseded" in str(first.error)
    eng.start()
    assert not isinstance(qs[2].get(timeout=300), Exception)
    try:
        assert second.event.wait(timeout=30)  # the idle engine applies it within 0.5 s
        assert isinstance(second.error, FileNotFoundError) and eng.last_reload_ms is None
        qs[0].put(packets.ServiceRequest(batch_id=0, batch_size=4, arrival_time=time.time()))
        assert qs[1].get(timeout=60).error_code == 0
    finally:
        qs[0].put(None)
        eng.join(timeout=60)


# ------------------------------------------------------------ run_serving


def _serving_case(case):
    """(model, ServingConfig kwargs, latency models) of
    tests/test_serving.py:186-306."""
    if case == "sim":
        return dict(num_batches=40, nepochs=2, inference_engines=2, engine_backend="sim",
                    avg_arrival_rate_ms=1.0, batch_size_distribution="fixed",
                    avg_mini_batch_size=64, max_mini_batch_size=256, sub_task_batch_size=32,
                    req_granularity=8, seed=1), ([1, 64, 256], [0.2, 0.5, 1.0]), None
    if case == "accel":
        return dict(num_batches=30, nepochs=1, inference_engines=1, engine_backend="sim",
                    avg_arrival_rate_ms=1.0, batch_size_distribution="normal",
                    avg_mini_batch_size=100, var_mini_batch_size=60, max_mini_batch_size=512,
                    sub_task_batch_size=64, req_granularity=8, seed=3, model_accel=True,
                    accel_request_size_thres=128), ([1, 512], [0.2, 0.5]), ([1, 512], [0.05, 0.1])
    if case == "compute_cpu":
        return dict(num_batches=16, nepochs=1, inference_engines=1, engine_backend="cpu",
                    avg_arrival_rate_ms=0.5, batch_size_distribution="fixed",
                    avg_mini_batch_size=24, max_mini_batch_size=64, batch_buckets=(8, 16, 32, 64),
                    sub_task_batch_size=16, req_granularity=4, seed=5), None, None
    return dict(num_batches=20, nepochs=1, inference_engines=1, engine_backend="cpu",
                avg_arrival_rate_ms=0.1, batch_size_distribution="fixed",
                avg_mini_batch_size=24, max_mini_batch_size=64, batch_buckets=(8, 16, 32, 64),
                sub_task_batch_size=8, req_granularity=4, seed=9, coalesce_requests=True,
                max_coalesce=4), None, None


COUNTS = ("cpu_requests", "cpu_sub_requests", "accel_requests", "num_responses",
          "error_responses", "optimal_sub_batch", "optimal_accel_thres")


@pytest.mark.parametrize("case", ["sim", "accel", "compute_cpu", "coalescing"])
def test_run_serving_counts_equal_jax(case):
    """End-to-end sim, sim with the accelerator offload, a compute engine on
    the CPU, and coalescing: the same counts as the JAX package's run."""
    kw, lm, accel_lm = _serving_case(case)
    port_cfg, jax_cfg = _configs("ncf", SCALE)
    got = serving.run_serving(
        port_cfg, ServingConfig(**kw), settle_s=0.01,
        latency_model=lm and LatencyModel(*lm), accel_latency_model=accel_lm and LatencyModel(*accel_lm))
    want = jax_orch.run_serving(
        jax_cfg, JaxServingConfig(**kw), settle_s=0.01,
        latency_model=lm and JaxLatencyModel(*lm),
        accel_latency_model=accel_lm and JaxLatencyModel(*accel_lm))
    assert {k: getattr(got, k) for k in COUNTS} == {k: getattr(want, k) for k in COUNTS}
    assert got.num_responses == got.cpu_sub_requests + got.accel_requests
    assert got.measured_qps > 0 and np.isfinite(got.p95_ms)
    want_fields = [f.name for f in dataclasses.fields(jax_orch.ServingResult)]
    port_fields = [f.name for f in dataclasses.fields(orchestrator.ServingResult)]
    assert port_fields == want_fields + ["bucket_counts", "warmup_executions",
                                         "pacing_error_mean_ms", "pacing_error_p99_ms",
                                         "engine_errors"]
    assert got.engine_errors == []
    if kw["engine_backend"] == "cpu":
        assert got.warmup_executions == len(kw["batch_buckets"])
        assert sum(got.bucket_counts.values()) == got.executions - got.warmup_executions > 0


def test_watchdog_aborts_on_dead_engine_like_jax(monkeypatch):
    """An engine that exits without its done-sentinel: both packages raise
    after the watchdog period instead of hanging."""
    def broken_run(self):
        self.ready_q.put(self.engine_id)
        self.request_q.get()  # take one request, then die silently

    kw = dict(num_batches=4, nepochs=1, inference_engines=1, engine_backend="sim",
              avg_arrival_rate_ms=0.5, batch_size_distribution="fixed",
              avg_mini_batch_size=8, max_mini_batch_size=16, sub_task_batch_size=8,
              req_granularity=2, seed=2)
    for eng_mod, run, cfg_cls, lm_cls, cfg in (
            (engine, serving.run_serving, ServingConfig, LatencyModel,
             zoo.get_config("ncf", table_scale=SCALE)),
            (jax_engine, jax_orch.run_serving, JaxServingConfig, JaxLatencyModel,
             jax_zoo.get_config("ncf", table_scale=SCALE))):
        monkeypatch.setattr(eng_mod.SimEngine, "run", broken_run)
        with pytest.raises(RuntimeError, match="serving stalled"):
            run(cfg, cfg_cls(**kw), latency_model=lm_cls([1, 16], [0.1, 0.2]),
                settle_s=0.01, watchdog_s=0.3)


def test_engine_failure_mid_run_is_reported(monkeypatch):
    """A model execution that raises after warm-up (as a kernel that fails
    to launch would): the engine drops its queue, as the JAX engine does,
    but the result names the failure and ``main.py --queue`` raises instead
    of printing latencies."""
    from deeprecsys_tpu_torch.main import main

    dispatch = engine.ComputeEngine._dispatch

    def failing_dispatch(self, host, bucket, slot, split=None):
        if self.warmup_executions >= len(self.buckets):
            raise RuntimeError("drs_embedding_bag failed to launch")
        return dispatch(self, host, bucket, slot, split)

    monkeypatch.setattr(engine.ComputeEngine, "_dispatch", failing_dispatch)
    kw = dict(num_batches=6, engine_backend="cpu", batch_buckets=(8,), max_mini_batch_size=8,
              sub_task_batch_size=8, avg_mini_batch_size=8, avg_arrival_rate_ms=0.5)
    res = serving.run_serving(zoo.get_config("ncf", table_scale=SCALE), ServingConfig(**kw),
                              settle_s=0.01)
    assert res.num_responses < res.cpu_sub_requests and res.error_responses == 0
    assert len(res.engine_errors) == 1 and "failed to launch" in res.engine_errors[0]
    with pytest.raises(RuntimeError, match="engine.*failed during the run"):
        main(["--model", "ncf", "--table_scale", str(SCALE), "--queue", "--engine_backend",
              "cpu", "--num_batches", "6", "--avg_mini_batch_size", "8",
              "--sub_task_batch_size", "8", "--avg_arrival_rate", "0.5"])


def test_scheduler_tunes_in_sim_loop_like_jax():
    """tune_batch_qps end to end: both hill climbers converge on a
    sub-batch config and serve after it. (The pick depends on timing.)"""
    kw = dict(num_batches=64, nepochs=1, inference_engines=2, engine_backend="sim",
              avg_arrival_rate_ms=1.0, batch_size_distribution="fixed",
              avg_mini_batch_size=128, max_mini_batch_size=256, sub_task_batch_size=64,
              req_granularity=8, seed=7, tune_batch_qps=True, batch_configs=(32, 64, 128),
              arr_steps=5, sched_timeout=4, target_latency_ms=5.0, min_arr_range=0.5,
              max_arr_range=8.0)
    ladder = ([1, 32, 256], [0.1, 0.3, 1.2])
    got = serving.run_serving(zoo.get_config("ncf", table_scale=SCALE), ServingConfig(**kw),
                              latency_model=LatencyModel(*ladder), settle_s=0.01)
    want = jax_orch.run_serving(jax_zoo.get_config("ncf", table_scale=SCALE),
                                JaxServingConfig(**kw), latency_model=JaxLatencyModel(*ladder),
                                settle_s=0.01)
    for res in (got, want):
        assert res.optimal_sub_batch in (32, 64, 128) and res.num_responses > 0
        assert res.error_responses == 0


# ------------------------------------------------------------ hot/cold engines
# JAX tests/test_serving.py's single-device hot/cold engine cases, driven
# with payload requests (the port has no HTTP ingress): one request at a
# time, each answered before the next, as ServingServer.predict does.


class _Predictor:
    """One started ComputeEngine (cpu) answering payload requests one at a
    time."""

    def __init__(self, model_cfg, scfg, **kw):
        self.cfg = model_cfg
        self.req_q, self.resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
        self.engine = engine.ComputeEngine(0, model_cfg, scfg, self.req_q, self.resp_q,
                                           ready_q, device="cpu", **kw)
        self.engine.start()
        ready = ready_q.get(timeout=300)
        assert not isinstance(ready, Exception), ready
        self.n = 0

    def predict(self, indices, dense=None, mask=None) -> np.ndarray:
        indices = np.asarray(indices, dtype=np.int32)
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


def _direct_scores(eng, indices, dense=None, mask=None) -> np.ndarray:
    """The direct model on the engine's live params (its hot table dropped)."""
    from deeprecsys_tpu_torch.models import get_model

    direct = get_model(eng.model_cfg.replace(embedding_impl="xla"), "cpu")
    base = {k: v for k, v in eng.params.items() if k != "hot_table"}
    batch = Batch(dense=dense, indices=np.asarray(indices, dtype=np.int32), mask=mask)
    with torch.inference_mode():
        return direct.apply(base, batch.to("cpu")).float().numpy()


@pytest.mark.parametrize("quant", ["none", "int8", "int8_rowwise"])
def test_hotcold_engine_payload_scores_equal_jax(quant):
    """Payload requests through the port's and the JAX package's hot/cold
    engines (cpu) on the same weights: the same hot set and coverage, the
    same scores (f32), and the port's equal to its direct model on the same
    rows (JAX tests/test_serving.py:554, :922, :1792). int8 with
    hot_set_rows=0 sizes the set by the memory budget."""
    rows_kw = {"hot_set_rows": 0 if quant == "int8" else 32}
    port_cfg = zoo.get_config("ncf", table_scale=PARITY_SCALE, table_quant=quant,
                              embedding_impl="hotcold", **rows_kw)
    jax_cfg = jax_zoo.get_config("ncf", table_scale=PARITY_SCALE, table_quant=quant,
                                 embedding_impl="hotcold", **rows_kw)
    p1, p2 = _payload_rows(port_cfg, 8, 11), _payload_rows(port_cfg, 5, 12)

    def requests(req, batch):
        return [req(batch_id=i, batch_size=len(p[1]), arrival_time=1.0,
                    payload=batch(dense=p[0], indices=p[1])) for i, p in enumerate((p1, p2))]

    np_params = bridge.init_numpy(port_cfg, 5)
    scfg = dict(engine_backend="cpu", batch_buckets=(8,), max_mini_batch_size=8)
    port, got = _run_engine(engine.ComputeEngine, port_cfg, ServingConfig(**scfg),
                            requests(packets.ServiceRequest, Batch), device="cpu",
                            params=bridge.params_from_numpy(np_params, port_cfg, "cpu"))
    jx, want = _run_engine(jax_engine.ComputeEngine, jax_cfg, JaxServingConfig(**scfg),
                           requests(jax_packets.ServiceRequest, JaxBatch),
                           device=jax.devices("cpu")[0], params=np_params)
    np.testing.assert_array_equal(port._hotcold.hot_ids, jx._hotcold.hot_ids)
    assert port.hot_coverage == jx.hot_coverage
    for i, p in enumerate((p1, p2)):
        assert got[i].error_code == want[i].error_code == 0
        np.testing.assert_allclose(got[i].scores, want[i].scores, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(got[i].scores, _direct_scores(port, p[1], p[0]),
                                   rtol=1e-5, atol=1e-6)


def test_engine_auto_embedding_impl_picks_by_coverage():
    """JAX tests/test_serving.py:581, :1162: auto samples the engine's own
    stream (out of sample) and splits iff the coverage reaches
    hotcold_min_hit; the size floor declines unsampled; "hotcold" splits
    regardless. The coverage is the JAX package's on the same stream."""
    from deeprecsys_tpu.models.hotcold import hot_ids_and_coverage_from_generator as jax_cov

    def run(**kw):
        cfg = zoo.get_config("rm1", table_scale=PARITY_SCALE).replace(**kw)
        scfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,), max_mini_batch_size=8)
        eng, got = _run_engine(engine.ComputeEngine, cfg, scfg, [
            packets.ServiceRequest(batch_id=0, batch_size=5, arrival_time=time.time())],
            device="cpu")
        assert got[0].batch_size == 5 and got[0].error_code == 0
        return eng

    eng = run(embedding_impl="auto", hotcold_min_table_mb=0)
    assert eng._hotcold is not None and eng.hot_coverage > 0.9
    jcfg = jax_zoo.get_config("rm1", table_scale=PARITY_SCALE)
    assert eng.hot_coverage == jax_cov(jcfg, seed=eng.seed + 31, hot_rows=131072,
                                       n_batches=8)[1]
    eng = run(embedding_impl="auto")
    assert eng._hotcold is None and eng.hot_coverage is None
    eng = run(embedding_impl="auto", hot_set_rows=64, hotcold_min_table_mb=0)
    assert eng._hotcold is None and eng.hot_coverage < 0.5
    assert eng.warmup_executions == 1  # the direct lookup only
    eng = run(embedding_impl="hotcold", hot_set_rows=64)
    assert eng._hotcold is not None


def _ncf_refresh(scan_async=True, **kw):
    cfg = zoo.get_config("ncf", table_scale=500).replace(embedding_impl="hotcold",
                                                          hot_set_rows=64)
    scfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,), max_mini_batch_size=8,
                         hotcold_refresh_window=8, hotcold_scan_async=scan_async, **kw)
    return _Predictor(cfg, scfg)


def _pool_batch(cfg, pools, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.choice(pools[t], size=(8, cfg.num_indices_per_lookup))
                     for t in range(cfg.num_tables)], axis=1).astype(np.int32)


def _uniform_batch(cfg, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, r, size=(8, cfg.num_indices_per_lookup))
                     for r in cfg.scaled_rows], axis=1).astype(np.int32)


def test_hotcold_upgrade_without_degradation():
    """JAX tests/test_serving.py:638: a warm-up set that was never good
    (uniform) under concentrated traffic never trips the drop rule, but the
    engine upgrades to the live head; a good set stops the scans."""
    srv = _ncf_refresh(hotcold_refresh_interval=4)
    try:
        eng = srv.engine
        assert eng._hotcold is not None and eng.hot_coverage < 0.75
        pools = [[3, 7, 11, 19], [5, 9, 13, 21], [2, 4, 6, 8], [1, 10, 12, 14]]
        for i in range(8):
            srv.predict(_pool_batch(srv.cfg, pools, i))
        assert eng.hot_refreshes >= 1, "upgrade never installed"
        assert eng.hot_coverage > 0.9 and eng._hotcold_active
        for i in range(8, 16):
            srv.predict(_pool_batch(srv.cfg, pools, i))
        assert eng.hot_refreshes == 1 and eng._upgrade_backoff == 0
    finally:
        srv.stop()


def test_hotcold_upgrade_scan_backs_off_on_steady_mediocre_stream():
    """JAX tests/test_serving.py:686: failed upgrade scans grow an
    exponential skip count, with no state change."""
    srv = _ncf_refresh(hotcold_refresh_interval=2)
    try:
        eng = srv.engine
        assert eng.hot_coverage < 0.75
        for i in range(12):
            srv.predict(_uniform_batch(srv.cfg, i))
        assert eng.hot_refreshes == 0 and eng._hotcold_active
        assert eng._upgrade_backoff >= 2, "scan never backed off"
    finally:
        srv.stop()


@pytest.mark.parametrize("scan_async", [True, False])
def test_hotcold_adaptive_refresh_recovers_from_drift(scan_async):
    """JAX tests/test_serving.py:727: a popular head moved outside the hot
    set is refreshed in (the swap needs no new shapes); a headless stream
    disables the split (direct lookup); a returning head re-enables it.
    Scores equal the direct model on the live params throughout; async and
    sync scans (a tiny scan budget forces the row-stride subsample)."""
    srv = _ncf_refresh(scan_async=scan_async, hotcold_refresh_interval=4,
                       hotcold_refresh_margin=0.05, hotcold_scan_budget=200)
    try:
        eng, cfg = srv.engine, srv.cfg
        assert eng._hotcold is not None and eng.hot_coverage > 0.05
        hot = set(int(i) for i in eng._hotcold.hot_ids)
        pools = []
        for off, r in zip(cfg.table_offsets, cfg.scaled_rows):
            cold = [i for i in range(r) if int(off) + i not in hot][:6]
            assert len(cold) == 6
            pools.append(cold)
        for i in range(8):
            srv.predict(_pool_batch(cfg, pools, i))
            if eng.hot_refreshes:
                break
        assert eng.hot_refreshes == 1 and eng.hot_coverage > 0.9
        hot_table = eng.params["hot_table"]
        for i in range(8, 12):
            srv.predict(_pool_batch(cfg, pools, i))
        assert eng.live_hot_coverage > 0.9 and eng.hot_refreshes == 1
        idx = _pool_batch(cfg, pools, 99)
        np.testing.assert_allclose(srv.predict(idx), _direct_scores(eng, idx),
                                   rtol=1e-5, atol=1e-6)
        for i in range(32):  # the head is lost: disable
            srv.predict(_uniform_batch(cfg, 1000 + i))
            if not eng._hotcold_active:
                break
        assert not eng._hotcold_active, "a uniform stream must disable the split"
        idx = _uniform_batch(cfg, 99)
        np.testing.assert_allclose(srv.predict(idx), _direct_scores(eng, idx),
                                   rtol=1e-5, atol=1e-6)
        for i in range(64):  # the head returns: re-enable
            srv.predict(_pool_batch(cfg, pools, 200 + i))
            if eng._hotcold_active:
                break
        assert eng._hotcold_active, "a returning head must re-enable the split"
        # A swap of the same size writes the new rows into the table the
        # engine's programs read (a card's graphs hold its address).
        assert eng.params["hot_table"] is hot_table
        hot_ids = torch.as_tensor(np.asarray(eng._hotcold.hot_ids, dtype=np.int64))
        assert torch.equal(hot_table, eng.params["tables"][hot_ids])
        idx = _pool_batch(cfg, pools, 999)
        np.testing.assert_allclose(srv.predict(idx), _direct_scores(eng, idx),
                                   rtol=1e-5, atol=1e-6)
    finally:
        srv.stop()


def test_hotcold_refresh_tracks_ragged_streams_by_valid_slots():
    """JAX tests/test_serving.py:1838: on a masked stream the tracker counts
    valid slots only and the refreshed set is the valid head, not the
    padded slots' index-0 filler; scores equal the direct masked forward."""
    cfg = zoo.get_config("rm1", table_scale=500).replace(embedding_impl="hotcold",
                                                          hot_set_rows=8)
    scfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,), max_mini_batch_size=8,
                         accept_ragged=True, hotcold_refresh_interval=4,
                         hotcold_refresh_window=8, hotcold_refresh_margin=0.05)
    srv = _Predictor(cfg, scfg)
    try:
        eng = srv.engine
        offsets = np.asarray(cfg.table_offsets, dtype=np.int64)
        rows = np.asarray(cfg.scaled_rows)
        T, L, B = cfg.num_tables, cfg.num_indices_per_lookup, 8
        dense = np.random.default_rng(3).random((B, cfg.dense_dim)).astype(np.float32)
        hot = np.asarray(eng._hotcold.hot_ids)

        def batch(per_table_ids):
            idx = np.zeros((B, T, L), dtype=np.int32)
            mask = np.zeros((B, T, L), dtype=bool)
            for t, i in enumerate(per_table_ids):
                if i is not None:
                    idx[:, t, 0] = i
                    mask[:, t, 0] = True
            return idx, mask

        hot_local = [None] * T
        for h in hot:
            t = int(np.searchsorted(offsets, h, side="right") - 1)
            hot_local[t] = int(h - offsets[t])
        assert any(i is not None for i in hot_local)
        for _ in range(4):
            srv.predict(*batch(hot_local)[:1], dense=dense, mask=batch(hot_local)[1])
        assert eng.live_hot_coverage > 0.9, "padded slots leaked into the denominator"
        assert eng.hot_refreshes == 0 and eng._hotcold_active
        hotset = set(int(h) for h in hot)
        pool = [next(i for i in range(1, int(rows[t])) if int(offsets[t]) + i not in hotset)
                for t in range(T)]
        fused_pool = {int(offsets[t]) + pool[t] for t in range(T)}
        idx, mask = batch(pool)
        for _ in range(24):
            srv.predict(idx, dense=dense, mask=mask)
            if eng.hot_refreshes >= 1:
                break
        assert eng.hot_refreshes >= 1 and eng._hotcold_active
        assert len(set(int(h) for h in eng._hotcold.hot_ids) & fused_pool) >= 6
        n_ref = eng.hot_refreshes
        for _ in range(4):
            srv.predict(idx, dense=dense, mask=mask)
        assert eng.live_hot_coverage > 0.9 and eng.hot_refreshes == n_ref
        np.testing.assert_allclose(srv.predict(idx, dense=dense, mask=mask),
                                   _direct_scores(eng, idx, dense, mask), rtol=1e-5, atol=1e-6)
    finally:
        srv.stop()
