"""The port's cpu-mp engine processes on the CPU (JAX
``tests/test_process_engines.py``; reference ``DeepRecSys.py:62-78``): an
end-to-end run, a set-up failure reported through the ready ring, a
process killed mid-run, and the in-parent offload engine beside the
processes. Every spawned process imports torch, so the runs are few and
small, and every wait has its own limit."""

import threading

import numpy as np
import pytest

from deeprecsys_tpu.config import ServingConfig as JaxServingConfig
from deeprecsys_tpu.serving import load_generator as jax_lg
from deeprecsys_tpu_torch import ServingConfig, bridge, zoo
from deeprecsys_tpu_torch.runtime import native
from deeprecsys_tpu_torch.serving import process_engine
from deeprecsys_tpu_torch.serving.ingress import ServingServer
from deeprecsys_tpu_torch.serving.orchestrator import run_serving
from deeprecsys_tpu_torch.utils.checkpoint import save_params

pytestmark = pytest.mark.skipif(not native.native_available(),
                                reason="native runtime not built (no g++)")

E2E = dict(num_batches=12, nepochs=1, inference_engines=2, avg_arrival_rate_ms=1.0,
           batch_size_distribution="fixed", avg_mini_batch_size=24, max_mini_batch_size=64,
           batch_buckets=(8, 16, 32, 64), sub_task_batch_size=16, req_granularity=4, seed=11)


def _jax_counts(kw: dict) -> tuple[int, int]:
    """Queries and sub-requests of the JAX package's load generator for
    the same config (its sizes and split, without engines)."""
    cfg = JaxServingConfig(**kw)
    sizes = jax_lg.model_batch_sizes(cfg, np.random.default_rng(cfg.seed))
    subs = sum(len(jax_lg.partition_query(int(n), cfg.sub_task_batch_size)) for n in sizes)
    return len(sizes), subs


def test_end_to_end_multiprocess_engines():
    res = run_serving(zoo.get_config("ncf", table_scale=5000),
                      ServingConfig(engine_backend="cpu-mp", **E2E), settle_s=0.01,
                      watchdog_s=60.0)
    queries, subs = _jax_counts(E2E)
    assert (res.cpu_requests, res.cpu_sub_requests) == (queries, subs) == (12, 24)
    assert res.num_responses == 24 and res.error_responses == 0 and not res.engine_errors
    assert res.measured_qps > 0 and np.isfinite(res.p95_ms)
    assert res.executions == 0  # the processes' executions stay in the processes


def test_setup_failure_reported_through_the_ready_ring(tmp_path):
    """A process that cannot load its checkpoint reports on the ready ring
    (start raises, never serves random weights); a reload of the dead
    process resolves at once; the segments are unlinked at stop."""
    cfg = ServingConfig(engine_backend="cpu-mp", inference_engines=1, sub_task_batch_size=8,
                        max_mini_batch_size=16, batch_buckets=(8, 16))
    server = ServingServer(zoo.get_config("ncf", table_scale=2000), cfg,
                           checkpoint_path=str(tmp_path / "nope.ckpt"))
    names = [server.request_q.name, server.response_q.name, server._arena.name]
    try:
        with pytest.raises(RuntimeError, match="failed during"):
            server.start(timeout=120)
        for p in server.procs:
            p.join(timeout=60)
            assert not p.is_alive()
        (h,) = server.reload(str(tmp_path / "whatever.ckpt"))
        assert h.event.is_set() and "not alive" in str(h.error)
    finally:
        server.stop()
    from multiprocessing import shared_memory

    for name in names:
        with pytest.raises(FileNotFoundError):
            shared_memory.SharedMemory(name=name)


def test_engine_child_setup_failure_returns_instead_of_raising():
    """A ring that cannot be attached is reported, not raised (a raising
    process would leave the parent's barrier waiting)."""
    cfg = zoo.get_config("ncf", table_scale=5000)
    scfg = ServingConfig(engine_backend="cpu", batch_buckets=(8,), max_mini_batch_size=8)
    process_engine._engine_child(0, cfg, scfg, "drs_no_such_req", "drs_no_such_resp",
                                 "drs_no_such_rdy")


def test_ready_protocol_carries_engine_id_on_failure():
    class FakeRing:
        def put(self, pkt):
            self.pkt = pkt

        def get(self, timeout=None):
            return self.pkt

    ring = FakeRing()
    process_engine._ReadySender(ring, engine_id=5).put(RuntimeError("boom"))
    got = process_engine._ReadyReceiver(ring).get()
    assert isinstance(got, RuntimeError) and "engine process 5" in str(got)
    process_engine._ReadySender(ring, engine_id=5).put(5)
    assert process_engine._ReadyReceiver(ring).get() == 5


KILL_AFTER = 8


def test_one_engine_killed_after_responses_completes_degraded(monkeypatch):
    """Process 0 is killed once it has answered KILL_AFTER responses, as
    read off the response ring (no wall-clock timer): the survivor takes the
    shared queue, the run completes degraded instead of hanging, and only
    the requests the dead process held are lost."""
    real = process_engine.spawn_process_engines
    killed = threading.Event()

    def spawn_and_kill(model_cfg, cfg, **kw):
        request_q, response_q, ready, procs, cleanup, controls, arena = real(model_cfg, cfg, **kw)

        class Watch:
            answered = 0

            def get(self, timeout=None):
                r = response_q.get(timeout=timeout)
                if r is not None and r.consumer_id == 0 and not killed.is_set():
                    Watch.answered += 1
                    if Watch.answered == KILL_AFTER:
                        procs[0].kill()
                        procs[0].join(timeout=30)
                        killed.set()
                return r

        return request_q, Watch(), ready, procs, cleanup, controls, arena

    monkeypatch.setattr(process_engine, "spawn_process_engines", spawn_and_kill)
    cfg = ServingConfig(num_batches=80, inference_engines=2, engine_backend="cpu-mp",
                        avg_arrival_rate_ms=10.0, batch_size_distribution="fixed",
                        avg_mini_batch_size=8, max_mini_batch_size=16, batch_buckets=(8, 16),
                        sub_task_batch_size=8, req_granularity=8)
    holder = {}
    t = threading.Thread(target=lambda: holder.update(res=run_serving(
        zoo.get_config("ncf", table_scale=2000), cfg, settle_s=0.01, watchdog_s=3.0)),
        daemon=True)
    t.start()
    t.join(timeout=180)
    assert not t.is_alive(), "the degraded run hung instead of completing"
    res = holder["res"]
    assert killed.is_set()
    # The dead process held at most the requests it had taken: the one it
    # was assembling and its in-flight executions.
    assert 80 - 5 <= res.num_responses <= 80, res.num_responses
    assert any("without their done sentinel" in e for e in res.engine_errors)


def test_build_engine_pool_puts_the_offload_engine_on_the_card():
    """cpu-mp's in-parent offload engine takes ``accel_device``, the card
    by default: without one it raises, never moves to the CPU."""
    import queue

    import torch

    from deeprecsys_tpu_torch.serving.engine import build_engine_pool

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = ServingConfig(engine_backend="cpu-mp", inference_engines=0, model_accel=True)
    qs = [queue.Queue() for _ in range(4)]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        build_engine_pool(zoo.get_config("ncf", table_scale=2000), cfg, *qs)
    engines, total = build_engine_pool(zoo.get_config("ncf", table_scale=2000), cfg, *qs,
                                       id_base=3, accel_device="cpu")
    assert total == 1 and engines[0].engine_id == 3 and engines[0].device.type == "cpu"


def test_cpu_mp_with_model_accel_on_the_cpu(tmp_path):
    """The reference's canonical topology: an engine process plus the
    offload engine in this process (``accel_device="cpu"`` here), both from
    one checkpoint; big queries go whole to the offload engine."""
    cfg = zoo.get_config("ncf", table_scale=2000)
    save_params(tmp_path / "ckpt", bridge.init_numpy(cfg, 3))
    kw = dict(num_batches=24, inference_engines=1, engine_backend="cpu-mp",
              avg_arrival_rate_ms=2.0, batch_size_distribution="normal",
              avg_mini_batch_size=40, var_mini_batch_size=12, max_mini_batch_size=64,
              batch_buckets=(16, 64), sub_task_batch_size=16, req_granularity=4,
              model_accel=True, accel_request_size_thres=44, seed=5)
    res = run_serving(cfg, ServingConfig(**kw), settle_s=0.01, watchdog_s=60.0,
                      checkpoint_path=str(tmp_path / "ckpt"), accel_device="cpu")
    jax_cfg = JaxServingConfig(**{**kw, "engine_backend": "cpu"})
    sizes = jax_lg.model_batch_sizes(jax_cfg, np.random.default_rng(jax_cfg.seed))
    assert res.accel_requests == int((sizes >= 44).sum()) > 0
    assert res.cpu_requests == int((sizes < 44).sum()) > 0
    assert res.num_responses == res.cpu_sub_requests + res.accel_requests
    assert res.error_responses == 0 and not res.engine_errors
    # The offload engine is the only engine in this process: its executions.
    assert sum(res.bucket_counts.values()) == res.accel_requests
    assert res.warmup_executions == 2


def test_process_engine_needs_a_checkpoint_not_a_params_tree():
    cfg = zoo.get_config("ncf", table_scale=2000)
    with pytest.raises(ValueError, match="checkpoint_path"):
        run_serving(cfg, ServingConfig(engine_backend="cpu-mp"), params={})
    with pytest.raises(ValueError, match="checkpoint_path"):
        ServingServer(cfg, ServingConfig(engine_backend="cpu-mp"), params={})
