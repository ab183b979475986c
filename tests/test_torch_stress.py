"""Concurrency stress on the port's serving fabric, held to the JAX
package's own numbers: the twins of ``tests/test_stress.py`` (a flood of
sim engines with offload and coalescing, cpu-mp ring accounting, an HTTP
ingress soak) and ``tests/test_process_tuning.py`` (DeepRecSched tuning
over cpu-mp engine processes). Every emitted sub-request must produce
exactly one response: no duplicates, no losses."""

import json
import queue
import threading
import urllib.request

import numpy as np
import pytest

from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu.config import ServingConfig as JaxServingConfig
from deeprecsys_tpu.serving import run_serving as jax_run_serving
from deeprecsys_tpu.serving.latency_model import LatencyModel as JaxLatencyModel
from deeprecsys_tpu_torch import ServingConfig, zoo
from deeprecsys_tpu_torch import runtime
from deeprecsys_tpu_torch.runtime import native
from deeprecsys_tpu_torch.runtime.shm_queue import ShmRingQueue
from deeprecsys_tpu_torch.serving import load_generator, run_serving
from deeprecsys_tpu_torch.serving.ingress import HttpIngress, ServingServer
from deeprecsys_tpu_torch.serving.latency_model import LatencyModel

needs_native = pytest.mark.skipif(not native.native_available(),
                                  reason="native runtime not built (no g++)")

FLOOD = dict(num_batches=200, nepochs=2, inference_engines=8, engine_backend="sim",
             avg_arrival_rate_ms=0.2, batch_size_distribution="lognormal",
             avg_mini_batch_size=4.8, var_mini_batch_size=0.6, max_mini_batch_size=512,
             sub_task_batch_size=48, req_granularity=16, seed=31, model_accel=True,
             accel_request_size_thres=256)
FLOOD_COUNTS = ("cpu_requests", "accel_requests", "cpu_sub_requests", "num_responses")
RING = dict(num_batches=60, nepochs=1, inference_engines=4, engine_backend="cpu-mp",
            avg_arrival_rate_ms=0.2, batch_size_distribution="fixed", avg_mini_batch_size=40,
            max_mini_batch_size=64, batch_buckets=(16, 32, 64), sub_task_batch_size=16,
            req_granularity=8, seed=37)
TUNING = dict(num_batches=48, nepochs=1, inference_engines=2, engine_backend="cpu-mp",
              avg_arrival_rate_ms=1.0, batch_size_distribution="fixed", avg_mini_batch_size=48,
              max_mini_batch_size=64, batch_buckets=(16, 32, 64), sub_task_batch_size=16,
              req_granularity=4, seed=5, tune_batch_qps=True, batch_configs=(16, 32, 64),
              arr_steps=4, sched_timeout=3, target_latency_ms=50.0, min_arr_range=0.5,
              max_arr_range=4.0)


def test_stress_many_engines_offload_and_coalescing_equals_jax():
    """8 sim engines and the offload engine under a flood: the port's load
    generator replays the JAX stream for the seed, so the four counts are
    the JAX run's, and they add up to its 400 queries."""
    lm, accel_lm = ([1, 512], [0.05, 0.4]), ([1, 512], [0.02, 0.1])
    got = run_serving(zoo.get_config("ncf", table_scale=5000), ServingConfig(**FLOOD),
                      latency_model=LatencyModel(*lm), accel_latency_model=LatencyModel(*accel_lm),
                      settle_s=0.01)
    want = jax_run_serving(jax_zoo.get_config("ncf", table_scale=5000), JaxServingConfig(**FLOOD),
                           latency_model=JaxLatencyModel(*lm),
                           accel_latency_model=JaxLatencyModel(*accel_lm), settle_s=0.01)
    assert {k: getattr(got, k) for k in FLOOD_COUNTS} == {k: getattr(want, k) for k in FLOOD_COUNTS}
    assert got.cpu_requests + got.accel_requests == 400
    assert got.num_responses == got.cpu_sub_requests + got.accel_requests
    assert got.accel_requests > 0 and got.cpu_requests > 0
    assert np.isfinite(got.p99_ms) and got.engine_errors == [] and got.error_responses == 0


@needs_native
def test_stress_multiprocess_ring_accounting():
    """4 cpu-mp engine processes over the shared-memory rings: 60 queries
    of 40 rows, each split [16, 16, 8], every sub-request answered once."""
    res = run_serving(zoo.get_config("ncf", table_scale=5000), ServingConfig(**RING),
                      settle_s=0.01)
    assert res.cpu_requests == 60
    assert res.cpu_sub_requests == 180
    assert res.num_responses == 180
    assert res.engine_errors == [] and res.error_responses == 0


def test_stress_ingress_soak():
    """16 client threads x 20 /v1/infer queries through the HTTP ingress
    over 4 sim engines: every query answered, the stats consistent, no
    pending query left; the ingress and the server stopped in any case."""
    cfg = ServingConfig(engine_backend="sim", inference_engines=4, sub_task_batch_size=32,
                        max_mini_batch_size=128)
    server = ServingServer(zoo.get_config("ncf", table_scale=2000), cfg,
                           latency_model=LatencyModel([1, 128], [0.1, 0.4]))
    ing = None
    try:
        server.start(timeout=60)
        ing = HttpIngress(server)
        ing.start()
        host, port = ing.address
        url = f"http://{host}:{port}/v1/infer"
        n_clients, per_client = 16, 20
        errors = []

        def client(cid):
            rng = np.random.default_rng(cid)
            for i in range(per_client):
                size = int(rng.integers(1, 128))
                req = urllib.request.Request(url, data=json.dumps({"batch_size": size}).encode())
                try:
                    with urllib.request.urlopen(req, timeout=60) as r:
                        out = json.loads(r.read())
                        assert out["batch_size"] == size
                except Exception as e:  # noqa: BLE001 - reported below
                    errors.append((cid, i, repr(e)))

        threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
        stats = server.stats()
        assert stats["completed"] == n_clients * per_client
        assert stats["p99_ms"] > 0
        assert not server._pending  # nothing leaked
    finally:
        if ing is not None:
            ing.stop()  # the listener and the server's engine pool
        server.stop()  # idempotent; the only stop when the ingress never started


@needs_native
def test_tuning_with_cpu_mp_engines(monkeypatch):
    """DeepRecSched tuning over cpu-mp engine processes: the scheduler's
    drain-and-settle empties the shared-memory rings, whose ``Empty``
    subclasses ``queue.Empty``, which the drain catches."""
    assert issubclass(runtime.Empty, queue.Empty)
    drained = []
    orig = load_generator.LoadGenerator._drain_and_settle

    def drain(self):
        drained.append(type(self.request_q))
        return orig(self)

    monkeypatch.setattr(load_generator.LoadGenerator, "_drain_and_settle", drain)
    res = run_serving(zoo.get_config("ncf", table_scale=5000), ServingConfig(**TUNING),
                      settle_s=0.01)
    assert res.optimal_sub_batch in (16, 32, 64)
    assert res.num_responses > 0 and res.engine_errors == []
    assert drained and set(drained) == {ShmRingQueue}
