"""The port's HTTP ingress on the CPU, over real sockets: the counterparts of
the JAX package's ``tests/test_ingress.py``. Scores are held to the JAX
model on the same weights (``bridge.init_numpy``, f32, rtol and atol 1e-5);
the cpu-mp cases share one server of two engine processes and an offload
engine on the CPU. Every blocking wait has its own limit."""

import json
import threading
import time
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu.config import ServingConfig as JaxServingConfig
from deeprecsys_tpu.models import get_model as jax_get_model
from deeprecsys_tpu.models.base import Batch as JaxBatch
from deeprecsys_tpu.serving import ingress as jax_ingress
from deeprecsys_tpu.serving.latency_model import LatencyModel as JaxLatencyModel
from deeprecsys_tpu_torch import ServingConfig, bridge, zoo
from deeprecsys_tpu_torch.data.ragged import pad_csr
from deeprecsys_tpu_torch.runtime import native
from deeprecsys_tpu_torch.serving.ingress import HttpIngress, ServingServer
from deeprecsys_tpu_torch.serving.latency_model import LatencyModel
from deeprecsys_tpu_torch.utils.checkpoint import save_params

RTOL = ATOL = 1e-5
TIMEOUT = 60


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return r.status, json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=TIMEOUT) as r:
        return r.status, json.loads(r.read())


def _refused(url, payload=None) -> tuple[int, str]:
    """The HTTP error code and body of a request that must fail."""
    with pytest.raises(urllib.error.HTTPError) as e:
        if payload is None:
            _get(url)
        else:
            _post(url, payload)
    return e.value.code, e.value.read().decode()


def _serve(server: ServingServer, **kw):
    server.start(timeout=300)
    ing = HttpIngress(server, **kw)
    ing.start()
    return ing, "http://%s:%s" % ing.address


def _ids(cfg, n: int, seed: int) -> np.ndarray:
    rows = np.asarray(cfg.scaled_rows, dtype=np.int64)
    rng = np.random.default_rng(seed)
    return rng.integers(0, rows[None, :, None],
                        size=(n, cfg.num_tables, cfg.num_indices_per_lookup)).astype(np.int32)


def _csr(cfg, B: int, seed: int):
    """Ragged lengths, flat values and dense features of ``B`` rows."""
    rng = np.random.default_rng(seed)
    T, L = cfg.num_tables, cfg.num_indices_per_lookup
    rows = np.asarray(cfg.scaled_rows, dtype=np.int64)
    lengths = rng.integers(0, L + 1, size=(B, T))
    values = np.concatenate([rng.integers(0, rows[t], size=int(lengths[b, t]))
                             for b in range(B) for t in range(T)]).astype(np.int64)
    dense = rng.random((B, cfg.dense_dim)).astype(np.float32) if cfg.dense_dim else None
    return lengths, values, dense


def _jax_scores(name: str, scale: int, np_params, idx, dense=None, mask=None) -> np.ndarray:
    """The JAX model's scores for the rows on the same (numpy) weights."""
    model = jax_get_model(jax_zoo.get_config(name, table_scale=scale))
    params = jax.tree_util.tree_map(jnp.asarray, np_params)
    out = model.apply(params, JaxBatch(
        dense=None if dense is None else jnp.asarray(dense),
        indices=jnp.asarray(np.asarray(idx, np.int32)),
        mask=None if mask is None else jnp.asarray(mask)))
    return np.asarray(out, np.float32)


# ----------------------------------------------------------- sim engines


def _sim_server(**kw):
    cfg = ServingConfig(engine_backend="sim", inference_engines=1, sub_task_batch_size=64,
                        max_mini_batch_size=64, **kw)
    return ServingServer(zoo.get_config("ncf", table_scale=2000), cfg,
                         latency_model=LatencyModel([1, 64], [1.0, 1.0]))


@pytest.fixture()
def ingress():
    """Two sim engines and a sim offload engine (queries of 48+ rows)."""
    cfg = ServingConfig(engine_backend="sim", inference_engines=2, sub_task_batch_size=16,
                        max_mini_batch_size=64, model_accel=True, accel_request_size_thres=48)
    server = ServingServer(zoo.get_config("ncf", table_scale=2000), cfg,
                           latency_model=LatencyModel([1, 64], [1.0, 2.0]),
                           accel_latency_model=LatencyModel([1, 64], [0.5, 0.6]))
    ing, base = _serve(server)
    yield base
    ing.stop()


def test_infer_partitions_and_rejoins(ingress):
    status, out = _post(f"{ingress}/v1/infer", {"batch_size": 40})
    assert status == 200 and out["sub_batches"] == 3 and not out["accel"]  # 16 + 16 + 8
    assert out["latency_ms"] > 0 and out["queue_wait_ms"] >= 0 and out["inference_ms"] > 0


def test_infer_routes_big_queries_to_accel(ingress):
    status, out = _post(f"{ingress}/v1/infer", {"batch_size": 50})
    assert status == 200 and out["accel"] and out["sub_batches"] == 1
    assert out["engines"] == [2]  # the offload engine's id is the last


def test_concurrent_clients_and_stats(ingress):
    results = []
    threads = [threading.Thread(target=lambda n=n: results.append(
        _post(f"{ingress}/v1/infer", {"batch_size": n}))) for n in range(8, 16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert len(results) == 8 and all(s == 200 for s, _ in results)
    assert len({r["batch_id"] for _, r in results}) == 8
    status, stats = _get(f"{ingress}/v1/stats")
    assert status == 200 and stats["completed"] >= 8 and stats["qps"] > 0
    assert stats["p95_ms"] >= stats["p50_ms"]


def test_healthz(ingress):
    status, h = _get(f"{ingress}/v1/healthz")
    assert status == 200
    assert h["status"] == "ok" and h["model"] == "ncf" and h["engines"] == 3


@pytest.mark.parametrize("path,payload,code", [
    ("/v1/infer", {"wrong_key": 1}, 400), ("/v1/infer", {"batch_size": 0}, 400),
    ("/v1/nope", {"batch_size": 1}, 404), ("/v1/unknown", None, 404)])
def test_bad_requests(ingress, path, payload, code):
    assert _refused(f"{ingress}{path}", payload)[0] == code


def test_exp_packets_excluded_from_stats(ingress):
    _, before = _get(f"{ingress}/v1/stats")
    _post(f"{ingress}/v1/infer", {"batch_size": 4, "exp": True})
    _, after = _get(f"{ingress}/v1/stats")
    assert after["completed"] == before["completed"]


def test_healthz_reports_bucket_executions_and_liveness(ingress):
    _post(f"{ingress}/v1/infer", {"batch_size": 10})
    _, h = _get(f"{ingress}/v1/healthz")
    assert h["live_engines"] == h["engines"] == 3 and h["status"] == "ok"


def test_reload_unsupported_on_sim_engines(ingress):
    assert _refused(f"{ingress}/v1/reload", {"path": "/nonexistent/x"})[0] == 501


def test_oversized_batch_rejected_not_clamped(ingress):
    code, body = _refused(f"{ingress}/v1/infer", {"batch_size": 10_000_000})
    assert code == 400 and "max_mini_batch_size" in body


def _metric_names(body: str) -> list:
    return [line.split()[2] for line in body.splitlines() if line.startswith("# TYPE")]


def test_prometheus_metrics_exposition(ingress):
    """GET /metrics: a Prometheus 0.0.4 exposition with the JAX package's
    metric names, types and help for the same server."""
    _post(f"{ingress}/v1/infer", {"batch_size": 8})
    with urllib.request.urlopen(f"{ingress}/metrics", timeout=TIMEOUT) as r:
        assert r.status == 200 and r.headers["Content-Type"].startswith("text/plain")
        body = r.read().decode()
    assert 'drs_up{model="ncf"} 1' in body and 'drs_engines_live{model="ncf"}' in body
    completed = [line for line in body.splitlines()
                 if line.startswith('drs_queries_completed_total{model="ncf"}')]
    assert int(float(completed[0].split()[-1])) >= 1
    for line in body.splitlines():
        if line and not line.startswith("#"):
            name_labels, value = line.rsplit(" ", 1)
            float(value)
            assert "{" in name_labels and name_labels.endswith("}")
    # The JAX package's exposition of the same sim server.
    jcfg = JaxServingConfig(engine_backend="sim", inference_engines=2, sub_task_batch_size=16,
                            max_mini_batch_size=64, model_accel=True,
                            accel_request_size_thres=48)
    jserver = jax_ingress.ServingServer(
        jax_zoo.get_config("ncf", table_scale=2000), jcfg,
        latency_model=JaxLatencyModel([1, 64], [1.0, 2.0]),
        accel_latency_model=JaxLatencyModel([1, 64], [0.5, 0.6]))
    jserver.start()
    try:
        jserver.submit(8)
        want = jax_ingress._prometheus({"ncf": jserver})
    finally:
        jserver.stop()
    assert _metric_names(body) == _metric_names(want)
    assert [line for line in body.splitlines() if line.startswith("#")] == \
        [line for line in want.splitlines() if line.startswith("#")]


def test_multi_model_registry():
    servers = {}
    for name in ("ncf", "rm1"):
        cfg = ServingConfig(engine_backend="sim", inference_engines=1, sub_task_batch_size=16,
                            max_mini_batch_size=32)
        servers[name] = ServingServer(zoo.get_config(name, table_scale=2000), cfg,
                                      latency_model=LatencyModel([1, 64], [1.0, 2.0]))
        servers[name].start(timeout=60)
    ing = HttpIngress(servers, default="ncf")
    ing.start()
    base = "http://%s:%s" % ing.address
    try:
        _, models = _get(f"{base}/v1/models")
        assert set(models) == {"ncf", "rm1"} and models["rm1"]["model"] == "dlrm"
        s, out = _post(f"{base}/v1/models/rm1/infer", {"batch_size": 20})
        assert s == 200 and out["sub_batches"] == 2
        s, out = _post(f"{base}/v1/infer", {"batch_size": 4})  # the default, ncf
        assert s == 200 and out["sub_batches"] == 1
        s, st = _get(f"{base}/v1/models/rm1/reload")
        assert s == 200 and st == {"scheduled": 0, "applied": 0, "failed": 0, "errors": []}
        assert _refused(f"{base}/v1/models/nope/infer", {"batch_size": 1})[0] == 404
        assert _refused(f"{base}/v1/models/nope/reload")[0] == 404
    finally:
        ing.stop()


def test_deadline_expired_504_never_dispatched():
    """A query whose deadline passes in the queue is answered 504 when an
    engine takes it, without running, and /v1/healthz counts it."""
    cfg = ServingConfig(engine_backend="sim", inference_engines=1, sub_task_batch_size=64,
                        max_mini_batch_size=64)
    server = ServingServer(zoo.get_config("ncf", table_scale=2000), cfg,
                           latency_model=LatencyModel([1, 64], [400.0, 400.0]))
    ing, base = _serve(server)
    try:
        t = threading.Thread(target=lambda: _post(f"{base}/v1/infer", {"batch_size": 8}))
        t.start()
        time.sleep(0.1)  # the blocker reaches the engine
        t0 = time.time()
        code, body = _refused(f"{base}/v1/infer", {"batch_size": 8, "deadline_ms": 50})
        assert code == 504 and "deadline" in body
        assert time.time() - t0 < 2.0  # answered at dequeue, not after a run
        t.join(timeout=TIMEOUT)
        _, h = _get(f"{base}/v1/healthz")
        assert h["expired_requests"] == 1
        status, out = _post(f"{base}/v1/infer", {"batch_size": 8, "deadline_ms": 60_000})
        assert status == 200 and out["latency_ms"] > 0
    finally:
        ing.stop()


@pytest.mark.parametrize("bad", [0, -5, "soon"])
def test_deadline_bad_values_rejected(bad):
    ing, base = _serve(_sim_server())
    try:
        assert _refused(f"{base}/v1/infer", {"batch_size": 4, "deadline_ms": bad})[0] == 400
    finally:
        ing.stop()


def test_reload_refused_on_non_loopback_bind():
    ing, _ = _serve(_sim_server(), host="0.0.0.0")
    base = f"http://127.0.0.1:{ing.address[1]}"
    try:
        code, body = _refused(f"{base}/v1/reload", {"path": "/etc/passwd"})
        assert code == 403 and "reload_root" in body
        assert _post(f"{base}/v1/infer", {"batch_size": 4})[0] == 200
    finally:
        ing.stop()


@pytest.mark.parametrize("evil", ["/etc/passwd", "{root}/../outside", "{root}suffix/x"])
def test_reload_root_restricts_paths(tmp_path, evil):
    """Paths must resolve under reload_root (after .. and prefixes); one
    inside passes the guard and then meets the sim backend's 501."""
    ing, base = _serve(_sim_server(), reload_root=str(tmp_path))
    try:
        assert _refused(f"{base}/v1/reload", {"path": evil.format(root=tmp_path)})[0] == 403
        assert _refused(f"{base}/v1/reload", {"path": str(tmp_path / "ckpt")})[0] == 501
    finally:
        ing.stop()


# ------------------------------------------------- compute engines (threads)


def _cpu_server(name: str, scale: int, seed: int, tmp_path, **kw):
    """A one-engine CPU server on ``bridge.init_numpy(cfg, seed)``'s weights
    (through a checkpoint) and those weights."""
    cfg = zoo.get_config(name, table_scale=scale)
    np_params = bridge.init_numpy(cfg, seed)
    save_params(tmp_path / f"{name}_{seed}", np_params)
    scfg = ServingConfig(engine_backend="cpu", inference_engines=1, **kw)
    return ServingServer(cfg, scfg, checkpoint_path=str(tmp_path / f"{name}_{seed}")), np_params


def test_predict_returns_model_scores(tmp_path):
    """/v1/predict splits the rows over sub-batches and buckets; the scores
    are the JAX model's on the same weights, on both routes."""
    server, np_params = _cpu_server("ncf", 2000, 1, tmp_path, batch_buckets=(8, 16),
                                    max_mini_batch_size=16, sub_task_batch_size=8)
    ing, url = _serve(server)
    try:
        idx = _ids(server.model_cfg, 16, 0)
        status, out = _post(f"{url}/v1/predict", {"indices": idx.tolist()})
        assert status == 200 and out["sub_batches"] == 2 and out["batch_size"] == 16
        want = _jax_scores("ncf", 2000, np_params, idx)
        np.testing.assert_allclose(np.asarray(out["scores"], np.float32), want,
                                   rtol=RTOL, atol=ATOL)
        status, out2 = _post(f"{url}/v1/models/ncf/predict", {"indices": idx.tolist()})
        assert status == 200 and out2["scores"] == out["scores"]
    finally:
        ing.stop()


@pytest.mark.parametrize("case", ["missing", "rank", "tables", "range", "dense", "oversize",
                                  "fraction", "integral"])
def test_predict_validation_and_backend_errors(tmp_path, case):
    """Malformed payloads answer 400 with the field at fault; whole floats
    are ids, fractions are refused; a sim server answers 501."""
    server, _ = _cpu_server("ncf", 2000, 0, tmp_path, batch_buckets=(8,),
                            max_mini_batch_size=8)
    ing, url = _serve(server)
    cfg = server.model_cfg
    ok = _ids(cfg, 2, 0)
    try:
        if case == "integral":
            _, as_float = _post(f"{url}/v1/predict", {"indices": ok.astype(np.float64).tolist()})
            _, as_int = _post(f"{url}/v1/predict", {"indices": ok.tolist()})
            assert as_float["scores"] == as_int["scores"] and len(as_int["scores"]) == 2
            sim_ing, sim = _serve(_sim_server())
            try:
                assert _refused(f"{sim}/v1/predict", {"indices": [[[0]] * 4]})[0] == 501
            finally:
                sim_ing.stop()
            return
        bad = ok.copy()
        bad[0, 0, 0] = 10 ** 9
        payload, needle = {
            "missing": ({}, "indices"),
            "rank": ({"indices": [[0]]}, "shape"),
            "tables": ({"indices": [[[0], [0]]]}, "shape"),
            "range": ({"indices": bad.tolist()}, "out of range"),
            "dense": ({"indices": ok.tolist(), "dense": [[1.0], [1.0]]}, "no dense input"),
            "oversize": ({"indices": _ids(cfg, 64, 0).tolist()}, "max_mini_batch_size"),
            "fraction": ({"indices": (ok + 0.5).tolist()}, "integer"),
        }[case]
        code, body = _refused(f"{url}/v1/predict", payload)
        assert code == 400 and needle in body
    finally:
        ing.stop()


def test_predict_dense_model_requires_and_uses_dense(tmp_path):
    server, np_params = _cpu_server("wnd", 2000, 2, tmp_path, batch_buckets=(4,),
                                    max_mini_batch_size=4)
    ing, url = _serve(server)
    try:
        idx = _ids(server.model_cfg, 2, 1)
        code, body = _refused(f"{url}/v1/predict", {"indices": idx.tolist()})
        assert code == 400 and "dense" in body
        d = server.model_cfg.dense_dim
        outs = []
        for fill in (0.0, 3.0):
            dense = np.full((2, d), fill, np.float32)
            _, out = _post(f"{url}/v1/predict", {"indices": idx.tolist(), "dense": dense.tolist()})
            got = np.asarray(out["scores"], np.float32)
            np.testing.assert_allclose(got, _jax_scores("wnd", 2000, np_params, idx, dense),
                                       rtol=RTOL, atol=ATOL)
            outs.append(got)
        assert not np.allclose(outs[0], outs[1])
    finally:
        ing.stop()


def test_predict_ragged_lengths_round_trip(tmp_path):
    """lengths + values (CSR) over the wire: the JAX model's masked forward
    on the same weights; padded indices with junk past each length give the
    same scores; full lengths equal the fixed form."""
    server, np_params = _cpu_server("rm1", 50_000, 3, tmp_path, sub_task_batch_size=4,
                                    max_mini_batch_size=8, batch_buckets=(4, 8),
                                    accept_ragged=True)
    cfg = server.model_cfg
    ing, base = _serve(server)
    lengths, values, dense = _csr(cfg, 6, 5)  # two sub-requests: 4 + 2
    try:
        status, out = _post(f"{base}/v1/predict", {
            "lengths": lengths.tolist(), "values": values.tolist(), "dense": dense.tolist()})
        assert status == 200 and out["sub_batches"] == 2
        got = np.asarray(out["scores"], np.float32)
        idx, mask = pad_csr(lengths, values, cfg.num_indices_per_lookup)
        np.testing.assert_allclose(got, _jax_scores("rm1", 50_000, np_params, idx, dense, mask),
                                   rtol=RTOL, atol=ATOL)
        junk = idx.copy()
        junk[~mask] = 10 ** 9  # past every table: never read
        _, out2 = _post(f"{base}/v1/predict", {
            "indices": junk.tolist(), "lengths": lengths.tolist(), "dense": dense.tolist()})
        np.testing.assert_allclose(np.asarray(out2["scores"], np.float32), got,
                                   rtol=1e-6, atol=1e-7)
        fidx = _ids(cfg, 6, 7)
        full = np.full((6, cfg.num_tables), cfg.num_indices_per_lookup)
        _, r1 = _post(f"{base}/v1/predict", {"indices": fidx.tolist(), "lengths": full.tolist(),
                                             "dense": dense.tolist()})
        _, r2 = _post(f"{base}/v1/predict", {"indices": fidx.tolist(), "dense": dense.tolist()})
        np.testing.assert_allclose(np.asarray(r1["scores"]), np.asarray(r2["scores"]),
                                   rtol=RTOL, atol=ATOL)
        assert _refused(f"{base}/v1/predict", {"values": values.tolist()})[0] == 400
    finally:
        ing.stop()


def test_predict_ragged_refused_without_capability(tmp_path):
    server, _ = _cpu_server("ncf", 2000, 0, tmp_path, sub_task_batch_size=8,
                            max_mini_batch_size=8, batch_buckets=(8,))
    ing, base = _serve(server)
    try:
        T = server.model_cfg.num_tables
        assert _refused(f"{base}/v1/predict", {"lengths": [[1] * T], "values": [0] * T})[0] == 501
    finally:
        ing.stop()


def test_predict_ragged_on_hotcold_server(tmp_path):
    """A hot/cold server consumes the ragged mask in its host split: the
    JAX model's direct masked forward on the same weights. (The JAX test's
    mesh case waits for multi-device serving, ROADMAP.md Queue 1 item 12.)"""
    cfg = zoo.get_config("rm1", table_scale=5000, embedding_impl="hotcold", hot_set_rows=64)
    np_params = bridge.init_numpy(cfg.replace(embedding_impl="xla"), 4)
    save_params(tmp_path / "hc", np_params)
    scfg = ServingConfig(engine_backend="cpu", inference_engines=1, sub_task_batch_size=8,
                         max_mini_batch_size=8, batch_buckets=(8,), accept_ragged=True)
    server = ServingServer(cfg, scfg, checkpoint_path=str(tmp_path / "hc"))
    ing, base = _serve(server)
    lengths, values, dense = _csr(cfg, 8, 9)
    try:
        status, out = _post(f"{base}/v1/predict", {
            "lengths": lengths.tolist(), "values": values.tolist(), "dense": dense.tolist()})
        assert status == 200 and server.engines[0]._hotcold is not None
        idx, mask = pad_csr(lengths, values, cfg.num_indices_per_lookup)
        np.testing.assert_allclose(np.asarray(out["scores"], np.float32),
                                   _jax_scores("rm1", 5000, np_params, idx, dense, mask),
                                   rtol=RTOL, atol=ATOL)
    finally:
        ing.stop()


def test_reload_endpoint_zero_downtime(tmp_path):
    """POST /v1/reload swaps a checkpoint before the engine's next request;
    a bad path fails and the old params keep serving; GET reports it."""
    server, _ = _cpu_server("ncf", 2000, 0, tmp_path, batch_buckets=(16,),
                            max_mini_batch_size=16)
    ing, url = _serve(server)
    new = bridge.init_numpy(server.model_cfg, 123)
    save_params(tmp_path / "ckpt.v2", new)
    idx = _ids(server.model_cfg, 4, 3)
    try:
        status, out = _post(f"{url}/v1/reload", {"path": str(tmp_path / "ckpt.v2")})
        assert status == 200 and out["scheduled"] == 1
        _post(f"{url}/v1/infer", {"batch_size": 4})  # applies the swap first
        _, st = _get(f"{url}/v1/reload")
        assert st == {"scheduled": 1, "applied": 1, "failed": 0, "errors": []}
        want = _jax_scores("ncf", 2000, new, idx)
        _, out = _post(f"{url}/v1/predict", {"indices": idx.tolist()})
        np.testing.assert_allclose(np.asarray(out["scores"], np.float32), want,
                                   rtol=RTOL, atol=ATOL)
        _post(f"{url}/v1/reload", {"path": str(tmp_path / "missing")})
        status, r = _post(f"{url}/v1/infer", {"batch_size": 4})
        assert status == 200 and r["latency_ms"] > 0
        st = _get(f"{url}/v1/reload")[1]
        assert st["failed"] == 1 and "missing" in st["errors"][0]
        _, out = _post(f"{url}/v1/predict", {"indices": idx.tolist()})
        np.testing.assert_allclose(np.asarray(out["scores"], np.float32), want,
                                   rtol=RTOL, atol=ATOL)
        assert _refused(f"{url}/v1/reload", {})[0] == 400
    finally:
        ing.stop()


def test_healthz_reports_embedding_impl_decision():
    """embedding_impl="auto" decides at warm-up; /v1/healthz shows the
    choice and the sampled coverage (full-size ncf: the hot budget covers
    little of a uniform stream, so the direct lookup stays)."""
    cfg = zoo.get_config("ncf").replace(embedding_impl="auto", hotcold_min_table_mb=0)
    scfg = ServingConfig(engine_backend="cpu", inference_engines=1, batch_buckets=(8,),
                         max_mini_batch_size=8)
    ing, base = _serve(ServingServer(cfg, scfg))
    try:
        _, h = _get(f"{base}/v1/healthz")
        (impl,) = h["embedding_impl"]
        assert impl["impl"] == "direct" and 0.0 <= impl["hot_coverage"] < 0.75
    finally:
        ing.stop()


def test_out_of_range_ids_port_rejects_jax_does_not(tmp_path):
    """A stated difference. Over HTTP both packages answer 400 from the
    ingress's own id check. Behind it, the port's engine also checks: a
    payload that reaches it with an id past its table is answered
    ERR_PAYLOAD, which the handler maps to 400, where the JAX engine would
    read a neighbour table's row (tests/test_torch_serving.py)."""
    from deeprecsys_tpu_torch.models.base import Batch
    from deeprecsys_tpu_torch.serving.ingress import InferenceError
    from deeprecsys_tpu_torch.serving.packets import ERR_PAYLOAD

    server, _ = _cpu_server("rm1", 2000, 0, tmp_path, batch_buckets=(8,),
                            max_mini_batch_size=8, sub_task_batch_size=8)
    ing, url = _serve(server)
    cfg = server.model_cfg
    idx = _ids(cfg, 2, 0)
    idx[1, 0, 3] = cfg.scaled_rows[0]  # the next table's first row in the JAX gather
    dense = np.zeros((2, cfg.dense_dim), np.float32)
    try:
        code, body = _refused(f"{url}/v1/predict", {"indices": idx.tolist(),
                                                    "dense": dense.tolist()})
        assert code == 400 and "out of range" in body
        with pytest.raises(InferenceError) as e:
            server._run_query(2, False, TIMEOUT, None, Batch(dense=dense, indices=idx))
        assert e.value.code == ERR_PAYLOAD
        assert server.engines[0].rejected_requests == 1
    finally:
        ing.stop()


# --------------------------------------------------------- engine processes

MP_SCALE = 50_000


@pytest.fixture(scope="module")
def mp_server(tmp_path_factory):
    """rm1 on two engine processes (both from checkpoint A) and an offload
    engine on the CPU for queries of 48+ rows; a two-slot arena; ragged."""
    if not native.native_available():
        pytest.skip("native runtime not built (no g++)")
    root = tmp_path_factory.mktemp("mp")
    cfg = zoo.get_config("rm1", table_scale=MP_SCALE)
    weights = {k: bridge.init_numpy(cfg, seed) for k, seed in (("a", 42), ("b", 7))}
    # A long directory name: the path crosses the control rings in several
    # 58-byte fragments.
    paths = {k: root / ("deep_subdir_" + "x" * 80) / f"ckpt.{k}" for k in weights}
    for k, p in paths.items():
        save_params(p, weights[k])
    scfg = ServingConfig(engine_backend="cpu-mp", inference_engines=2, sub_task_batch_size=4,
                         max_mini_batch_size=64, batch_buckets=(4, 8, 64), accept_ragged=True,
                         payload_arena_slots=2, model_accel=True, accel_request_size_thres=48)
    server = ServingServer(cfg, scfg, checkpoint_path=str(paths["a"]), accel_device="cpu")
    ing, base = _serve(server, reload_root=str(root))
    yield {"server": server, "base": base, "cfg": cfg, "weights": weights, "paths": paths,
           "root": root}
    ing.stop()
    server.stop()  # a second stop is a no-op


def test_ingress_over_process_engines(mp_server):
    base = mp_server["base"]
    status, out = _post(f"{base}/v1/infer", {"batch_size": 6})
    assert status == 200 and out["sub_batches"] == 2 and not out["accel"]  # 4 + 2
    assert all(e < 2 for e in out["engines"])
    status, big = _post(f"{base}/v1/infer", {"batch_size": 50})
    assert status == 200 and big["accel"] and big["sub_batches"] == 1 and big["engines"] == [2]
    _, h = _get(f"{base}/v1/healthz")
    assert h["engines"] == h["live_engines"] == 3 and h["status"] == "ok"
    assert h["payload_slots_in_flight"] == 0 and h["payload_slots_total"] == 2


def test_predict_over_process_engines(mp_server):
    """Features cross to the processes in arena slots and the scores come
    back through them: the JAX model's on checkpoint A; no slot leaks."""
    server, base, cfg = mp_server["server"], mp_server["base"], mp_server["cfg"]
    idx = _ids(cfg, 7, 3)
    dense = np.random.default_rng(3).random((7, cfg.dense_dim), dtype=np.float32)
    want = _jax_scores("rm1", MP_SCALE, mp_server["weights"]["a"], idx, dense)
    for _ in range(2):  # the second query reuses the freed slots
        status, out = _post(f"{base}/v1/predict", {"indices": idx.tolist(),
                                                   "dense": dense.tolist()})
        assert status == 200 and out["sub_batches"] == 2 and not out["accel"]
        np.testing.assert_allclose(np.asarray(out["scores"], np.float32), want,
                                   rtol=RTOL, atol=ATOL)
        assert server._arena.in_flight() == 0


def test_predict_ragged_over_process_engines(mp_server):
    server, base, cfg = mp_server["server"], mp_server["base"], mp_server["cfg"]
    lengths, values, dense = _csr(cfg, 6, 9)
    status, out = _post(f"{base}/v1/predict", {
        "lengths": lengths.tolist(), "values": values.tolist(), "dense": dense.tolist()})
    assert status == 200 and out["sub_batches"] == 2
    idx, mask = pad_csr(lengths, values, cfg.num_indices_per_lookup)
    np.testing.assert_allclose(
        np.asarray(out["scores"], np.float32),
        _jax_scores("rm1", MP_SCALE, mp_server["weights"]["a"], idx, dense, mask),
        rtol=RTOL, atol=ATOL)
    assert server._arena.in_flight() == 0


def test_predict_arena_exhaustion_503_then_recovery(mp_server):
    """Every slot in flight: a predict answers 503 at once and leaks nothing;
    freed, it answers 200. A burst over the two slots answers each query 200
    or 503, and the arena drains to 0 with no router fault."""
    server, base, cfg = mp_server["server"], mp_server["base"], mp_server["cfg"]
    body = {"indices": _ids(cfg, 4, 11).tolist(),
            "dense": np.zeros((4, cfg.dense_dim)).tolist()}
    held = [server._arena.alloc() for _ in range(2)]
    code, err = _refused(f"{base}/v1/predict", body)
    assert code == 503 and "slot" in err
    assert server._arena.in_flight() == 2 and not server._pending
    for s in held:
        server._arena.free(s)
    status, out = _post(f"{base}/v1/predict", body)
    assert status == 200 and np.asarray(out["scores"]).shape == (4, cfg.out_dim)
    results = [None] * 8

    def hit(i):
        try:
            results[i] = _post(f"{base}/v1/predict", body)[0]
        except urllib.error.HTTPError as e:
            results[i] = e.code

    ts = [threading.Thread(target=hit, args=(i,)) for i in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=TIMEOUT)
    assert all(r in (200, 503) for r in results) and 200 in results, results
    assert server._arena.in_flight() == 0
    _, h = _get(f"{base}/v1/healthz")
    assert "arena_faults" not in h and h["status"] == "ok"


def test_reload_over_process_engines(mp_server):
    """The path reaches each process on its control ring (several
    fragments) and the offload engine through its handle: all three apply,
    and both routes serve checkpoint B. Back-to-back reloads resolve each
    handle by its gen; a path too long raises before any handle exists."""
    server, base, cfg = mp_server["server"], mp_server["base"], mp_server["cfg"]
    paths, weights = mp_server["paths"], mp_server["weights"]
    status, out = _post(f"{base}/v1/reload", {"path": str(paths["b"])})
    assert status == 200 and out["scheduled"] == 3  # two processes and the offload engine
    for h in server._reload_handles:
        assert h.event.wait(timeout=TIMEOUT) and h.error is None, h.error
    _, st = _get(f"{base}/v1/reload")
    assert st == {"scheduled": 3, "applied": 3, "failed": 0, "errors": []}
    idx = _ids(cfg, 6, 5)
    dense = np.random.default_rng(5).random((6, cfg.dense_dim), dtype=np.float32)
    _, out = _post(f"{base}/v1/predict", {"indices": idx.tolist(), "dense": dense.tolist()})
    np.testing.assert_allclose(np.asarray(out["scores"], np.float32),
                               _jax_scores("rm1", MP_SCALE, weights["b"], idx, dense),
                               rtol=RTOL, atol=ATOL)
    got = bridge.flatten(server.engines[0].params)  # the offload engine's
    want = bridge.flatten(bridge.params_from_numpy(weights["b"], cfg, "cpu"))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), w.numpy(), err_msg=k)
    bad = server.reload(str(mp_server["root"] / "missing.ckpt"))
    good = server.reload(str(paths["a"]))
    for h in bad:
        assert h.event.wait(timeout=TIMEOUT) and h.error is not None
    for h in good:
        assert h.event.wait(timeout=TIMEOUT) and h.error is None, h.error
    _, st = _get(f"{base}/v1/reload")
    assert st["applied"] == 3 and st["failed"] == 0
    with pytest.raises(ValueError, match="too long"):
        server.reload("/x/" + "y" * (255 * 58))
    assert _get(f"{base}/v1/reload")[1]["applied"] == 3
    assert _post(f"{base}/v1/infer", {"batch_size": 5})[0] == 200
