"""The port's lifecycle over real sockets, on the CPU (JAX
``tests/test_lifecycle.py``): train, checkpoint, serve over HTTP, train a
second model and swap it in with POST /v1/reload while clients keep
sending. No request may fail, and the served scores are the JAX model's on
each checkpoint (f32, rtol and atol 1e-5)."""

import json
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np

from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu.models import get_model as jax_get_model
from deeprecsys_tpu.models.base import Batch as JaxBatch
from deeprecsys_tpu.utils.checkpoint import load_model_params as jax_load_model_params
from deeprecsys_tpu_torch import ServingConfig, bridge, zoo
from deeprecsys_tpu_torch.serving.ingress import HttpIngress, ServingServer
from deeprecsys_tpu_torch.train import Trainer
from deeprecsys_tpu_torch.utils.checkpoint import save_params

TIMEOUT = 60


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        return r.status, json.loads(r.read())


def _trained(cfg, seed: int, path) -> None:
    tr = Trainer(cfg, optimizer="adagrad", learning_rate=0.3, loss="bce", seed=seed,
                 device="cpu")
    hist = tr.fit(num_steps=20, batch_size=64)
    assert np.isfinite(hist.losses).all()
    save_params(path, bridge.params_to_numpy(tr.params, tr.cfg))


def _jax_scores(path, idx) -> np.ndarray:
    """The JAX model's scores on the checkpoint (the JAX package's loader)."""
    cfg = jax_zoo.get_config("ncf", table_scale=2000)
    params = jax.tree_util.tree_map(jnp.asarray, jax_load_model_params(cfg, path))
    out = jax_get_model(cfg).apply(params, JaxBatch(dense=None, indices=jnp.asarray(idx)))
    return np.asarray(out, np.float32)


def test_train_checkpoint_serve_reload_lifecycle(tmp_path):
    cfg = zoo.get_config("ncf", table_scale=2000)
    _trained(cfg, 0, tmp_path / "ckpt.v1")
    rows = np.asarray(cfg.scaled_rows)
    idx = np.random.default_rng(0).integers(
        0, rows[None, :, None], size=(8, cfg.num_tables, cfg.num_indices_per_lookup)
    ).astype(np.int32)

    scfg = ServingConfig(engine_backend="cpu", inference_engines=1, batch_buckets=(16,),
                         max_mini_batch_size=16)
    server = ServingServer(cfg, scfg, checkpoint_path=str(tmp_path / "ckpt.v1"))
    server.start(timeout=300)
    ing = HttpIngress(server)
    ing.start()
    base = "http://%s:%s" % ing.address
    try:
        _, out = _post(f"{base}/v1/predict", {"indices": idx.tolist()})
        want_v1 = _jax_scores(tmp_path / "ckpt.v1", idx)
        np.testing.assert_allclose(np.asarray(out["scores"], np.float32), want_v1,
                                   rtol=1e-5, atol=1e-5)

        _trained(cfg, 11, tmp_path / "ckpt.v2")
        stop, failures, served = threading.Event(), [], []

        def client():
            while not stop.is_set():
                try:
                    st, _ = _post(f"{base}/v1/infer", {"batch_size": 5})
                    (served if st == 200 else failures).append(st)
                except Exception as e:  # a dropped request is downtime
                    failures.append(repr(e))

        t = threading.Thread(target=client, daemon=True)
        t.start()
        s, out = _post(f"{base}/v1/reload", {"path": str(tmp_path / "ckpt.v2")})
        assert s == 200 and out["scheduled"] == 1
        assert server._reload_handles[0].event.wait(timeout=TIMEOUT)
        stop.set()
        t.join(timeout=TIMEOUT)
        assert not failures and served, failures[:3]
        assert server.reload_status() == {"scheduled": 1, "applied": 1, "failed": 0,
                                          "errors": []}

        _, out = _post(f"{base}/v1/predict", {"indices": idx.tolist()})
        want_v2 = _jax_scores(tmp_path / "ckpt.v2", idx)
        assert not np.allclose(want_v1, want_v2)
        np.testing.assert_allclose(np.asarray(out["scores"], np.float32), want_v2,
                                   rtol=1e-5, atol=1e-5)
    finally:
        ing.stop()
