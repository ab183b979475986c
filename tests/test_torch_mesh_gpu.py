"""The mesh paths across several CUDA cards of one host: every shard on its
own card, the partials moved between cards and combined, the engine's
stream on each card. Without two cards these tests skip; the CPU tests
(``tests/test_torch_parallel.py``) run the same paths on one device. The
file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_mesh_gpu.py

Each output is held to the single-device forward on the first card, on the
same f32 weights: rtol 2e-4, atol 2e-5 (the JAX mesh tests'), the sharded
sums differing only in their order; per-table int8 pools bit for bit.
"""

import queue
import time

import numpy as np
import pytest
import torch

from deeprecsys_tpu_torch import ServingConfig, zoo
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.experiments.skew_bench import zipf_stream
from deeprecsys_tpu_torch.models import get_model
from deeprecsys_tpu_torch.models.base import Batch, table_offsets
from deeprecsys_tpu_torch.models.hotcold import hot_ids_from_generator, make_hotcold_model
from deeprecsys_tpu_torch.ops import embedding_bag_int8
from deeprecsys_tpu_torch.parallel import make_mesh, shard_params, sharded_apply
from deeprecsys_tpu_torch.parallel import sharding
from deeprecsys_tpu_torch.serving import engine, packets

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
                pooled = sharding._pooled_on_row(sp, d, sl, cfg, offs)
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


@pytest.mark.parametrize("impl", ["xla", "hotcold"])
def test_mesh_engine_across_cards(cards, impl):
    """An engine whose mesh spans the cards (a stream on each, an event on
    each an execution): payload and ragged requests score as the
    single-device forward; the hot/cold engine refreshes its hot set from
    the shards on their cards."""
    n = len(cards)
    D, M = (2, n // 2) if n % 2 == 0 and n > 2 else (1, n)
    cfg = zoo.get_config("rm1", table_scale=SCALE, embedding_impl=impl, hot_set_rows=64)
    base = cfg.replace(embedding_impl="xla")
    model = get_model(base, cards[0])
    params = model.init(torch.Generator(device=cards[0]).manual_seed(0))
    scfg = ServingConfig(engine_backend="gpu" if cards[0].type == "cuda" else "cpu",
                         batch_buckets=(8, 32), max_mini_batch_size=32,
                         accept_ragged=True, hotcold_refresh_interval=4 if impl == "hotcold"
                         else 0, hotcold_refresh_window=8)
    req_q, resp_q, ready_q = queue.Queue(), queue.Queue(), queue.Queue()
    eng = engine.ComputeEngine(0, cfg, scfg, req_q, resp_q, ready_q, params=params,
                               mesh=make_mesh(D, M, devices=cards[:D * M]))
    eng.start()
    got = ready_q.get(timeout=600)
    assert not isinstance(got, Exception), got
    rng = np.random.default_rng(3)
    try:
        for i in range(12):
            n_rows = 32 if i % 3 else 8
            idx = zipf_stream(cfg, n_rows, seed=50 + i) if impl == "hotcold" else \
                RecDataGenerator(cfg, seed=50 + i).generate_batch(n_rows).indices
            dense = rng.random((n_rows, cfg.dense_dim), dtype=np.float32)
            mask = rng.random(idx.shape) < 0.6 if i % 2 else None
            req_q.put(packets.ServiceRequest(batch_id=i, batch_size=n_rows,
                                             arrival_time=time.time(),
                                             payload=Batch(dense=dense, indices=idx, mask=mask)))
            r = resp_q.get(timeout=120)
            assert r.error_code == 0
            with torch.inference_mode():
                want = model.apply(params, Batch(dense=dense, indices=idx, mask=mask)
                                   .to(cards[0])).cpu().numpy()
            np.testing.assert_allclose(r.scores, want, rtol=RTOL, atol=ATOL)
        if impl == "hotcold":
            assert eng.hot_refreshes >= 1
            hot = eng.params.entry(D - 1, M - 1)["hot_table"]
            assert hot.device == cards[D * M - 1]
            assert torch.equal(hot.to(cards[0]), params["tables"].index_select(
                0, torch.as_tensor(np.asarray(eng._hotcold.hot_ids), device=cards[0])))
    finally:
        req_q.put(None)
        eng.join(timeout=120)
    assert eng.error is None
