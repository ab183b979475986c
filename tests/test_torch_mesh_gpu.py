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
to the first.

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

from deeprecsys_tpu_torch import ServingConfig, train, zoo
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


@pytest.mark.parametrize("sparse", [False, True])
def test_mesh_training_step_across_cards(cards, sparse, monkeypatch):
    from deeprecsys_tpu_torch.ops import embedding_bag_backward_shard, sparse_adagrad_step_shard

    n = len(cards)
    D, M = (2, n // 2) if n >= 4 else (1, n)
    cfg, model, start = _model(cards[0])
    kw = dict(optimizer="adagrad", learning_rate=0.05, sparse_tables=sparse,
              table_learning_rate=0.01, params=start)
    single = train.Trainer(cfg, device=cards[0], **kw)
    tr = train.Trainer(cfg, mesh=make_mesh(D, M, devices=cards[:D * M]), **kw)
    host = RecDataGenerator(cfg, seed=1).generate_batch(64)
    labels = single._labels(host, None)
    k5_calls = []

    def k5_recorded(*args):
        k5_calls.append(args)
        return sparse_adagrad_step_shard(*args)

    monkeypatch.setattr(train, "sparse_adagrad_step_shard", k5_recorded)
    k1b, k5 = embedding_bag_backward_shard.kernel_launches, sparse_adagrad_step_shard.kernel_launches
    want = float(single.step(host, labels))
    got = float(tr.step(host, labels))
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
