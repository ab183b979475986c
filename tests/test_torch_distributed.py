"""The port's meshes across OS processes, on the CPU (counterpart of
``tests/test_distributed.py`` with ``tests/distributed_worker.py``).

Two spawned processes of two CPU entries each join one 4-entry mesh over
``torch.distributed`` (``gloo``), as the JAX test's two processes of two
virtual CPU devices do over ``jax.distributed``. rm1 at ``table_scale=5000``,
batch 8, f32, on the JAX init's weights (through ``bridge``, as numpy
arrays handed to the workers). Each worker runs, on ``(2, 2)`` (JAX's
device order: process 0 holds data row 0, so the sum over "model" stays
inside each process) and ``(1, 4)`` (the sum crosses the processes):

- ``sharded_apply``: held to the JAX single-device ``model.apply`` within
  max |err| 2e-4 (``tests/test_distributed.py:43``) and to the port's
  single-process mesh of the same shape within rtol 2e-4, atol 2e-5;
- ``Trainer(mesh=)`` dense and sparse, two adagrad steps: the losses to the
  JAX single-device trainer's and to the single-process mesh trainer's at
  rtol 1e-5; then ``unshard_params`` to JAX's params at
  ``tests/test_torch_mesh_train.py``'s limits (rtol 1e-5, atol 1e-6; the
  sparse table atol 1e-3 of the steps' reach) and to the single-process
  mesh's at its limits for two meshes of one model (rtol 1e-5, atol 1e-7);
- a step's all-reduces: one for each set of processes the tower leaves
  (and, on ``(2, 2)``, the table shards' copies) span, beside the loss's
  and the row sum's (``reduce_copies``' merge, XLA's all-reduce combiner);
  and the merged reduce against the per-leaf one (every leaf set apart,
  ``PACK_MAX = 0``), bit for bit over the two processes;
- on ``(1, 4)``, the per-table int8 and row-wise int8 tables (weights made
  by ``bridge.init_numpy``): scores within 2e-4 of JAX's apply, and the
  pooled lookup of data row 0, summed over both processes, equal to JAX's
  ``pooled_lookup`` bit for bit for per-table int8 (its int32 partials are
  summed exactly) and within ``rowwise_tolerance`` for row-wise int8.

Each worker also runs the hot/cold model (``make_hotcold_model(mesh=)``,
tensor-parallel on ``(1, 4)``, hybrid on ``(2, 2)``) and the table-wise model
(``make_tablewise_model``, once more on ``(1, 4)`` with a ragged mask) in the
three table layouts (float on the JAX init's weights, per-table and
row-wise int8 on ``bridge.init_numpy``'s), with
``tests/test_torch_parallel.py``'s hot set: held to JAX's model on a
single-process JAX mesh of the same shape and to JAX's single-device apply
within 2e-4, and to the port's single-process mesh within rtol 2e-4, atol
2e-5. Every process's host split is equal array for array; the per-table
int8 pools (hot/cold on ``(1, 4)``, where the row sum crosses the
processes, and table-wise) are exact.

Four spawned processes of one CPU entry each run the same forward and
trainers, the hot/cold hybrid model and the float table-wise model on
``(2, 2)``: every row, every column and the mesh's own combines then cross
processes, and no row or column holds every process.

The single-process runs, and a mesh of one process that must make no
collective call, run in this process. The file imports no JAX at module
level: the workers import it and must not load JAX.
"""

import multiprocessing as mp
import socket
import traceback

import numpy as np
import pytest
import torch

from deeprecsys_tpu_torch import ServingConfig, bridge, train, zoo
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.models import get_model, hotcold
from deeprecsys_tpu_torch.models.base import Batch
from deeprecsys_tpu_torch.ops import embedding as emb
from deeprecsys_tpu_torch.ops.embedding import rowwise_tolerance
from deeprecsys_tpu_torch.parallel import (
    distributed_init, make_mesh, shard_params, sharded_apply, unshard_params)
from deeprecsys_tpu_torch.parallel import sharding

SCALE = 5000
BATCH = 8
TRAIN_BATCH = 16
STEPS = 2
LR = 0.05
AXES = ((2, 2), (1, 4))
QUAD_AXES = ((2, 2),)
MODES = ("dense", "sparse")
QUANTS = ("int8", "int8_rowwise")
LAYOUTS = ("none",) + QUANTS
MASKED_AXES = (1, 4)  # the table-wise case with a ragged mask
FWD_MAX_ERR = 2e-4
MODEL_RTOL, MODEL_ATOL = 2e-4, 2e-5
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL = 1e-5, 1e-7
JAX_PARAM_RTOL, JAX_PARAM_ATOL = 1e-5, 1e-6
WAIT_S = 240


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _cfg(quant: str = "none"):
    return zoo.get_config("rm1", table_scale=SCALE, table_quant=quant)


def _host():
    return RecDataGenerator(_cfg(), seed=1).generate_batch(BATCH)


def _runs(mesh_of, params: dict, axes) -> dict:
    """The forward and the trainers on ``mesh_of(D, M)`` for each shape of
    ``axes``: ``{("fwd", D, M): scores, (mode, D, M): (losses, full
    params)}``."""
    cfg = _cfg()
    model = get_model(cfg, "cpu")
    out = {}
    for D, M in axes:
        mesh = mesh_of(D, M)
        out[("fwd", D, M)] = sharded_apply(model, mesh, True)(
            shard_params(params, mesh), _host()).numpy()
        for mode in MODES:
            tr = train.Trainer(cfg, mesh=mesh, optimizer="adagrad", learning_rate=LR,
                               sparse_tables=mode == "sparse", params=params)
            losses = tr.fit(STEPS, batch_size=TRAIN_BATCH, seed=1).losses
            full = bridge.flatten(unshard_params(tr.params))
            out[(mode, D, M)] = (losses, {k: v.numpy() for k, v in full.items()})
            out[("eager", mode, D, M)] = (tr.step_program is None, tr.eager_reason)
    return out


def _quant_runs(mesh, np_quant: dict) -> dict:
    """Each int8 layout's forward on ``mesh`` and the pooled lookup of data
    row 0 (None in a process that does not hold entry (0, 0)):
    ``{quant: (scores, pooled)}``."""
    out = {}
    host = _host()
    for quant, np_params in np_quant.items():
        cfg = _cfg(quant)
        model = get_model(cfg, "cpu")
        sp = shard_params(bridge.params_from_numpy(np_params, cfg, "cpu"), mesh)
        scores = sharded_apply(model, mesh, True)(sp, host).numpy()
        offsets = sharding.Replicated(mesh, torch.as_tensor(cfg.table_offsets,
                                                            dtype=torch.int32))
        pooled = sharding.pooled_on_row(sp, 0, sharding.split_batch(host, mesh)[0], cfg, offsets)
        out[quant] = (scores, None if pooled is None else pooled.numpy())
    return out


def _mask():
    """The ragged mask of the masked table-wise case."""
    return np.random.default_rng(7).random(_host().indices.shape) < 0.6


def _hot_ids():
    """``tests/test_torch_parallel.py``'s hot set (``jax_hotcold_outputs``)."""
    return hotcold.hot_ids_from_generator(_cfg(), seed=5, hot_rows=48, n_batches=2,
                                          batch_size=32)


def _layout_runs(mesh_of, layouts: dict, axes) -> dict:
    """The hot/cold and table-wise models on ``mesh_of(D, M)`` for each
    shape of ``axes`` in each layout of ``layouts`` (``{quant: params}``):
    ``{("hotcold", quant, D, M): scores, ("split", quant, D, M): the host
    split, ("tablewise", quant, D, M): scores}``; on ``MASKED_AXES`` in the
    float layout, the table-wise model with the ragged mask; with per-table
    int8 tables, the pooled lookups (``"hotcold pooled"``,
    ``"tablewise pooled"``), whole on every process."""
    from deeprecsys_tpu_torch.models.hotcold import make_hotcold_model
    from deeprecsys_tpu_torch.parallel.api import make_tablewise_model

    host, hot_ids, out = _host(), _hot_ids(), {}
    for quant, params in layouts.items():
        cfg = _cfg(quant)
        model = get_model(cfg, "cpu")
        for D, M in axes:
            mesh = mesh_of(D, M)
            hc = make_hotcold_model(model, hot_ids, mesh=mesh)
            hp = hc.convert_params(params)
            split = hc.prepare(host)
            out[("split", quant, D, M)] = {k: np.asarray(v) for k, v in split.items()}
            out[("hotcold", quant, D, M)] = hc.apply(
                shard_params(hp, mesh), Batch(dense=torch.from_numpy(host.dense), indices=None),
                split).numpy()
            tw = make_tablewise_model(model, mesh)
            twp = tw.convert_params(params)
            out[("tablewise", quant, D, M)] = tw.apply(twp, host).numpy()
            if quant == "none" and (D, M) == MASKED_AXES:
                out[("tablewise masked", quant, D, M)] = tw.apply(
                    twp, host._replace(mask=_mask())).numpy()
            if quant == "int8":
                q, scale = params["tables"]["q"], params["tables"]["scale"]
                out[("hotcold pooled", quant, D, M)] = (
                    sharding.sharded_embedding_bag_hotcold if D == 1
                    else sharding.hybrid_embedding_bag_hotcold)(
                        hp["hot_table"], q, split, mesh, table_scale=scale).numpy()
                out[("tablewise pooled", quant, D, M)] = sharding.tablewise_embedding_bag(
                    twp["tables_tw"], torch.from_numpy(host.indices), tw.placement, mesh,
                    table_scale=scale, compute_dtype=torch.float32).numpy()
    return out


def _save(path, tree) -> str:
    """``tree`` (numpy leaves) written to ``path`` for the workers: a spawned
    process reads its arguments only after importing this module, so
    arrays handed over as arguments would hold each start until the one
    before had imported torch."""
    np.savez(path, **bridge.flatten(tree))
    return str(path)


def _load(path: str) -> dict:
    with np.load(path) as f:
        return bridge.unflatten({k: f[k] for k in f.files})


def _raises(fn) -> str:
    try:
        fn()
    except NotImplementedError as e:
        return str(e)
    return "did not raise"


def _step_reduces(mesh, params: dict, reduces: list) -> dict:
    """The all-reduces of one adagrad step of each mode's trainer on
    ``mesh`` (``reduces`` collects the calls): ``{("step reduces", mode, D,
    M): n}``."""
    out = {}
    host = RecDataGenerator(_cfg(), seed=1).generate_batch(TRAIN_BATCH)
    for mode in MODES:
        tr = train.Trainer(_cfg(), mesh=mesh, optimizer="adagrad", learning_rate=LR,
                           sparse_tables=mode == "sparse", params=params)
        labels = tr._labels(host, None)
        reduces.clear()
        tr.step(host, labels)
        out[("step reduces", mode, *mesh.devices.shape)] = len(reduces)
    return out


def _merged_against_per_leaf(sp, reduces: list) -> tuple:
    """``reduce_copies`` over every leaf of ``sp`` (tables included, as the
    dense step reduces them) on gradients drawn from this process's rank,
    merged (one all-reduce a rank set and dtype) and per leaf (every leaf
    set apart, the reduce before the merge): ``(bit for bit equal, merged
    calls, per-leaf calls)``."""
    mesh = sp.mesh
    groups = sharding.leaf_groups(sp)
    gen = torch.Generator().manual_seed(100 + mesh.rank)
    grads = [torch.randn(t.shape, generator=gen).to(t.dtype) for _, copies in groups
             for t in copies]
    reduces.clear()
    merged = sharding.reduce_copies(mesh, groups, grads)
    n_merged = len(reduces)
    pack_max, sharding.PACK_MAX = sharding.PACK_MAX, 0
    try:
        reduces.clear()
        per_leaf = sharding.reduce_copies(mesh, groups, grads)
    finally:
        sharding.PACK_MAX = pack_max
    equal = len(merged) == len(per_leaf) and all(torch.equal(a, b)
                                                 for a, b in zip(merged, per_leaf))
    return equal, n_merged, len(reduces)


def run_worker(rank: int, n_proc: int, port: int, job: dict, q):
    """One process of the mesh: ``job["local"]`` CPU entries, the same
    params and batches as every other process; runs the forward, the
    trainers and the hot/cold and table-wise models (``job["layouts"]``) on
    ``job["axes"]``, and with ``job["quant"]`` the int8 layouts on 1x4, the
    all-reduce count of a forward and of a hot/cold forward, and what
    raises. Puts ``(rank, "ok", results)``."""
    import torch.distributed as dist

    from deeprecsys_tpu_torch.models.hotcold import make_hotcold_model
    from deeprecsys_tpu_torch.parallel.api import make_tablewise_model
    from deeprecsys_tpu_torch.serving.engine import ComputeEngine

    torch.set_num_threads(1)
    try:
        distributed_init(f"127.0.0.1:{port}", num_processes=n_proc, process_id=rank,
                         backend="gloo")
        cfg = _cfg()
        devices = ["cpu"] * job["local"]
        params = bridge.params_from_numpy(_load(job["params"]), cfg, "cpu")
        res = {"ranks": {(D, M): make_mesh(D, M, devices=devices).ranks.tolist()
                         for D, M in job["axes"]}}
        res.update(_runs(lambda D, M: make_mesh(D, M, devices=devices), params, job["axes"]))
        layouts = {q_: params if path == job["params"] else bridge.params_from_numpy(
            _load(path), _cfg(q_), "cpu") for q_, path in job["layouts"].items()}
        res.update(_layout_runs(lambda D, M: make_mesh(D, M, devices=devices), layouts,
                                job["axes"]))
        if job["quant"]:
            quant = {q_: _load(path) for q_, path in job["quant"].items()}
            res["quant"] = _quant_runs(make_mesh(1, 4, devices=devices), quant)
            reduces = []
            orig = dist.all_reduce

            def counted(*args, **kwargs):
                reduces.append(1)
                return orig(*args, **kwargs)

            dist.all_reduce = counted
            try:
                model = get_model(cfg, "cpu")
                for D, M in job["axes"]:
                    mesh = make_mesh(D, M, devices=devices)
                    sp = shard_params(params, mesh)
                    reduces.clear()
                    sharded_apply(model, mesh, True)(sp, _host())
                    res[("reduces", D, M)] = len(reduces)
                    hc = make_hotcold_model(model, _hot_ids(), mesh=mesh)
                    hp = shard_params(hc.convert_params(params), mesh)
                    split = hc.prepare(_host())
                    reduces.clear()
                    hc.apply(hp, Batch(dense=torch.from_numpy(_host().dense), indices=None), split)
                    res[("hotcold reduces", D, M)] = len(reduces)
                    res.update(_step_reduces(mesh, params, reduces))
                    res[("merged", D, M)] = _merged_against_per_leaf(sp, reduces)
            finally:
                dist.all_reduce = orig
            mesh = make_mesh(1, 4, devices=devices)
            res["raises"] = {
                "hotcold": _raises(lambda: make_hotcold_model(model, np.arange(8), mesh=mesh)),
                "tablewise": _raises(lambda: make_tablewise_model(model, mesh)),
                "engine": _raises(lambda: ComputeEngine(
                    0, cfg, ServingConfig(engine_backend="cpu"), None, None, None, mesh=mesh)),
            }
        q.put((rank, "ok", res))
    except Exception:  # surfaced by the tests
        q.put((rank, "error", traceback.format_exc()[-3000:]))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _jax_reference(np_params: dict, np_quant: dict) -> dict:
    """JAX's single-device forward, its trainers (``STEPS`` adagrad steps
    from ``np_params``, which are JAX's ``model.init`` at seed 0, the
    trainers' own init) and each int8 layout's forward and pooled lookup of
    data row 0."""
    import jax
    import jax.numpy as jnp

    from deeprecsys_tpu import train as jax_train
    from deeprecsys_tpu import zoo as jax_zoo
    from deeprecsys_tpu.models import get_model as jax_get_model
    from deeprecsys_tpu.models.base import Batch as JaxBatch
    from deeprecsys_tpu.models.base import pooled_lookup as jax_pooled_lookup

    host = _host()
    batch = JaxBatch(dense=jnp.asarray(host.dense), indices=jnp.asarray(host.indices))
    jcfg = jax_zoo.get_config("rm1", table_scale=SCALE)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    out = {"fwd": np.asarray(jax_get_model(jcfg).apply(jparams, batch))}
    for mode in MODES:
        jt = jax_train.Trainer(jcfg, optimizer="adagrad", learning_rate=LR,
                               sparse_tables=mode == "sparse")
        losses = jt.fit(STEPS, batch_size=TRAIN_BATCH, seed=1).losses
        out[mode] = (losses, {k: np.asarray(v) for k, v in
                              bridge.flatten(jax.device_get(jt.params)).items()})
    row0 = JaxBatch(dense=None, indices=jnp.asarray(host.indices))  # 1x4: one data row
    for quant, np_q in np_quant.items():
        qcfg = jax_zoo.get_config("rm1", table_scale=SCALE, table_quant=quant)
        qparams = jax.tree_util.tree_map(jnp.asarray, np_q)
        out[quant] = (np.asarray(jax_get_model(qcfg).apply(qparams, batch)),
                      np.asarray(jax_pooled_lookup(qparams["tables"], row0, qcfg)))
    return out


def _jax_layouts(np_layouts: dict) -> dict:
    """JAX's hot/cold and table-wise models on a single-process JAX mesh of
    each shape of ``AXES`` (the hot/cold one built as
    ``tests/test_torch_parallel.py::jax_hotcold_outputs`` builds it), keyed
    as ``_layout_runs`` keys its scores, and JAX's single-device apply with
    the ragged mask (``("single masked", "none")``)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from deeprecsys_tpu import zoo as jax_zoo
    from deeprecsys_tpu.models import get_model as jax_get_model
    from deeprecsys_tpu.models import hotcold as jax_hotcold
    from deeprecsys_tpu.models.base import Batch as JaxBatch
    from deeprecsys_tpu.parallel import make_mesh as jax_make_mesh
    from deeprecsys_tpu.parallel import sharding as jax_sharding
    from deeprecsys_tpu.parallel.api import make_tablewise_model as jax_tablewise_model

    host, hot_ids, out = _host(), _hot_ids(), {}
    batch = JaxBatch(dense=jnp.asarray(host.dense), indices=jnp.asarray(host.indices))
    masked = batch._replace(mask=jnp.asarray(_mask()))
    for quant, np_p in np_layouts.items():
        jmodel = jax_get_model(jax_zoo.get_config("rm1", table_scale=SCALE, table_quant=quant))
        jparams = jax.tree_util.tree_map(jnp.asarray, np_p)
        if quant == "none":
            out[("single masked", quant)] = np.asarray(jmodel.apply(jparams, masked))
        for D, M in AXES:
            jmesh = jax_make_mesh(data=D, model=M, devices=jax.devices()[:D * M])
            hc = jax_hotcold.make_hotcold_model(jmodel, hot_ids, mesh=jmesh)
            hp = jax_sharding.shard_params(hc.convert_params(jparams), jmesh)
            hot = P("data", None, None) if D > 1 else P()
            cold = P("data", "model", None) if D > 1 else P("model", None)
            split = {k: jax.device_put(jnp.asarray(v), NamedSharding(
                jmesh, hot if k in ("hot_sel", "hot_mask") else cold))
                for k, v in hc.prepare(batch).items() if k != "n_cold"}
            out[("hotcold", quant, D, M)] = np.asarray(jax.jit(hc.apply)(hp, batch, split),
                                                       np.float32)
            jtw = jax_tablewise_model(jmodel, jmesh)
            twp = jtw.convert_params(jparams)
            out[("tablewise", quant, D, M)] = np.asarray(jtw.apply(twp, batch))
            if quant == "none" and (D, M) == MASKED_AXES:
                out[("tablewise masked", quant, D, M)] = np.asarray(jtw.apply(twp, masked))
    return out


def _spawn(ctx, q, n_proc: int, job: dict) -> list:
    port = _free_port()
    procs = [ctx.Process(target=run_worker, args=(i, n_proc, port, job, q))
             for i in range(n_proc)]
    for p in procs:
        p.start()
    return procs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The workers' results by group and rank, the single-process mesh's
    and JAX's; the workers of both groups run while this process computes
    its own."""
    import jax

    from deeprecsys_tpu import zoo as jax_zoo
    from deeprecsys_tpu.models import get_model as jax_get_model

    jparams = jax_get_model(jax_zoo.get_config("rm1", table_scale=SCALE)).init(
        jax.random.PRNGKey(0))
    np_params = jax.tree_util.tree_map(np.asarray, jax.device_get(jparams))
    np_quant = {quant: bridge.init_numpy(_cfg(quant), 0) for quant in QUANTS}
    tmp = tmp_path_factory.mktemp("distributed")
    params_path = _save(tmp / "params.npz", np_params)
    quant_paths = {quant: _save(tmp / f"{quant}.npz", p) for quant, p in np_quant.items()}
    ctx = mp.get_context("spawn")
    queues = {"pair": ctx.Queue(), "quad": ctx.Queue()}
    procs = {"pair": _spawn(ctx, queues["pair"], 2, {"local": 2, "axes": AXES,
                                                     "params": params_path,
                                                     "layouts": {"none": params_path,
                                                                 **quant_paths},
                                                     "quant": quant_paths}),
             "quad": _spawn(ctx, queues["quad"], 4, {"local": 1, "axes": QUAD_AXES,
                                                     "params": params_path,
                                                     "layouts": {"none": params_path},
                                                     "quant": None})}
    results = {"pair": {}, "quad": {}}
    try:
        ref = _jax_reference(np_params, np_quant)
        np_layouts = {"none": np_params, **np_quant}
        ref.update(_jax_layouts(np_layouts))

        def single_mesh(D, M):
            return make_mesh(D, M, devices=["cpu"] * (D * M))

        single = _runs(single_mesh, bridge.params_from_numpy(np_params, _cfg(), "cpu"), AXES)
        single.update(_layout_runs(single_mesh, {
            quant: bridge.params_from_numpy(p, _cfg(quant), "cpu")
            for quant, p in np_layouts.items()}, AXES))
        for group, ps in procs.items():
            for _ in ps:
                rank, status, detail = queues[group].get(timeout=WAIT_S)
                assert status == "ok", (group, rank, detail)
                results[group][rank] = detail
    finally:
        for p in procs["pair"] + procs["quad"]:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
    assert sorted(results["pair"]) == [0, 1] and sorted(results["quad"]) == [0, 1, 2, 3]
    assert not any(p.is_alive() for p in procs["pair"] + procs["quad"])
    return {"workers": results["pair"], "quad": results["quad"], "single": single,
            "jax": ref["fwd"], "ref": ref}


def _assert_close_to_jax(got: dict, want: dict, mode: str, who: str):
    """``tests/test_torch_mesh_train.py``'s limits for the port's params
    against JAX's (the same layout for rm1: no pack)."""
    assert sorted(got) == sorted(want), who
    reach = STEPS * LR
    for key, w in want.items():
        assert got[key].shape == w.shape and got[key].dtype == w.dtype, (who, key)
        atol = 1e-3 * reach if mode == "sparse" and key == "tables" else JAX_PARAM_ATOL
        np.testing.assert_allclose(got[key], w, rtol=JAX_PARAM_RTOL, atol=atol,
                                   err_msg=f"{who} {key}")


def _assert_trainer(runs, res: dict, mode: str, D: int, M: int, who: str):
    """A worker's trainer against JAX's single-device trainer and the
    single-process mesh trainer on the same shape."""
    losses, got = res[(mode, D, M)]
    assert np.all(np.isfinite(losses)), who
    jax_losses, jax_params = runs["ref"][mode]
    np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL, err_msg=who)
    _assert_close_to_jax(got, jax_params, mode, who)
    want_losses, want = runs["single"][(mode, D, M)]
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL, err_msg=who)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=f"{who} {key}")


def test_make_mesh_puts_process_0_on_data_row_0(runs):
    for res in runs["workers"].values():
        assert res["ranks"] == {(2, 2): [[0, 0], [1, 1]], (1, 4): [[0, 0, 1, 1]]}
    for res in runs["quad"].values():
        assert res["ranks"] == {(2, 2): [[0, 1], [2, 3]]}


@pytest.mark.parametrize("D,M", AXES)
def test_forward_matches_jax_single_device(runs, D, M):
    for rank, res in runs["workers"].items():
        got = res[("fwd", D, M)]
        assert got.shape == runs["jax"].shape, rank
        err = float(np.max(np.abs(got - runs["jax"])))
        assert err < FWD_MAX_ERR, (rank, err)


@pytest.mark.parametrize("D,M", AXES)
def test_forward_matches_single_process_mesh(runs, D, M):
    for res in runs["workers"].values():
        np.testing.assert_allclose(res[("fwd", D, M)], runs["single"][("fwd", D, M)],
                                   rtol=MODEL_RTOL, atol=MODEL_ATOL)


def test_sum_over_model_crosses_processes_only_where_a_row_does(runs):
    """One all-reduce a forward on 1x4 (data row 0 spans both processes),
    none on 2x2 (each process holds a whole row)."""
    for res in runs["workers"].values():
        assert res[("reduces", 2, 2)] == 0 and res[("reduces", 1, 4)] == 1


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("D,M", AXES)
def test_trainer_matches_single_process_mesh(runs, mode, D, M):
    want_losses, want = runs["single"][(mode, D, M)]
    for rank, res in runs["workers"].items():
        losses, got = res[(mode, D, M)]
        assert np.all(np.isfinite(losses)), rank
        np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL, err_msg=str(rank))
        assert sorted(got) == sorted(want)
        for key, w in want.items():
            np.testing.assert_allclose(got[key], w, rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                       err_msg=f"rank {rank} {key}")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("D,M", AXES)
def test_trainer_across_processes_stays_eager(runs, mode, D, M):
    """Decided when the trainer is built: a mesh across processes steps
    eagerly (gloo's collectives cannot be captured), with its reason; the
    same mesh in one process steps through its programs."""
    for rank, res in runs["workers"].items():
        eager, reason = res[("eager", mode, D, M)]
        assert eager and "across processes" in reason, rank
    assert runs["single"][("eager", mode, D, M)] == (False, None)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("D,M", AXES)
def test_trainer_matches_jax_single_device(runs, mode, D, M):
    """The two-process trainers against the JAX package's single-device
    ``Trainer`` on the same init and batches."""
    for rank, res in runs["workers"].items():
        losses, got = res[(mode, D, M)]
        jax_losses, jax_params = runs["ref"][mode]
        assert np.all(np.isfinite(losses)), rank
        np.testing.assert_allclose(losses, jax_losses, rtol=LOSS_RTOL, err_msg=str(rank))
        _assert_close_to_jax(got, jax_params, mode, f"rank {rank}")


@pytest.mark.parametrize("quant", QUANTS)
def test_quantized_forward_across_processes_matches_jax(runs, quant):
    """Per-table int8 (K1-int8's window) and row-wise int8 (K4's) on 1x4,
    where data row 0's sum over "model" crosses the processes."""
    want_scores, want_pooled = runs["ref"][quant]
    held = 0
    for rank, res in runs["workers"].items():
        scores, pooled = res["quant"][quant]
        assert scores.shape == want_scores.shape, rank
        err = float(np.max(np.abs(scores - want_scores)))
        assert err < FWD_MAX_ERR, (rank, err)
        if pooled is None:
            continue
        held += 1
        if quant == "int8":
            np.testing.assert_array_equal(pooled, want_pooled, err_msg=f"rank {rank}")
        else:
            host = _host()
            qrows = bridge.params_from_numpy(bridge.init_numpy(_cfg(quant), 0), _cfg(quant),
                                             "cpu")["tables"]["qrows"]
            got, want = torch.tensor(pooled), torch.tensor(want_pooled)
            tol = rowwise_tolerance(got, want, qrows, torch.as_tensor(_cfg(quant).table_offsets,
                                                                      dtype=torch.int32),
                                    torch.from_numpy(host.indices))
            assert bool(((got - want).abs() <= tol).all()), (rank, (got - want).abs().max())
    assert held == 1  # entry (0, 0)'s process, and no other


def test_four_processes_forward_matches_jax_and_single_process(runs):
    """Four processes of one entry each on 2x2: the sum over "model" crosses
    processes in both rows and the concat over "data" spans all four."""
    for rank, res in runs["quad"].items():
        got = res[("fwd", 2, 2)]
        err = float(np.max(np.abs(got - runs["jax"])))
        assert got.shape == runs["jax"].shape and err < FWD_MAX_ERR, (rank, err)
        np.testing.assert_allclose(got, runs["single"][("fwd", 2, 2)], rtol=MODEL_RTOL,
                                   atol=MODEL_ATOL)


@pytest.mark.parametrize("mode", MODES)
def test_four_processes_trainer_matches_jax_and_single_process(runs, mode):
    for rank, res in runs["quad"].items():
        _assert_trainer(runs, res, mode, 2, 2, f"quad rank {rank}")


def _jax_single(runs, quant: str) -> np.ndarray:
    """JAX's single-device apply of ``quant``'s layout on the host batch."""
    return runs["jax"] if quant == "none" else runs["ref"][quant][0]


def _assert_layout(runs, got: np.ndarray, key: tuple, single_device: np.ndarray, who: str):
    """A worker's scores against JAX's model on the single-process JAX mesh
    of the same shape (the JAX tests' limits), JAX's single-device apply
    (FWD_MAX_ERR) and the port's single-process mesh."""
    want = runs["ref"][key]
    assert got.shape == want.shape == single_device.shape, who
    np.testing.assert_allclose(got, want, rtol=MODEL_RTOL, atol=MODEL_ATOL, err_msg=who)
    err = float(np.max(np.abs(got - single_device)))
    assert err < FWD_MAX_ERR, (who, err)
    np.testing.assert_allclose(got, runs["single"][key], rtol=MODEL_RTOL, atol=MODEL_ATOL,
                               err_msg=who)


@pytest.mark.parametrize("quant", LAYOUTS)
@pytest.mark.parametrize("D,M", AXES)
def test_hotcold_model_across_processes_matches_jax_and_single_process(runs, quant, D, M):
    """make_hotcold_model(mesh=) across two processes: tensor-parallel on
    1x4 (the row sum crosses the processes), hybrid on 2x2 (each process
    holds a row; the scores' gather crosses)."""
    for rank, res in runs["workers"].items():
        _assert_layout(runs, res[("hotcold", quant, D, M)], ("hotcold", quant, D, M),
                       _jax_single(runs, quant), f"rank {rank} hotcold {quant} {D}x{M}")


@pytest.mark.parametrize("quant", LAYOUTS)
@pytest.mark.parametrize("D,M", AXES)
def test_tablewise_model_across_processes_matches_jax_and_single_process(runs, quant, D, M):
    """make_tablewise_model across two processes: on 1x4 the row's cells
    cross to entry (0, 0)'s process; on 2x2 only the scores cross."""
    for rank, res in runs["workers"].items():
        _assert_layout(runs, res[("tablewise", quant, D, M)], ("tablewise", quant, D, M),
                       _jax_single(runs, quant), f"rank {rank} tablewise {quant} {D}x{M}")


def test_tablewise_model_with_a_ragged_mask_across_processes(runs):
    key = ("tablewise masked", "none") + MASKED_AXES
    for rank, res in runs["workers"].items():
        _assert_layout(runs, res[key], key, runs["ref"][("single masked", "none")],
                       f"rank {rank} masked tablewise")


@pytest.mark.parametrize("quant", LAYOUTS)
def test_hotcold_split_is_equal_on_every_process(runs, quant):
    """Every process splits the host batch itself (nothing is sent for it):
    the splits are equal array for array, and equal to one process's."""
    for D, M in AXES:
        want = runs["single"][("split", quant, D, M)]
        for rank, res in runs["workers"].items():
            got = res[("split", quant, D, M)]
            assert sorted(got) == sorted(want), (rank, D, M)
            for k, w in want.items():
                assert got[k].dtype == w.dtype and np.array_equal(got[k], w), (rank, D, M, k)


@pytest.mark.parametrize("D,M", AXES)
def test_int8_pools_across_processes_are_exact(runs, D, M):
    """Per-table int8: the hot/cold lookup (on 1x4 row 0's int32 partials
    summed over both processes) equals the single-process mesh's bit for
    bit, and the table-wise lookup the single-device K1-int8 plain
    version's."""
    cfg = _cfg("int8")
    host = _host()
    tables = bridge.params_from_numpy(bridge.init_numpy(cfg, 0), cfg, "cpu")["tables"]
    want_tw = emb.embedding_bag_int8_reference(
        tables["q"], tables["scale"], torch.as_tensor(cfg.table_offsets, dtype=torch.int32),
        torch.from_numpy(host.indices), compute_dtype=torch.float32).numpy()
    for rank, res in runs["workers"].items():
        np.testing.assert_array_equal(res[("hotcold pooled", "int8", D, M)],
                                      runs["single"][("hotcold pooled", "int8", D, M)],
                                      err_msg=f"rank {rank}")
        np.testing.assert_array_equal(res[("tablewise pooled", "int8", D, M)], want_tw,
                                      err_msg=f"rank {rank}")


def test_a_step_reduces_its_leaves_once_a_rank_set(runs):
    """One all-reduce a step for every tower leaf (and, on 2x2, every table
    shard, whose copies span both processes there): a dense step makes the
    loss's and the leaves' (2x2: 2; 1x4: the row sum's too, 3; before the
    merge 13 and 12), a sparse step the same (2x2: 2; 1x4: 3; before 11 and
    12)."""
    want = {("dense", 2, 2): 2, ("dense", 1, 4): 3, ("sparse", 2, 2): 2, ("sparse", 1, 4): 3}
    for rank, res in runs["workers"].items():
        for (mode, D, M), n in want.items():
            assert res[("step reduces", mode, D, M)] == n, (rank, mode, D, M)


@pytest.mark.parametrize("D,M", AXES)
def test_merged_reduce_equals_the_per_leaf_reduce_bit_for_bit(runs, D, M):
    """Over two processes the merged reduce (one all-reduce a rank set and
    dtype) gives every leaf the bits of one all-reduce a leaf: 2x2 in one
    call where 12 leaves took 12 (the shards' copies span both processes),
    1x4 in one where 10 took 10 (each shard's copies lie in one)."""
    calls = {(2, 2): (1, 12), (1, 4): (1, 10)}[(D, M)]
    for rank, res in runs["workers"].items():
        equal, n_merged, n_per_leaf = res[("merged", D, M)]
        assert equal and (n_merged, n_per_leaf) == calls, (rank, n_merged, n_per_leaf)


def test_hotcold_row_sum_crosses_processes_only_where_a_row_does(runs):
    """A hot/cold forward makes one all-reduce on 1x4 (its row spans both
    processes) and none on 2x2."""
    for res in runs["workers"].values():
        assert res[("hotcold reduces", 1, 4)] == 1 and res[("hotcold reduces", 2, 2)] == 0


def test_four_processes_hotcold_and_tablewise_match_jax_and_single_process(runs):
    """Four processes of one entry each on 2x2: the hot/cold hybrid model's
    row sums and the table-wise model's cell gathers cross processes in both
    rows, and the scores' gather spans all four."""
    for rank, res in runs["quad"].items():
        for path in ("hotcold", "tablewise"):
            key = (path, "none", 2, 2)
            _assert_layout(runs, res[key], key, runs["jax"], f"quad rank {rank} {path}")
        got = res[("split", "none", 2, 2)]
        for k, w in runs["single"][("split", "none", 2, 2)].items():
            assert np.array_equal(got[k], w), (rank, k)


def test_hotcold_tablewise_and_engines_raise_across_processes(runs):
    """Across processes the hot/cold and table-wise models build (and run,
    above); only the mesh engine raises, because the JAX package serves a
    mesh from one process and has no engine across processes."""
    for res in runs["workers"].values():
        raises = res["raises"]
        assert raises["hotcold"] == "did not raise" and raises["tablewise"] == "did not raise"
        msg = raises["engine"]
        assert msg != "did not raise" and "JAX package" in msg, msg
        assert "not ported yet" not in msg, msg


def test_one_process_makes_no_collective_call(monkeypatch):
    """distributed_init with one process, and a mesh of one process (its
    forward, both trainers, unshard_params, the hot/cold models in both
    modes and the table-wise model), call nothing of torch.distributed."""
    import torch.distributed as dist

    def boom(*args, **kwargs):
        raise AssertionError("a collective call on one process")

    for name in ("init_process_group", "new_group", "all_reduce", "broadcast",
                 "broadcast_object_list", "all_gather_object", "all_gather"):
        monkeypatch.setattr(dist, name, boom)
    distributed_init()
    distributed_init("127.0.0.1:1", num_processes=1, process_id=0)
    cfg = _cfg()
    params = bridge.params_from_numpy(bridge.init_numpy(cfg, 0), cfg, "cpu")
    mesh = make_mesh(1, 4, devices=["cpu"] * 4)
    assert not mesh.multi_process and mesh.ranks.tolist() == [[0, 0, 0, 0]]
    sharded_apply(get_model(cfg, "cpu"), mesh, True)(shard_params(params, mesh), _host())
    for sparse in (False, True):
        tr = train.Trainer(cfg, mesh=mesh, learning_rate=LR, sparse_tables=sparse, params=params)
        assert np.isfinite(tr.fit(1, batch_size=TRAIN_BATCH).losses).all()
        unshard_params(tr.params)
    out = _layout_runs(lambda D, M: make_mesh(D, M, devices=["cpu"] * (D * M)),
                       {"none": params}, AXES)
    for D, M in AXES:
        assert np.isfinite(out[("hotcold", "none", D, M)]).all()
        assert np.isfinite(out[("tablewise", "none", D, M)]).all()
