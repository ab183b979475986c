"""The trainer's step programs (``deeprecsys_tpu_torch/train_programs.py``)
on the CPU, where each program runs the eager step over its static buffers.

- Against the JAX package: the program-driven ``Trainer`` (rm1,
  ``table_scale=2000``, f32, the port's generator's batches, which are the
  JAX generator's) over four steps whose batch shape changes (32, 32, 16,
  32: two programs), dense adagrad and adam, sparse with and without
  ``dedup``, and the one-process 1x4 mesh dense (adam) and sparse (dedup),
  each against the JAX single-device ``Trainer`` on the same batches
  (``_fit_batches`` in both packages; JAX compiles a step a shape).
  Tolerances are ``tests/test_torch_train.py``'s: losses rtol 1e-5; dense
  adagrad params rtol 1e-5, atol 1e-6; adam atol 2% of the steps' reach
  (its update turns the f32 rounding of a near-zero gradient into an O(lr)
  change); the sparse table within 1e-3 of the reach and the row
  accumulators within 1e-4 of the largest.
- A bf16 table on a sparse mesh (1x4 and 2x2; f32 compute), its step K5's
  bf16 window (each row's updates summed in f32, the row rounded once),
  against the JAX mesh ``Trainer`` of the same shape (whose sharded step
  has that rule; the single-device step rounds at each add). One step
  agrees within a bf16 ulp of each table element, which the per-add rule
  fails (``test_bf16_sparse_mesh_one_step_matches_jax_within_an_ulp``);
  over four, a param one ulp apart changes the next step's gradients,
  which AdaGrad's normalisation turns into O(lr) moves of the rows with
  near-zero gradients. So, stated for bf16 over four steps (``BF16_*``):
  losses rtol 1e-3; every leaf but the table within 2 bf16 ulps of its
  largest magnitude; the table within half the steps' reach; the row
  accumulators within 10% of the largest.
- Against the eager step, bit for bit: the program path and the step
  function called directly on a copy of the params and state; the
  scatter-based ``dedup_touched_rows`` against the boolean-mask one it
  replaced, on ids with many duplicates.
- adam's count is an int32 on the params' device, advanced once a step.
- The steps that stay eager are decided when the trainer is built: a mesh
  across processes records its reason (over gloo, or whose process holds
  several cards: it cannot be captured; over nccl, a card each: its
  replays' measured slowdown; a real gloo mesh:
  ``tests/test_torch_distributed.py``'s workers); a bf16 table's sharded
  sparse step and a mesh over several cards (a graph a part of the step:
  ``tests/test_torch_mesh_train_cards.py``) take programs.
"""

import jax
import numpy as np
import pytest
import torch

from deeprecsys_tpu import train as jax_train
from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu.parallel import make_mesh as jax_make_mesh
from deeprecsys_tpu_torch import bridge, train, zoo
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.models import get_model
from deeprecsys_tpu_torch.parallel import make_mesh, make_train_step, shard_params
from deeprecsys_tpu_torch.train_programs import NCCL_SLOWER, capture_reason, eager_reason

SCALE = 2000
SIZES = (32, 32, 16, 32)
LR = {"adagrad": 0.01, "adam": 1e-3}
BF16 = dict(param_dtype="bfloat16")
BF16_LOSS_RTOL = 1e-3
BF16_ULPS = 2 * 2.0 ** -8       # two bf16 ulps, relative to a leaf's largest magnitude
BF16_TABLE_REACH = 0.5          # of the steps' reach
BF16_ACC_SHARE = 0.1            # of the largest accumulator
BF16_ONE_STEP_ULPS = 2.0        # a tower leaf after one step, in bf16 ulps of each value


def _batches(cfg, sizes=SIZES, seed=1):
    """(host batch, labels) pairs of ``sizes`` rows: the trainers' default
    label rule (the dense features' median)."""
    gen = RecDataGenerator(cfg, seed=seed)
    out = []
    for b in sizes:
        host = gen.generate_batch(b)
        m = host.dense.mean(axis=1)
        out.append((host, (m > np.median(m)).astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX trainer for each (optimizer, sparse, dedup, bf16 mesh)
    asked for, run once over the batches: (start params, losses, params,
    table accumulator). ``bf16_axes``: a bf16 table on the JAX mesh of that
    shape; None: f32 on one device."""
    cache = {}

    def run(opt: str, sparse: bool, dedup: bool, bf16_axes=None):
        key = (opt, sparse, dedup, bf16_axes)
        if key not in cache:
            kw = {} if bf16_axes is None else BF16
            mesh = None if bf16_axes is None else jax_make_mesh(
                *bf16_axes, devices=jax.devices()[:bf16_axes[0] * bf16_axes[1]])
            jt = jax_train.Trainer(jax_zoo.get_config("rm1", table_scale=SCALE, **kw), mesh=mesh,
                                   optimizer=opt, learning_rate=LR[opt], sparse_tables=sparse,
                                   dedup=dedup)
            start = bridge.params_from_numpy(jax.device_get(jt.params), jt.cfg, "cpu")
            cfg = zoo.get_config("rm1", table_scale=SCALE, **kw)
            losses = jax_train._fit_batches(jt, _batches(cfg))
            acc = np.asarray(jt.opt_state[1]) if sparse else None
            cache[key] = (start, losses, bridge.flatten(jax.device_get(jt.params)), acc)
        return cache[key]

    return run


def _assert_close_to_jax(pt, want_losses, got_losses, want_params, want_acc, opt, sparse,
                         bf16=False):
    np.testing.assert_allclose(got_losses, want_losses, rtol=BF16_LOSS_RTOL if bf16 else 1e-5)
    got = bridge.flatten(bridge.params_to_numpy(pt.full_params(), pt.cfg))
    assert sorted(got) == sorted(want_params)
    reach = len(SIZES) * LR[opt]
    for key, w in want_params.items():
        w = np.asarray(w)
        if bf16:
            w = w.astype(np.float32)
            atol = (BF16_TABLE_REACH * reach if key == "tables"
                    else BF16_ULPS * float(np.abs(w).max()))
            np.testing.assert_allclose(np.asarray(got[key], np.float32), w, rtol=0, atol=atol,
                                       err_msg=key)
            continue
        if opt == "adam":
            atol = 0.02 * reach
        elif sparse and key == "tables":
            atol = 1e-3 * reach
        else:
            atol = 1e-6
        np.testing.assert_allclose(got[key], w, rtol=1e-5, atol=atol, err_msg=key)
    if sparse:
        acc = pt.opt_state[1]
        if pt.mesh is not None:
            acc = torch.cat([acc.part(0, m) for m in range(pt.mesh.shape["model"])])
        share = BF16_ACC_SHARE if bf16 else 1e-4
        np.testing.assert_allclose(acc.numpy(), want_acc, rtol=0, atol=share * want_acc.max())


@pytest.mark.parametrize("opt,sparse,dedup,axes,bf16", [
    ("adagrad", False, False, None, False), ("adam", False, False, None, False),
    ("adagrad", True, False, None, False), ("adagrad", True, True, None, False),
    ("adam", False, False, (1, 4), False), ("adagrad", True, True, (1, 4), False),
    ("adagrad", True, False, (1, 4), True), ("adagrad", True, False, (2, 2), True)])
def test_program_trainer_matches_jax(jax_runs, opt, sparse, dedup, axes, bf16):
    """Four steps through the programs, two batch shapes, against JAX's
    trainer; one program a shape, each run as often as its shape came. A
    bf16 table's sparse mesh step is held to the JAX mesh trainer at the
    ``BF16_*`` limits."""
    start, want_losses, want_params, want_acc = jax_runs(opt, sparse, dedup,
                                                         axes if bf16 else None)
    cfg = zoo.get_config("rm1", table_scale=SCALE, **(BF16 if bf16 else {}))
    mesh = None if axes is None else make_mesh(*axes, devices=["cpu"] * (axes[0] * axes[1]))
    pt = train.Trainer(cfg, mesh=mesh, optimizer=opt, learning_rate=LR[opt],
                       sparse_tables=sparse, dedup=dedup, device=None if mesh else "cpu",
                       params=start)
    assert pt.eager_reason is None and pt.step_program is not None
    got_losses = train._fit_batches(pt, _batches(cfg))
    _assert_close_to_jax(pt, want_losses, got_losses, want_params, want_acc, opt, sparse, bf16)
    progs = pt.step_program.programs
    assert sorted(key[1][0][0] for key in progs) == [16, 32]
    assert sorted(p.runs for p in progs.values()) == [1, 3]
    assert pt.step_program.captures == 0  # the CPU captures nothing
    if opt == "adam":
        count = (pt.opt_state if mesh is None else next(iter(pt.opt_state.states.values())))
        assert count["count"].dtype == torch.int32 and int(count["count"]) == len(SIZES)


def _bf16_ulps(got, want, start) -> np.ndarray:
    """|got - want| in bf16 ulps of the larger of |want| and |start| (a
    value near zero after the step that moved it keeps its operands' ulp)."""
    got, want, start = (np.asarray(x, np.float32) for x in (got, want, start))
    ref = np.maximum(np.abs(want), np.abs(start))
    return np.abs(got - want) / (np.spacing(ref) * 2.0 ** 16)


@pytest.mark.parametrize("axes", [(1, 4), (2, 2)])
def test_bf16_sparse_mesh_one_step_matches_jax_within_an_ulp(axes):
    """One step of a bf16 table on a sparse mesh against the JAX mesh
    ``Trainer`` (the sharded rule: each row's updates summed in f32, the row
    rounded once), before the steps' chaos: the loss within rtol 1e-5; every
    table element within 1 bf16 ulp (``_bf16_ulps``; measured on the CPU:
    at most 1.0, 86-87 elements apart at all); the tower leaves within
    ``BF16_ONE_STEP_ULPS`` (at most 2.0 measured: the port's optimizer
    update rounds its own f32 result); the row accumulators within rtol
    1e-5 (7.2e-7 measured). The limit tells the rules apart: the JAX
    single-device step, which rounds the row at each add, lands up to 109
    ulps from the mesh step, 4463 table elements past 1 ulp, and is
    asserted to fail it here."""
    cfg_j = jax_zoo.get_config("rm1", table_scale=SCALE, **BF16)
    kw = dict(optimizer="adagrad", learning_rate=LR["adagrad"], sparse_tables=True)
    jm = jax_train.Trainer(cfg_j, mesh=jax_make_mesh(*axes, devices=jax.devices()[:4]), **kw)
    js = jax_train.Trainer(cfg_j, **kw)
    s0 = bridge.flatten(jax.device_get(jm.params))
    start = bridge.params_from_numpy(jax.device_get(jm.params), jm.cfg, "cpu")
    cfg = zoo.get_config("rm1", table_scale=SCALE, **BF16)
    batch = _batches(cfg)[:1]
    want_loss = jax_train._fit_batches(jm, batch)
    jax_train._fit_batches(js, batch)
    want, per_add = (bridge.flatten(jax.device_get(t.params)) for t in (jm, js))
    pt = train.Trainer(cfg, mesh=make_mesh(*axes, devices=["cpu"] * 4), params=start, **kw)
    np.testing.assert_allclose(train._fit_batches(pt, batch), want_loss, rtol=1e-5)
    got = bridge.flatten(bridge.params_to_numpy(pt.full_params(), pt.cfg))
    assert sorted(got) == sorted(want)
    for key in want:
        limit = 1.0 if key == "tables" else BF16_ONE_STEP_ULPS
        assert _bf16_ulps(got[key], want[key], s0[key]).max() <= limit, key
    assert (_bf16_ulps(per_add["tables"], want["tables"], s0["tables"]) > 1.0).sum() > 0
    acc = torch.cat([pt.opt_state[1].part(0, m) for m in range(axes[1])]).numpy()
    np.testing.assert_allclose(acc, np.asarray(jm.opt_state[1]), rtol=1e-5, atol=0)


@pytest.mark.parametrize("opt,sparse,dedup", [("adam", False, False), ("adagrad", True, True)])
def test_program_steps_equal_the_eager_step_bit_for_bit(opt, sparse, dedup):
    """The program path and the step function called directly (on a copy
    of the params and state, the batch moved as ``Trainer.step`` moved it
    before programs) give the same bits: losses, params, state."""
    cfg = zoo.get_config("rm1", table_scale=SCALE)
    start = bridge.params_from_numpy(bridge.init_numpy(cfg, 7), cfg, "cpu")
    kw = dict(optimizer=opt, learning_rate=0.05, sparse_tables=sparse, dedup=dedup,
              device="cpu", params=start)
    prog, eager = train.Trainer(cfg, **kw), train.Trainer(cfg, **kw)
    for host, labels in _batches(cfg, seed=3):
        a = prog.step(host, labels)
        b = eager._step(eager.params, eager.opt_state, host.to("cpu"), eager._targets(labels))
        assert torch.equal(a, b)
    for key, t in bridge.flatten(prog.params).items():
        assert torch.equal(t, bridge.flatten(eager.params)[key]), key
    a, b = _tensors(prog.opt_state), _tensors(eager.opt_state)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _tensors(tree) -> list:
    """The tensors of a nest of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree if tree is not None else []
    return [t for x in items for t in _tensors(x)]


def _dedup_by_mask(flat, g_rows):
    """The boolean-mask unique ids the scatter replaced (a shape that
    depends on the data)."""
    N, d = g_rows.shape
    sid, order = torch.sort(flat, stable=True)
    newrun = torch.ones((N,), dtype=torch.bool)
    newrun[1:] = sid[1:] != sid[:-1]
    seg = torch.cumsum(newrun, 0) - 1
    summed = torch.zeros((N, d), dtype=torch.float32)
    summed.index_add_(0, seg, g_rows.float().index_select(0, order))
    uids = torch.zeros_like(flat)
    uids[seg[newrun]] = sid[newrun]
    return uids, summed


@pytest.mark.parametrize("rows", [1, 7, 300])
def test_dedup_touched_rows_scatter_equals_the_mask(rows):
    """Ids with many duplicates (one row, 7 rows, 300 rows over 4096
    slots): the same unique ids, inert tail and summed rows, bit for bit."""
    rng = np.random.default_rng(rows)
    flat = torch.from_numpy(rng.integers(0, rows, 4096)).to(torch.int64)
    g = torch.from_numpy(rng.standard_normal((4096, 8)).astype(np.float32))
    got, want = train.dedup_touched_rows(flat, g), _dedup_by_mask(flat, g)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    n = int(torch.unique(flat).numel())
    assert torch.equal(got[0][:n], torch.unique(flat)) and not got[0][n:].any()


def test_make_train_step_runs_through_programs():
    """``make_train_step(...)(sp)`` on a one-process 1x4 mesh keeps a
    program a batch shape and takes only the params it was built for."""
    cfg = zoo.get_config("rm1", table_scale=SCALE)
    mesh = make_mesh(1, 4, devices=["cpu"] * 4)
    start = bridge.params_from_numpy(bridge.init_numpy(cfg, 2), cfg, "cpu")
    sp = shard_params(start, mesh)
    step = make_train_step(get_model(cfg, "cpu"), mesh, has_dense=True, learning_rate=0.05,
                           loss="bce")(sp)
    losses = [float(step(sp, h, torch.from_numpy(lab)[:, None])[1])
              for h, lab in _batches(cfg, seed=5)]
    assert np.all(np.isfinite(losses))
    assert sorted(p.runs for p in step.programs.programs.values()) == [1, 3]
    with pytest.raises(ValueError, match="built for"):
        step(shard_params(start, mesh), *_batches(cfg, (32,))[0])


def test_the_eager_cases_are_decided_at_construction(monkeypatch):
    """A bf16 table's sharded sparse step of one process (K5's bf16 window,
    captured with scratch of its own), a float32 sparse mesh, a bf16 table
    on one device and a mesh over two cards (cut into parts by card) take
    programs. Across processes (the backend set where the CPU cannot make
    one) every mesh is eager: over nccl with one card a process the step
    can be captured (``capture_reason`` None) but is kept eager for its
    measured slowdown (``NCCL_SLOWER``); over gloo, with a reason that
    names gloo; a process that holds several cards, with a reason of its
    own; those two cannot be captured, and ``take_programs`` raises where
    ``capture_reason`` gives a reason."""
    from deeprecsys_tpu_torch.parallel import mesh as mesh_mod

    cfg = zoo.get_config("rm1", table_scale=SCALE, param_dtype="bfloat16",
                         compute_dtype="bfloat16")
    mesh = make_mesh(1, 4, devices=["cpu"] * 4)
    tr = train.Trainer(cfg, mesh=mesh, sparse_tables=True)
    assert tr.eager_reason is None and tr.step_program is not None
    host, labels = _batches(tr.cfg, (8,))[0]
    assert np.isfinite(float(tr.step(host, labels)))
    assert len(tr.step_program.programs) == 1
    assert train.Trainer(cfg, sparse_tables=True, device="cpu").eager_reason is None
    assert train.Trainer(zoo.get_config("rm1", table_scale=SCALE), mesh=mesh,
                         sparse_tables=True).step_program is not None
    two_cards = make_mesh(1, 2, devices=[torch.device("cuda", 0), torch.device("cuda", 1)])
    assert eager_reason(two_cards) is None
    assert eager_reason(None) is None
    assert eager_reason(make_mesh(2, 2, devices=["cpu"] * 4)) is None

    def across(backend: str, local: list) -> "mesh_mod.Mesh":
        """A 1 x 2·len(local) mesh over two processes, this one rank 0 with
        the entries ``local``, rank 1 the rest, on ``backend``: the
        process group's answers monkeypatched (no group exists here)."""
        for name, value in (("get_rank", 0), ("get_world_size", 2), ("get_backend", backend)):
            monkeypatch.setattr(mesh_mod.dist, name, lambda value=value: value)
        monkeypatch.setattr(mesh_mod.dist, "new_group", lambda ranks: tuple(ranks))
        devices = np.empty(2 * len(local), dtype=object)
        for i, dev in enumerate(local * 2):
            devices[i] = torch.device(dev)
        return mesh_mod.Mesh(devices.reshape(1, -1), np.repeat([0, 1], len(local)))

    nccl = across("nccl", ["cuda:0"])
    assert capture_reason(nccl) is None and eager_reason(nccl) == NCCL_SLOWER
    assert "slower" in NCCL_SLOWER and "nccl" in NCCL_SLOWER
    gloo = eager_reason(across("gloo", ["cpu"]))
    assert "across processes" in gloo and "gloo" in gloo
    assert capture_reason(across("gloo", ["cpu"])) == gloo
    several = eager_reason(across("nccl", ["cuda:0", "cuda:1"]))
    assert "several cards" in several and several != gloo
    assert capture_reason(across("nccl", ["cuda:0", "cuda:1"])) == several
    monkeypatch.setattr(train, "capture_reason", lambda m: gloo)
    with pytest.raises(ValueError, match="cannot be captured"):
        tr.take_programs()


def test_a_trainer_is_freed_with_its_last_reference():
    """The programs hold the trainer weakly: dropping the trainer frees its
    tables (and, on a card, its graph pool) without waiting for the cycle
    collector."""
    import gc
    import weakref

    cfg = zoo.get_config("rm1", table_scale=SCALE)
    tr = train.Trainer(cfg, device="cpu")
    tr.step(*_batches(cfg, (8,))[0])
    table, gone = weakref.ref(tr.params["tables"]), weakref.ref(tr)
    gc.disable()
    try:
        del tr
        assert gone() is None and table() is None
    finally:
        gc.enable()


def test_replacing_params_drops_the_programs():
    """A graph reads the tensors it was captured with: new params or state
    drop the programs, and the next step builds anew."""
    cfg = zoo.get_config("rm1", table_scale=SCALE)
    tr = train.Trainer(cfg, optimizer="adagrad", device="cpu")
    host, labels = _batches(cfg, (16,))[0]
    tr.step(host, labels)
    assert len(tr.step_program.programs) == 1
    tr.params = bridge.tree_map(lambda t: t.clone(), tr.params)
    assert not tr.step_program.programs
    tr.step(host, labels)
    tr.opt_state = [t.clone() for t in tr.opt_state]
    assert not tr.step_program.programs
