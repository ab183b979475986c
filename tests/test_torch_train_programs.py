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
- Against the eager step, bit for bit: the program path and the step
  function called directly on a copy of the params and state; the
  scatter-based ``dedup_touched_rows`` against the boolean-mask one it
  replaced, on ids with many duplicates.
- adam's count is an int32 on the params' device, advanced once a step.
- The steps that stay eager are decided when the trainer is built: a bf16
  table's sharded sparse step (K5's bf16 window) and a mesh over several
  cards record their reasons (the mesh across processes: in
  ``tests/test_torch_distributed.py``'s workers).
"""

import jax
import numpy as np
import pytest
import torch

from deeprecsys_tpu import train as jax_train
from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu_torch import bridge, train, zoo
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.models import get_model
from deeprecsys_tpu_torch.parallel import make_mesh, make_train_step, shard_params
from deeprecsys_tpu_torch.train_programs import eager_reason

SCALE = 2000
SIZES = (32, 32, 16, 32)
LR = {"adagrad": 0.01, "adam": 1e-3}


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
    """The JAX single-device trainer for each (optimizer, sparse, dedup)
    asked for, run once over the batches: (start params, losses, params,
    table accumulator)."""
    cache = {}

    def run(opt: str, sparse: bool, dedup: bool):
        key = (opt, sparse, dedup)
        if key not in cache:
            jt = jax_train.Trainer(jax_zoo.get_config("rm1", table_scale=SCALE), optimizer=opt,
                                   learning_rate=LR[opt], sparse_tables=sparse, dedup=dedup)
            start = bridge.params_from_numpy(jax.device_get(jt.params), jt.cfg, "cpu")
            cfg = zoo.get_config("rm1", table_scale=SCALE)
            losses = jax_train._fit_batches(jt, _batches(cfg))
            acc = np.asarray(jt.opt_state[1]) if sparse else None
            cache[key] = (start, losses, bridge.flatten(jax.device_get(jt.params)), acc)
        return cache[key]

    return run


def _assert_close_to_jax(pt, want_losses, got_losses, want_params, want_acc, opt, sparse):
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-5)
    got = bridge.flatten(bridge.params_to_numpy(pt.full_params(), pt.cfg))
    assert sorted(got) == sorted(want_params)
    reach = len(SIZES) * LR[opt]
    for key, w in want_params.items():
        w = np.asarray(w)
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
        np.testing.assert_allclose(acc.numpy(), want_acc, rtol=0, atol=1e-4 * want_acc.max())


@pytest.mark.parametrize("opt,sparse,dedup,axes", [
    ("adagrad", False, False, None), ("adam", False, False, None),
    ("adagrad", True, False, None), ("adagrad", True, True, None),
    ("adam", False, False, (1, 4)), ("adagrad", True, True, (1, 4))])
def test_program_trainer_matches_jax(jax_runs, opt, sparse, dedup, axes):
    """Four steps through the programs, two batch shapes, against JAX's
    trainer; one program a shape, each run as often as its shape came."""
    start, want_losses, want_params, want_acc = jax_runs(opt, sparse, dedup)
    cfg = zoo.get_config("rm1", table_scale=SCALE)
    mesh = None if axes is None else make_mesh(*axes, devices=["cpu"] * (axes[0] * axes[1]))
    pt = train.Trainer(cfg, mesh=mesh, optimizer=opt, learning_rate=LR[opt],
                       sparse_tables=sparse, dedup=dedup, device=None if mesh else "cpu",
                       params=start)
    assert pt.eager_reason is None and pt.step_program is not None
    got_losses = train._fit_batches(pt, _batches(cfg))
    _assert_close_to_jax(pt, want_losses, got_losses, want_params, want_acc, opt, sparse)
    progs = pt.step_program.programs
    assert sorted(key[1][0][0] for key in progs) == [16, 32]
    assert sorted(p.runs for p in progs.values()) == [1, 3]
    assert pt.step_program.captures == 0  # the CPU captures nothing
    if opt == "adam":
        count = (pt.opt_state if mesh is None else next(iter(pt.opt_state.states.values())))
        assert count["count"].dtype == torch.int32 and int(count["count"]) == len(SIZES)


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


def test_the_eager_cases_are_decided_at_construction():
    """A bf16 table's sharded sparse step (K5's bf16 window refuses a
    capture) and a mesh over two cards stay eager, with their reasons; a
    float32 sparse mesh and a bf16 table on one device take programs."""
    cfg = zoo.get_config("rm1", table_scale=SCALE, param_dtype="bfloat16",
                         compute_dtype="bfloat16")
    mesh = make_mesh(1, 4, devices=["cpu"] * 4)
    tr = train.Trainer(cfg, mesh=mesh, sparse_tables=True)
    assert tr.step_program is None and "bf16 shard" in tr.eager_reason
    host, labels = _batches(tr.cfg, (8,))[0]
    assert np.isfinite(float(tr.step(host, labels)))  # the eager step still trains
    assert train.Trainer(cfg, sparse_tables=True, device="cpu").eager_reason is None
    assert train.Trainer(zoo.get_config("rm1", table_scale=SCALE), mesh=mesh,
                         sparse_tables=True).step_program is not None
    two_cards = make_mesh(1, 2, devices=[torch.device("cuda", 0), torch.device("cuda", 1)])
    assert "several cards" in eager_reason(two_cards)
    assert eager_reason(None) is None
    assert eager_reason(make_mesh(2, 2, devices=["cpu"] * 4), torch.bfloat16) is None


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
