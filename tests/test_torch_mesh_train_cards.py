"""A trainer over several cards of one process, on the CPU: the training
step cut into parts by card (``parallel/sharding.py::train_places``,
``mesh_train_stages``) and the staged programs that run them
(``train_programs.py::StagedStep``), for ``Trainer(mesh=)`` dense and
sparse (with and without ``dedup``) and ``make_train_step``.

On a card each part is a CUDA graph on its card's trainer stream, and the
tensors that cross cards are copied into static buffers on the receiving
card between the replays. Here the parts run eagerly on a CPU mesh whose
entries are labelled as cards (``card_plan(places=)`` patched, as in
``tests/test_torch_mesh_engine_cards.py``), so every part, send and receive
buffer of meshes over two and four cards runs: 2x2, 1x4, 1x2 and a crossed
2x2 whose rows' first entries sit on each other's cards. One device holds
every tensor, so the entries of a column share their shard and every entry
shares the towers: a tensor takes the contributions of several parts.

Tolerances:
- the staged step against the eager step (``Trainer._step`` called
  directly) on copies of the same params and state, bit for bit: losses,
  params, optimizer state (the same pieces in the same order; a tensor
  takes at most two contributions here, whose sum does not depend on their
  order);
- the staged ``Trainer`` against the JAX package's single-device
  ``Trainer`` on the same batches: ``tests/test_torch_train.py``'s limits
  (losses rtol 1e-5; params rtol 1e-5, atol 1e-6; a sparse table within
  1e-3 of the reach; accumulators within 1e-4 of the largest);
- ``make_train_step`` over labelled cards against the JAX package's on a
  mesh of the same shape: losses rtol 1e-5, params rtol 1e-5, atol 1e-6
  (``tests/test_torch_mesh_train.py``'s);
- the fixed-size touched-row copy (``train.shard_rows``) against the
  boolean-mask one, bit for bit.

rm1 trains at ``table_scale=2000``; dien at 5000, where its rows divide
over a model axis of 4 (at 2000 they do not). The card's own checks are in
``tests/test_torch_mesh_gpu.py`` and ``chip_smoke.py`` phase 17.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu.data import RecDataGenerator as JaxGenerator
from deeprecsys_tpu.models import get_model as jax_get_model
from deeprecsys_tpu.models.base import Batch as JaxBatch
from deeprecsys_tpu.parallel import make_mesh as jax_make_mesh
from deeprecsys_tpu.parallel import make_train_step as jax_make_train_step
from deeprecsys_tpu.parallel import shard_params as jax_shard_params
from deeprecsys_tpu_torch import bridge, train, zoo
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.models import get_model
from deeprecsys_tpu_torch.models.base import Batch
from deeprecsys_tpu_torch.parallel import make_mesh, make_train_step, shard_params, sharding
from deeprecsys_tpu_torch.parallel import unshard_params
from deeprecsys_tpu_torch.train_programs import StagedStep
from test_torch_train_programs import (  # noqa: F401  (jax_runs is a fixture)
    LR, _assert_close_to_jax, _batches, _tensors, jax_runs)

# Each layout: the mesh's axes and each entry's card label.
LAYOUTS = {"2x2": ((2, 2), [[0, 1], [2, 3]]), "1x4": ((1, 4), [[0, 1, 2, 3]]),
           "1x2": ((1, 2), [[0, 1]]), "2x2-crossed": ((2, 2), [[0, 1], [1, 0]])}
SCALE = {"rm1": 2000, "dien": 5000}
MODES = {"dense": ("rm1", False, False), "sparse": ("rm1", True, False),
         "dedup": ("rm1", True, True), "dien": ("dien", True, False)}


def _label(monkeypatch, layout: str):
    """Every mesh planned in the test labels its entries as ``layout``'s
    cards; returns a CPU mesh of its axes."""
    (D, M), grid = LAYOUTS[layout]
    plan = sharding.card_plan
    monkeypatch.setattr(sharding, "card_plan", lambda mesh, places=None, sharded=True: plan(
        mesh, places=np.asarray(grid), sharded=sharded))
    return make_mesh(D, M, devices=["cpu"] * (D * M))


# The parts of a step in order, (kind, place): a shard part on each card
# whose shards another card combines, a row part on each card that holds a
# row's first entry, the dense step's backward parts, the reduce parts on
# each leaf's first copy's card (one device here: a leaf is one tensor,
# reduced where several parts contribute to it) and the update parts (the
# optimizer once, at home; the sparse step's K5 on each entry (0, m)'s card).
PARTS = {
    ("2x2", "dense"): [("shard", 1), ("shard", 3), ("row", 2), ("row", 0), ("backward", 1),
                       ("backward", 3), ("reduce", 1), ("reduce", 0), ("update", 0)],
    ("2x2", "sparse"): [("shard", 1), ("shard", 3), ("row", 2), ("row", 0), ("reduce", 0),
                        ("update", 1), ("update", 0)],
    ("1x4", "dense"): [("shard", 1), ("shard", 2), ("shard", 3), ("row", 0), ("backward", 1),
                       ("backward", 2), ("backward", 3), ("update", 0)],
    ("1x4", "sparse"): [("shard", 1), ("shard", 2), ("shard", 3), ("row", 0), ("update", 1),
                        ("update", 2), ("update", 3), ("update", 0)],
    ("1x2", "dense"): [("shard", 1), ("row", 0), ("backward", 1), ("update", 0)],
    ("1x2", "sparse"): [("shard", 1), ("row", 0), ("update", 1), ("update", 0)],
    ("2x2-crossed", "dense"): [("shard", 1), ("shard", 0), ("row", 1), ("row", 0),
                               ("backward", 1), ("backward", 0), ("reduce", 1), ("reduce", 0),
                               ("update", 0)],
    ("2x2-crossed", "sparse"): [("shard", 1), ("shard", 0), ("row", 1), ("row", 0),
                                ("reduce", 0), ("update", 1), ("update", 0)],
}


def test_train_places_of_cards():
    """The step's places read from the forward's cut: each entry on its
    card, home entry (0, 0)'s; one card's virtual shards are one place."""
    cards = [torch.device("cuda", i) for i in range(4)]
    places = sharding.train_places(make_mesh(2, 2, devices=cards))
    assert places.grid == {(0, 0): cards[0], (0, 1): cards[1], (1, 0): cards[2],
                           (1, 1): cards[3]}
    assert list(places.devices) == cards and places.home == cards[0]
    assert places.order(set(cards)) == cards[1:] + cards[:1]
    crossed = sharding.train_places(make_mesh(2, 2, devices=[cards[0], cards[1], cards[1],
                                                             cards[0]]))
    assert list(crossed.devices) == cards[:2] and crossed.grid[(1, 1)] == cards[0]
    assert len(sharding.train_places(make_mesh(2, 2, devices=[cards[0]] * 4)).devices) == 1


def _trainers(mesh, mode: str, seed: int = 7):
    name, sparse, dedup = MODES[mode]
    cfg = zoo.get_config(name, table_scale=SCALE[name])
    start = bridge.params_from_numpy(bridge.init_numpy(cfg, seed), cfg, "cpu")
    kw = dict(optimizer="adagrad", learning_rate=0.05, sparse_tables=sparse, dedup=dedup,
              params=start)
    return [train.Trainer(cfg, mesh=mesh, **kw) for _ in range(2)]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_staged_step_equals_the_eager_step_bit_for_bit(monkeypatch, mode, layout):
    """Each entry a card: three steps through the staged programs (two
    batch shapes) against the step function called directly, on copies of
    the same params and state: the same losses, params and state, bit for
    bit. Each step is the plan's parts, a receive buffer a value that
    crosses cards."""
    staged, eager = _trainers(_label(monkeypatch, layout), mode)
    assert staged.eager_reason is None and staged.step_program.cut is not None
    gen = RecDataGenerator(staged.cfg, seed=3)
    for host in (gen.generate_batch(b) for b in (16, 16, 8)):
        labels = staged._labels(host, None)  # the trainers' default rule
        a = staged.step(host, labels)
        b = eager._step(eager.params, eager.opt_state, host.to("cpu"), eager._targets(labels))
        assert torch.equal(a, b)
    for x, y in zip(_tensors(staged.params.entries), _tensors(eager.params.entries)):
        assert torch.equal(x, y)
    state = (lambda s: [s.states, s] if isinstance(s, sharding.MeshOptimizer) else
             [s[0].states, s[1].parts])
    a, b = _tensors(state(staged.opt_state)[0]), _tensors(state(eager.opt_state)[0])
    if MODES[mode][1]:  # the row accumulators too
        a += _tensors(staged.opt_state[1].parts)
        b += _tensors(eager.opt_state[1].parts)
    assert len(a) == len(b) > 0 and all(torch.equal(x, y) for x, y in zip(a, b))
    progs = staged.step_program.programs
    assert sorted(p.runs for p in progs.values()) == [1, 2]
    for prog in progs.values():
        assert isinstance(prog, StagedStep) and not prog.graphs  # the CPU captures nothing
        kind = "dense" if mode == "dense" else "sparse"
        assert [s.part for s in prog.stages] == PARTS[(layout, kind)]
        assert set(prog.recv) == {k for s in prog.stages for k in s.sends}


@pytest.mark.parametrize("opt,sparse,dedup,layout", [
    ("adagrad", False, False, "2x2"), ("adagrad", True, False, "1x4"),
    ("adagrad", True, True, "2x2-crossed"), ("adam", False, False, "1x2")])
def test_staged_trainer_matches_jax(monkeypatch, jax_runs, opt, sparse, dedup,  # noqa: F811
                                    layout):
    """The staged ``Trainer`` over labelled cards, four steps of two batch
    shapes, against the JAX package's single-device ``Trainer`` on the same
    batches, from the same params."""
    start, want_losses, want_params, want_acc = jax_runs(opt, sparse, dedup)
    cfg = zoo.get_config("rm1", table_scale=2000)
    pt = train.Trainer(cfg, mesh=_label(monkeypatch, layout), optimizer=opt,
                       learning_rate=LR[opt], sparse_tables=sparse, dedup=dedup, params=start)
    assert pt.step_program.cut is not None
    got_losses = train._fit_batches(pt, _batches(cfg))
    _assert_close_to_jax(pt, want_losses, got_losses, want_params, want_acc, opt, sparse)
    assert sorted(p.runs for p in pt.step_program.programs.values()) == [1, 3]


@pytest.mark.parametrize("layout", ["2x2", "1x4", "2x2-crossed"])
def test_make_train_step_over_cards_matches_jax(monkeypatch, layout):
    """``make_train_step`` (SGD) over labelled cards, three steps on one
    batch, against the JAX package's on a mesh of the same shape."""
    (D, M), _ = LAYOUTS[layout]
    pcfg = zoo.get_config("rm1", table_scale=2000)
    jcfg = jax_zoo.get_config("rm1", table_scale=2000)
    np_params = bridge.init_numpy(pcfg, 0)
    gen = JaxGenerator(jcfg, seed=2)
    host = gen.generate_batch(16)
    targets = gen.generate_targets(16, round_targets=True)
    jmesh = jax_make_mesh(data=D, model=M, devices=jax.devices()[:D * M])
    jsp = jax_shard_params(jax.tree_util.tree_map(jnp.asarray, np_params), jmesh)
    jstep = jax_make_train_step(jax_get_model(jcfg).apply, jmesh, has_dense=True,
                                learning_rate=0.1, loss="bce")(jsp)
    mesh = _label(monkeypatch, layout)
    sp = shard_params(bridge.params_from_numpy(np_params, pcfg, "cpu"), mesh)
    step = make_train_step(get_model(pcfg, "cpu"), mesh, has_dense=True, learning_rate=0.1,
                           loss="bce")(sp)
    assert step.programs.cut is not None
    jbatch = JaxBatch(dense=jnp.asarray(host.dense), indices=jnp.asarray(host.indices))
    pbatch = Batch(dense=torch.from_numpy(host.dense), indices=torch.from_numpy(host.indices))
    want, got = [], []
    for _ in range(3):
        jsp, jl = jstep(jsp, jbatch, jnp.asarray(targets))
        want.append(float(jl))
        got.append(float(step(sp, pbatch, torch.from_numpy(np.asarray(targets)))[1]))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert got[-1] < got[0]
    (prog,) = step.programs.programs.values()
    assert isinstance(prog, StagedStep) and prog.runs == 3
    wflat = bridge.flatten(jax.device_get(jsp))
    gflat = bridge.flatten(bridge.params_to_numpy(unshard_params(sp), pcfg))
    for key, w in wflat.items():
        np.testing.assert_allclose(gflat[key], np.asarray(w), rtol=1e-5, atol=1e-6, err_msg=key)


def _by_mask(table, acc, copy_t, copy_a, offsets, indices, row_lo):
    """The boolean-mask copy the fixed-size one replaced (a shape that
    depends on the ids)."""
    local = (indices.long() + offsets.long()[None, :, None]).reshape(-1) - row_lo
    rows = local[(local >= 0) & (local < table.shape[0])]
    copy_t.index_copy_(0, rows, table.index_select(0, rows))
    copy_a.index_copy_(0, rows, acc.index_select(0, rows))


@pytest.mark.parametrize("fold", [1, 5, None], ids=["one-row", "five-rows", "generator"])
@pytest.mark.parametrize("shard", [0, 1, 3])
def test_fixed_size_touched_rows_equal_the_mask(fold, shard):
    """A shard's copy after K5's window on its first copy: the fixed-size
    copy (every slot's row clamped into the shard) and the boolean-mask one
    give the same copy, bit for bit, on ids with many duplicates (folded
    onto one or five rows a table) and with ids outside the shard."""
    cfg = zoo.get_config("rm1", table_scale=2000)
    rps = cfg.total_rows // 4
    row_lo = shard * rps
    gen = torch.Generator().manual_seed(shard)
    table = (torch.rand((rps, cfg.sparse_feature_size), generator=gen) - 0.5) * 0.1
    acc = torch.rand((rps,), generator=gen) * 1e-3
    offsets = torch.as_tensor(cfg.table_offsets, dtype=torch.int32)
    indices = torch.as_tensor(_batches(cfg, (32,), seed=9)[0][0].indices)
    if fold is not None:
        indices = indices % fold
    g = torch.randn((32, cfg.num_tables, cfg.sparse_feature_size), generator=gen) * 1e-2
    before_t, before_a = table.clone(), acc.clone()
    train.sparse_adagrad_step_shard(table, acc, offsets, indices, g, row_lo, 0.1)
    fixed_t, fixed_a = before_t.clone(), before_a.clone()
    train._set_rows([fixed_t], [fixed_a], *train.shard_rows(table, acc, offsets, indices, row_lo))
    mask_t, mask_a = before_t.clone(), before_a.clone()
    _by_mask(table, acc, mask_t, mask_a, offsets, indices, row_lo)
    assert torch.equal(fixed_t, mask_t) and torch.equal(fixed_a, mask_a)
    assert torch.equal(fixed_t, table) and torch.equal(fixed_a, acc)
    rows, t_rows, _ = train.shard_rows(table, acc, offsets, indices, row_lo)
    assert rows.shape == (indices.numel(),) and t_rows.shape == (indices.numel(), table.shape[1])
