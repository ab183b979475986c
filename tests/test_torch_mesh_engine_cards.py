"""A mesh engine over several cards, on the CPU: the plan that cuts the mesh
forward into parts by card (``parallel/sharding.py::card_plan``), the parts
themselves (``mesh_stages``) and the engine that serves them
(``ComputeEngine(mesh=)``, ``serving/programs.py``).

On a card each part is a CUDA graph on its card's engine stream, and the
partials and slices that cross cards are copied into static buffers on the
receiving card between the replays. Here the plan is read with
``torch.device("cuda", i)`` entries, which touch no card, and the parts run
eagerly on a CPU mesh whose entries are named as cards of their own
(``card_plan(places=)``; one device holds every tensor), so every part, send
and receive buffer of a mesh over eight cards runs.

Tolerances: the parts against ``sharded_apply`` and the mesh hot/cold
model on the same inputs bit for bit (the same pieces summed in the same
order); the engine's scores against the JAX package's mesh engine at rtol
and atol 1e-5 (f32, the shards' partials added in shard order against
XLA's ``psum``), as ``tests/test_torch_mesh_engine_programs.py``. The
card's own checks are in ``tests/test_torch_mesh_gpu.py``.
"""

import numpy as np
import pytest
import torch

from deeprecsys_tpu_torch import bridge, zoo
from deeprecsys_tpu_torch.models import get_model
from deeprecsys_tpu_torch.models.base import Batch
from deeprecsys_tpu_torch.models.hotcold import hot_ids_from_generator, make_hotcold_model
from deeprecsys_tpu_torch.parallel import make_mesh, sharded_apply, sharding
from deeprecsys_tpu_torch.serving.programs import BucketProgram
from test_torch_mesh_engine_programs import (
    MESHES, SCALE, _assert_same_scores, _one_cell, _port_and_jax, _rows)

CARDS = [torch.device("cuda", i) for i in range(4)]


def _parts(plan) -> list:
    return [(p.device.index, p.shards, p.rows, p.concat) for p in plan]


@pytest.mark.parametrize("devices,axes,want", [
    # four cards: a sender a shard, the rows combined on their first entries
    (CARDS, (2, 2), [(1, ((0, 1),), (), False), (3, ((1, 1),), (), False),
                     (2, (), (1,), False), (0, (), (0,), True)]),
    (CARDS, (1, 4), [(1, ((0, 1),), (), False), (2, ((0, 2),), (), False),
                     (3, ((0, 3),), (), False), (0, (), (0,), True)]),
    (CARDS[:2], (1, 2), [(1, ((0, 1),), (), False), (0, (), (0,), True)]),
    # two cards, each row over both: card 1 sends both rows' shard 1
    (CARDS[:2] * 2, (2, 2), [(1, ((0, 1), (1, 1)), (), False), (0, (), (0, 1), True)]),
    # rows whose first entries are on different cards, each sending to the other
    ([CARDS[0], CARDS[1], CARDS[1], CARDS[0]], (2, 2),
     [(0, ((1, 1),), (), False), (1, ((0, 1),), (), False), (1, (), (1,), False),
      (0, (), (0,), True)]),
    # one card's virtual shards: one part, the whole forward
    ([CARDS[0]] * 4, (2, 2), [(0, (), (0, 1), True)]),
    ([CARDS[0]] * 4, (1, 4), [(0, (), (0,), True)]),
], ids=["2x2-four", "1x4-four", "1x2-two", "2x2-two", "2x2-crossed", "2x2-one", "1x4-one"])
def test_card_plan(devices, axes, want):
    plan = sharding.card_plan(make_mesh(*axes, devices=devices))
    assert _parts(plan) == want
    assert plan[-1].concat and plan[-1].device == devices[0]


def test_card_plan_of_a_replicated_table_and_of_labels():
    """A replicated table pools each row on its entry (d, 0): no shard is
    sent. ``places`` names the cards: eight labels over one CPU device give
    eight parts."""
    mesh = make_mesh(1, 4, devices=CARDS)
    assert _parts(sharding.card_plan(mesh, sharded=False)) == [(0, (), (0,), True)]
    cpu = make_mesh(2, 4, devices=["cpu"] * 8)
    plan = sharding.card_plan(cpu, places=np.arange(8).reshape(2, 4))
    assert [p.place for p in plan] == [1, 2, 3, 5, 6, 7, 4, 0]
    assert all(p.device == torch.device("cpu") for p in plan)
    assert [p.rows for p in plan[-2:]] == [(1,), (0,)]
    assert len(sharding.card_plan(cpu)) == 1


def _labelled(D: int, M: int):
    """A D x M CPU mesh and its plan with every entry a card of its own."""
    mesh = make_mesh(D, M, devices=["cpu"] * (D * M))
    return mesh, sharding.card_plan(mesh, places=np.arange(D * M).reshape(D, M))


def _program(model, sp, plan, host: dict, hotcold: bool = False) -> BucketProgram:
    """The parts over empty static buffers of ``host``'s shapes, a set a
    place, loaded from ``host`` (each place only the pieces it reads)."""
    at = {p.place: {k: torch.full_like(v, -1) if v.dtype != torch.bool else torch.zeros_like(v)
                    for k, v in host.items()} for p in plan}
    stages, pieces = sharding.mesh_stages(model, sp, plan, at, hotcold=hotcold)
    loads = [(at[place][name][index] if index else at[place][name], name, index)
             for place, name, index in pieces]
    return BucketProgram(("direct", 0), stages, at[plan[-1].place], loads,
                         torch.device("cpu"), capture=False), pieces


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: f"{a[0]}x{a[1]}")
@pytest.mark.parametrize("quant", ["none", "int8", "int8_rowwise"])
def test_parts_equal_sharded_apply_bit_for_bit(quant, axes):
    """Each entry a card: the parts, loaded piece by piece and run with
    their sends, give ``sharded_apply``'s scores bit for bit, masked and
    not; a sender reads only its shard's rows, a row's first entry also its
    dense rows."""
    D, M = axes
    cfg = zoo.get_config("rm1", table_scale=SCALE, table_quant=quant)
    model = get_model(cfg, "cpu")
    params = bridge.params_from_numpy(bridge.init_numpy(cfg, 3), cfg, "cpu")
    mesh, plan = _labelled(D, M)
    sp = sharding.shard_params(params, mesh)
    assert len(plan) == D * M
    for masked in (False, True):
        dense, idx, mask = _rows(cfg, 16, 4, masked=masked)
        host = {"dense": torch.from_numpy(dense), "indices": torch.from_numpy(idx)}
        if masked:
            host["mask"] = torch.from_numpy(mask)
        prog, pieces = _program(model, sp, plan, host)
        got = prog.run(host)
        want = sharded_apply(model, mesh, has_dense=True)(
            sp, Batch(dense=host["dense"], indices=host["indices"], mask=host.get("mask")))
        assert torch.equal(got, want)
        sent = {k for s in prog.stages for k in s.sends}
        assert set(prog.recv) == sent
        assert len(sent) == D * (M - 1) + (D - 1)  # a partial a remote shard, a slice a row
        b = 16 // D
        rows = {place: {(n, i) for p, n, i in pieces if p == place} for place in range(D * M)}
        for d in range(D):
            for m in range(M):
                mine = {("indices", (slice(d * b, (d + 1) * b),))} if D > 1 else {
                    ("indices", ())}
                if masked:
                    mine |= {("mask", i) for _, i in mine}
                if m == 0:
                    mine |= {("dense", i) for _, i in mine}
                assert rows[d * M + m] == mine, (d, m)


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: f"{a[0]}x{a[1]}")
@pytest.mark.parametrize("quant", ["none", "int8", "int8_rowwise"])
def test_hotcold_parts_equal_the_mesh_hotcold_model_bit_for_bit(quant, axes):
    """Each entry a card: the hot/cold parts (tensor-parallel on 1x8, hybrid
    on 2x4) give the mesh hot/cold model's scores bit for bit; each cell
    reads its own cold stream, shard 0 its row's hot hits."""
    D, M = axes
    cfg = zoo.get_config("rm1", table_scale=SCALE, table_quant=quant)
    model = get_model(cfg, "cpu")
    params = bridge.params_from_numpy(bridge.init_numpy(cfg, 4), cfg, "cpu")
    mesh, plan = _labelled(D, M)
    hc = make_hotcold_model(model, hot_ids_from_generator(cfg, seed=5, hot_rows=256,
                                                          n_batches=2, batch_size=64), mesh=mesh)
    sp = sharding.shard_params(hc.convert_params(params), mesh)
    dense, idx, _ = _rows(cfg, 16, 6)
    split = hc.prepare(Batch(dense=dense, indices=idx))
    host = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in split.items()}
    host["dense"] = torch.from_numpy(dense)
    prog, pieces = _program(model, sp, plan, host, hotcold=True)
    got = prog.run(host)
    want = hc.apply(sp, Batch(dense=host["dense"], indices=None),
                    {k: v for k, v in host.items() if k != "dense"})
    assert torch.equal(got, want)
    for d in range(D):
        for m in range(M):
            cell = (m,) if D == 1 else (d, m)
            read = {(n, i) for p, n, i in pieces if p == d * M + m}
            assert ("cold_local", cell) in read and ("cold_seg", cell) in read
            assert any(n == "hot_sel" for n, _ in read) == (m == 0)


@pytest.fixture
def cards_of_entries(monkeypatch):
    """Every engine built in the test plans its mesh with each entry a card
    of its own."""
    plan = sharding.card_plan

    def labelled(mesh, places=None, sharded=True):
        return plan(mesh, places=np.arange(mesh.size).reshape(mesh.devices.shape),
                    sharded=sharded)

    monkeypatch.setattr(sharding, "card_plan", labelled)


CASES = {
    # payload rows padded to the bucket, direct and masked
    "direct_masked": ("rm1", "none", {"batch_buckets": (8,), "accept_ragged": True},
                      lambda cfg: [_rows(cfg, 5, 1), _rows(cfg, 6, 4, masked=True)]),
    "int8": ("rm1", "int8", {"batch_buckets": (8,)}, lambda cfg: [_rows(cfg, 7, 6)]),
    "int8_rowwise": ("rm1", "int8_rowwise", {"batch_buckets": (8,)},
                     lambda cfg: [_rows(cfg, 8, 7)]),
}


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: f"{a[0]}x{a[1]}")
@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_over_cards_equals_jax(cards_of_entries, case, axes):
    """An engine whose every entry is a card of its own serves each program
    as D*M parts, each over its own static inputs, and answers the JAX mesh
    engine's scores on the same weights and rows."""
    name, quant, kw, payloads_of = CASES[case]
    scfg = dict(engine_backend="cpu", max_mini_batch_size=max(kw["batch_buckets"]), **kw)
    (port, got), (jx, want) = _port_and_jax(name, quant, "xla", axes, scfg, payloads_of)
    _assert_same_scores(got, want)
    assert port.bucket_counts == jx.bucket_counts
    D, M = axes
    assert len(port._static_at) == D * M and port.eager_reason is None
    for prog in port.programs:
        assert len(prog.stages) == D * M and not prog.graphs
        assert len(prog.recv) == D * (M - 1) + (D - 1)
    if case == "direct_masked":
        assert {k: p.runs for k, p in port.programs.programs.items()} == {
            ("direct", 8): 1, ("masked", 8): 1}


@pytest.mark.parametrize("axes", MESHES, ids=lambda a: f"{a[0]}x{a[1]}")
def test_hotcold_engine_over_cards_at_two_cold_rungs_equals_jax(cards_of_entries, axes):
    """ncf's hot/cold engine, each entry a card: a request of hot ids takes
    the smallest mesh cold rung, one whose cold lookups crowd one cell the
    top rung; both programs' parts answer the JAX mesh engine's scores."""
    hot = {}

    def payloads_of(cfg):
        hot["ids"] = hot_ids_from_generator(cfg, seed=31, hot_rows=64)
        return [_rows(cfg, 16, 8, hot=hot["ids"]), _one_cell(cfg, 16, 9, hot["ids"])]

    scfg = dict(engine_backend="cpu", batch_buckets=(16,), max_mini_batch_size=16)
    (port, got), (jx, want) = _port_and_jax("ncf", "none", "hotcold", axes, scfg, payloads_of,
                                            hot_set_rows=64)
    _assert_same_scores(got, want)
    D, M = axes
    runs = [p.runs for p in port.programs]
    assert len(runs) == 2 and runs == [1, 1]
    assert all(len(p.stages) == D * M for p in port.programs)
