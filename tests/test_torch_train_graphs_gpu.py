"""The trainer's step programs on a card: each step after a shape's first is
a replay of the CUDA graph captured from it, and it computes what the eager
step computes.

These tests need a card; without one they skip. The file imports no JAX
(``--noconftest`` skips ``tests/conftest.py``, which imports jax):

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_train_graphs_gpu.py

Each case builds two trainers from the same params: one steps through its
programs (``Trainer.step``), the other calls its step function directly
(``make_dense_step``, ``make_sparse_table_step``, the mesh steps), eagerly,
on the same batches (32, 32, 16, 32, 32 rows: two programs, three
replays). The two differ only in the order of K1b's and K5's atomic adds,
so they are held to ``tests/test_torch_train.py``'s limits between the
port and JAX: losses rtol 1e-5; params rtol 1e-5 and atol 1e-6, adam's atol
2% of the steps' reach, a sparse table's 1e-3 of it, row accumulators
1e-4 of the largest. Each kernel's launches are counted once a step, the
replays' included; a replayed step calls no kernel wrapper from Python and
makes no host synchronization (``torch.cuda.set_sync_debug_mode("error")``).
"""

import numpy as np
import pytest
import torch

from deeprecsys_tpu_torch import bridge, train, zoo
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.models import get_model
from deeprecsys_tpu_torch.ops import _build
from deeprecsys_tpu_torch.ops import embedding as emb_mod
from deeprecsys_tpu_torch.ops import optimizer as opt_mod
from deeprecsys_tpu_torch.ops import rnn as rnn_mod
from deeprecsys_tpu_torch.ops import sparse_adagrad as k5_mod
from deeprecsys_tpu_torch.parallel import make_mesh, make_train_step, shard_params, unshard_params

pytestmark = pytest.mark.gpu

SCALE = 2000
SIZES = (32, 32, 16, 32, 32)
LR = {"sgd": 0.05, "adagrad": 0.01, "adam": 1e-3}
WRAPPERS = {"embedding_bag": emb_mod.embedding_bag,
            "embedding_bag_backward": emb_mod.embedding_bag_backward,
            "embedding_bag_shard": emb_mod.embedding_bag_shard,
            "embedding_bag_backward_shard": emb_mod.embedding_bag_backward_shard,
            "sparse_adagrad_step": k5_mod.sparse_adagrad_step,
            "sparse_adagrad_step_shard": k5_mod.sparse_adagrad_step_shard,
            "optimizer_update": opt_mod.optimizer_update,
            "rnn_scan": rnn_mod.rnn_scan, "rnn_scan_backward": rnn_mod.rnn_scan_backward}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _counts() -> dict:
    return {k: w.kernel_launches for k, w in WRAPPERS.items()}


def _batches(cfg, sizes=SIZES):
    gen = RecDataGenerator(cfg, seed=1)
    out = []
    for b in sizes:
        host = gen.generate_batch(b)
        m = host.dense.mean(axis=1) if host.dense is not None else None
        labels = ((m > np.median(m)) if m is not None else host.indices[:, 0, 0] % 2)
        out.append((host, labels.astype(np.float32)))
    return out


def _assert_params_close(got: dict, want: dict, opt: str, sparse: bool, steps: int):
    reach = steps * LR[opt]
    for key, w in want.items():
        atol = 0.02 * reach if opt == "adam" else (
            1e-3 * reach if sparse and key == "tables" else 1e-6)
        torch.testing.assert_close(got[key].float().cpu(), w.float().cpu(), rtol=1e-5, atol=atol,
                                   msg=key)


class _LaunchCalls:
    """Counts the Python calls that launch a kernel (``_build.launch``)."""

    def __init__(self, monkeypatch):
        self.n = 0
        real = _build.launch

        def launch(*a, **k):
            self.n += 1
            return real(*a, **k)

        monkeypatch.setattr(_build, "launch", launch)


def _pair(cuda, name, opt, sparse, dedup=False, axes=None):
    cfg = zoo.get_config(name, table_scale=SCALE)
    start = bridge.params_from_numpy(bridge.init_numpy(cfg, 0), cfg, "cpu")
    kw = dict(optimizer=opt, learning_rate=LR[opt], sparse_tables=sparse, dedup=dedup,
              params=start)
    if axes is None:
        return train.Trainer(cfg, device=cuda, **kw), train.Trainer(cfg, device=cuda, **kw)
    return tuple(train.Trainer(cfg, mesh=make_mesh(*axes, devices=[cuda] * (axes[0] * axes[1])),
                               **kw) for _ in range(2))


def _full(tr) -> dict:
    return bridge.flatten(tr.full_params())


@pytest.mark.parametrize("name,opt,sparse,dedup,axes", [
    ("rm1", "adagrad", False, False, None), ("rm1", "adam", False, False, None),
    ("rm1", "adagrad", True, False, None), ("rm1", "adagrad", True, True, None),
    ("dien", "adagrad", True, False, None), ("dien", "sgd", False, False, None),
    ("rm1", "adagrad", False, False, (1, 4)), ("rm1", "adagrad", True, False, (2, 2)),
    ("rm1", "adagrad", True, True, (2, 2))])
def test_graphed_steps_match_the_eager_step(cuda, monkeypatch, name, opt, sparse, dedup, axes):
    graphed, eager = _pair(cuda, name, opt, sparse, dedup, axes)
    assert graphed.eager_reason is None
    batches = _batches(graphed.cfg)
    got, want = [], []
    calls = _LaunchCalls(monkeypatch)
    per_step = []
    for i, (host, labels) in enumerate(batches):
        before, n0 = _counts(), calls.n
        if i == len(batches) - 1:
            torch.cuda.set_sync_debug_mode("error")
        try:
            loss = graphed.step(host, labels)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        got.append(float(loss))
        torch.cuda.synchronize()
        per_step.append({k: v - before[k] for k, v in _counts().items() if v != before[k]})
        if i in (1, 3, 4):  # replays: no kernel launched from Python
            assert calls.n == n0, f"step {i} called a wrapper"
        want.append(float(eager._step(eager.params, eager.opt_state, host.to(cuda),
                                      eager._targets(labels))))
    assert graphed.step_program.captures == 2 and len(graphed.step_program.programs) == 2
    assert graphed.step_program.pool_bytes() > 0
    assert all(p == per_step[0] for p in per_step), per_step
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_params_close(_full(graphed), _full(eager), opt, sparse, len(batches))
    if sparse and axes is None:
        torch.testing.assert_close(graphed.opt_state[1], eager.opt_state[1], rtol=0,
                                   atol=1e-4 * float(eager.opt_state[1].max()))
    if opt == "adam":
        assert int(graphed.opt_state["count"]) == int(eager.opt_state["count"]) == len(batches)


def test_make_train_step_replays_on_a_mesh_of_one_card(cuda):
    """``make_train_step`` on a 2x2 mesh of the card: the program's replays
    against the eager dense step with sgd."""
    cfg = zoo.get_config("rm1", table_scale=SCALE)
    start = bridge.params_from_numpy(bridge.init_numpy(cfg, 0), cfg, "cpu")
    mesh = make_mesh(2, 2, devices=[cuda] * 4)
    model = get_model(cfg, cuda)
    sps = [shard_params(bridge.tree_map(lambda t: t.to(cuda), start), mesh) for _ in range(2)]
    steps = [make_train_step(model, mesh, has_dense=True, learning_rate=LR["sgd"],
                             loss="bce")(sp) for sp in sps]
    assert steps[0].programs is not None
    eager = steps[1].programs.step  # the dense step itself, called eagerly
    got, want = [], []
    for host, labels in _batches(cfg):
        t = torch.from_numpy(labels)[:, None]
        got.append(float(steps[0](sps[0], host, t)[1]))
        want.append(float(eager(host.to(cuda), t.to(cuda))))
    assert steps[0].programs.captures == 2
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_params_close(bridge.flatten(unshard_params(sps[0])),
                         bridge.flatten(unshard_params(sps[1])), "sgd", False, len(SIZES))


def test_a_new_params_object_drops_the_graphs(cuda):
    """Assigning new params drops the programs; the next step captures
    against the new tensors and trains them."""
    tr, _ = _pair(cuda, "rm1", "adagrad", False)
    (h0, l0), (h1, l1) = _batches(tr.cfg, (32, 32))
    tr.step(h0, l0)
    tr.step(h1, l1)
    new = bridge.tree_map(lambda t: t.clone(), tr.params)
    tr.params = new
    before = new["tables"].clone()
    tr.step(h0, l0)
    tr.step(h1, l1)
    torch.cuda.synchronize()
    assert tr.step_program.captures == 2 and not torch.equal(new["tables"], before)
