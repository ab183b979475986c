"""``dedup=True`` in the port against the JAX package's, on the CPU.

``dedup_touched_rows`` (a stable sort, a run mask, its cumsum and a segment
sum, JAX ``train.py:66-94``) on the same ids and gradients: the unique ids
and the inert tail exactly, the summed rows rtol 1e-6 (the same adds in the
same order; XLA may fuse them). The dedup steps (K5 over the unique rows)
against the JAX trainer's, single-device and on 2x4 and 4x2 meshes, from
the JAX trainer's params on the same batches: losses rtol 1e-5 over three
steps; the table within 1e-3 of the steps' reach and the accumulator
within 1e-4 of its largest (``tests/test_torch_train.py``'s sparse limits:
the row-wise scale multiplies the gradients' f32 rounding); the dense half
rtol 1e-5, atol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprecsys_tpu import train as jax_train
from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu.parallel import make_mesh as jax_make_mesh
from deeprecsys_tpu_torch import bridge, train, zoo
from deeprecsys_tpu_torch.parallel import make_mesh

SCALE = 2000
STEPS = 3
BATCH = 32
LR, TLR = 0.05, 0.01


@pytest.mark.parametrize("n,rows,d", [(24, 7, 5), (500, 40, 32), (1, 1, 32)])
def test_dedup_touched_rows_matches_jax(n, rows, d):
    rng = np.random.default_rng(4)
    flat = rng.integers(0, rows, size=n).astype(np.int32)
    g = rng.normal(size=(n, d)).astype(np.float32)
    want_u, want_s = jax_train.dedup_touched_rows(jnp.asarray(flat), jnp.asarray(g))
    uids, summed = train.dedup_touched_rows(torch.from_numpy(flat), torch.from_numpy(g))
    assert uids.dtype == torch.int32 and summed.dtype == torch.float32
    np.testing.assert_array_equal(uids.numpy(), np.asarray(want_u))
    np.testing.assert_allclose(summed.numpy(), np.asarray(want_s), rtol=1e-6, atol=1e-6)
    # One (id, summed) pair a unique row, then the inert tail.
    n_uniq = len(np.unique(flat))
    assert (uids.numpy()[n_uniq:] == 0).all() and (summed.numpy()[n_uniq:] == 0).all()
    dense = np.zeros((rows, d), np.float32)
    np.add.at(dense, flat, g)
    got = np.zeros((rows, d), np.float32)
    np.add.at(got, uids.numpy(), summed.numpy())
    np.testing.assert_allclose(got, dense, rtol=1e-5, atol=1e-6)


def _assert_sparse_close(jt, pt, pt_acc):
    want = bridge.flatten(jax.device_get(jt.params))
    got = bridge.flatten(bridge.params_to_numpy(pt.full_params(), pt.cfg))
    reach = STEPS * TLR
    for key, w in want.items():
        atol = 1e-3 * reach if key == "tables" else 1e-6
        np.testing.assert_allclose(got[key], np.asarray(w), rtol=1e-5, atol=atol, err_msg=key)
    want_acc = np.asarray(jt.opt_state[1])
    np.testing.assert_allclose(pt_acc, want_acc, rtol=0, atol=1e-4 * want_acc.max())


@pytest.mark.parametrize("axes", [None, (2, 4), (4, 2)])
def test_dedup_trainer_matches_jax(axes):
    """rm1 (L = 80: heavy repeats) with ``dedup=True``, single-device and
    on meshes, against the JAX trainer."""
    kw = dict(optimizer="adagrad", learning_rate=LR, loss="bce", sparse_tables=True,
              table_learning_rate=TLR, dedup=True)
    jmesh = None if axes is None else jax_make_mesh(*axes, devices=jax.devices()[:8])
    jt = jax_train.Trainer(jax_zoo.get_config("rm1", table_scale=SCALE), mesh=jmesh, **kw)
    start = bridge.params_from_numpy(jax.device_get(jt.params), jt.cfg, "cpu")
    mesh = None if axes is None else make_mesh(*axes, devices=["cpu"] * 8)
    pt = train.Trainer(zoo.get_config("rm1", table_scale=SCALE), mesh=mesh,
                       device="cpu" if mesh is None else None, params=start, **kw)
    want = jt.fit(STEPS, batch_size=BATCH, seed=1).losses
    got = pt.fit(STEPS, batch_size=BATCH, seed=1).losses
    np.testing.assert_allclose(got, want, rtol=1e-5)
    if mesh is None:
        acc = pt.opt_state[1]
    else:
        acc = torch.cat([pt.opt_state[1].part(0, m) for m in range(mesh.shape["model"])])
    _assert_sparse_close(jt, pt, acc.numpy())


def test_dedup_changes_what_the_accumulator_sees():
    """Without dedup each occurrence adds its own g^2; with it a row adds
    the square of its summed gradient once. On rm1's repeated rows the two
    accumulators differ."""
    cfg = zoo.get_config("rm1", table_scale=SCALE)
    start = bridge.params_from_numpy(bridge.init_numpy(cfg, 1), cfg, "cpu")
    accs = []
    for dedup in (False, True):
        tr = train.Trainer(cfg, sparse_tables=True, dedup=dedup, device="cpu", params=start,
                           learning_rate=LR, table_learning_rate=TLR)
        tr.fit(1, batch_size=BATCH, seed=1)
        accs.append(tr.opt_state[1])
    assert not torch.allclose(accs[0], accs[1])
    # The same rows are touched either way.
    assert torch.equal(accs[0] == 0, accs[1] == 0)
