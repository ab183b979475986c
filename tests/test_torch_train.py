"""The port's trainer (``deeprecsys_tpu_torch/train.py``) against the JAX
package's, on the CPU.

For each family (rm1, wnd, mtwnd, ncf, din, dien) at ``table_scale=2000``
in f32, the port's ``Trainer`` starts from the JAX ``Trainer``'s params
(through ``bridge.params_from_numpy``), both take the same three batches of
32 (the port's generator is bit-identical) and their losses and params are
compared. Every kernel wrapper runs its plain version on the CPU, so this
holds the port's math (autograd, optimizers, K1b's, K5's and K3b's plain
versions) to JAX's. Learning rates and tolerances:

- losses: rtol 1e-5 (measured at most 8e-7 apart).
- dense sgd and adagrad at lr 0.01: params rtol 1e-5, atol 1e-6 (measured
  at most 6e-8 apart: f32 sums in other orders).
- dense adam at lr 1e-3: atol 2% of the three steps' reach (6e-5). Adam's
  update m / (sqrt(v) + 1e-8) turns the f32 rounding of a gradient near
  1e-8 (a sum that cancels, added in another order) into an O(lr) change;
  measured at most 2.9e-5. At larger rates the bce clip makes it worse:
  a saturated score above 1 - 1e-7 gets no gradient in one package and
  some in the other.
- sparse row-wise AdaGrad at lr 0.01: the dense half as dense adagrad;
  the table within 1e-3 of the steps' reach (3e-5): the row-wise scale
  1 / sqrt(acc + 1e-8) is up to 1e4 on rows first touched by these steps
  and multiplies the gradients' rounding (measured at most 7.2e-6, dien);
  the row accumulators within 1e-4 of the largest (sums of g^2 whose small
  terms carry the gradients' rounding: measured 2.8e-9 of 5e-5, dien).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from deeprecsys_tpu import train as jax_train
from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu.data import RecDataGenerator as JaxGenerator
from deeprecsys_tpu.data import criteo as jax_criteo
from deeprecsys_tpu_torch import bridge, train, zoo
from deeprecsys_tpu_torch.config import ModelConfig
from deeprecsys_tpu_torch.data import RecDataGenerator, criteo

FAMILIES = ("rm1", "wnd", "mtwnd", "ncf", "din", "dien")
SCALE = 2000
STEPS = 3
BATCH = 32
LR = {"sgd": 0.01, "adagrad": 0.01, "adam": 1e-3, "sparse": 0.01}


def _pair(name: str, mode: str, cfg_jax=None, cfg_port=None):
    sparse = mode == "sparse"
    opt = "adagrad" if sparse else mode
    jt = jax_train.Trainer(cfg_jax or jax_zoo.get_config(name, table_scale=SCALE),
                           optimizer=opt, learning_rate=LR[mode], sparse_tables=sparse)
    start = bridge.params_from_numpy(jax.device_get(jt.params), jt.cfg, "cpu")
    pt = train.Trainer(cfg_port or zoo.get_config(name, table_scale=SCALE), optimizer=opt,
                       learning_rate=LR[mode], sparse_tables=sparse, device="cpu",
                       params=start)
    return jt, pt


def _assert_params_close(jt, pt, mode: str):
    want = bridge.flatten(jax.device_get(jt.params))
    got = bridge.flatten(bridge.params_to_numpy(pt.params, pt.cfg))
    assert sorted(got) == sorted(want)
    reach = STEPS * LR[mode]
    for key, w in want.items():
        w = np.asarray(w)
        assert got[key].shape == w.shape and got[key].dtype == w.dtype, key
        if mode == "adam":
            atol = 0.02 * reach
        elif mode == "sparse" and key == "tables":
            atol = 1e-3 * reach
        else:
            atol = 1e-6
        np.testing.assert_allclose(got[key], w, rtol=1e-5, atol=atol, err_msg=key)


@pytest.mark.parametrize("mode", ["sgd", "adagrad", "adam", "sparse"])
@pytest.mark.parametrize("name", FAMILIES)
def test_trainer_matches_jax(name, mode):
    jt, pt = _pair(name, mode)
    assert pt.cfg == bridge_cfg(jt.cfg)
    want = jt.fit(STEPS, batch_size=BATCH, seed=1).losses
    got = pt.fit(STEPS, batch_size=BATCH, seed=1).losses
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_params_close(jt, pt, mode)
    if mode == "sparse":
        want_acc = np.asarray(jt.opt_state[1])
        np.testing.assert_allclose(pt.opt_state[1].numpy(), want_acc, rtol=0,
                                   atol=1e-4 * want_acc.max())


def bridge_cfg(jax_cfg):
    """The port's ModelConfig with the JAX config's fields."""
    return ModelConfig(**{f.name: getattr(jax_cfg, f.name)
                          for f in dataclasses.fields(jax_cfg)})


def test_criteo_batches_train_as_in_jax(tmp_path):
    """The Criteo DLRM ("dot" interaction, 26 tables of L = 1) through
    ``_fit_batches`` on a written TSV."""
    path = tmp_path / "train.tsv"
    jax_criteo.write_synthetic_criteo(path, 200, seed=3, signal=True)
    jcfg = jax_criteo.criteo_model_config(rows_per_table=500)
    pcfg = criteo.criteo_model_config(rows_per_table=500)
    jt, pt = _pair("criteo", "adagrad", jcfg, pcfg)
    want = jax_train._fit_batches(jt, jax_criteo.CriteoReader(path, jcfg).batches(32))
    got = train._fit_batches(pt, criteo.CriteoReader(path, pcfg).batches(32))
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_params_close(jt, pt, "adagrad")
    held_out = [(b, lab) for b, lab in criteo.CriteoReader(path, pcfg).batches(64)]
    got_ev = pt.evaluate_batches(held_out)
    want_ev = jt.evaluate_batches(jax_criteo.CriteoReader(path, jcfg).batches(64))
    assert got_ev["n"] == want_ev["n"] == 192
    np.testing.assert_allclose([got_ev["auc"], got_ev["logloss"]],
                               [want_ev["auc"], want_ev["logloss"]], rtol=1e-5)


@pytest.mark.parametrize("name", ["rm1", "dien"])
def test_evaluate_matches_jax(name):
    jt, pt = _pair(name, "sgd")
    want = jt.evaluate(JaxGenerator(jt.cfg, seed=5), 64)
    got = pt.evaluate(RecDataGenerator(pt.cfg, seed=5), 64)
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name,sparse,dtype", [
    ("ncf", False, "float32"), ("din", True, "float32"), ("rm1", True, "bfloat16"),
    ("dien", False, "bfloat16")])
def test_trainer_config_rules_match_jax(name, sparse, dtype):
    """The relu-headed families train on logits; sparse mode trains
    unpacked (bf16 d = 32 would resolve to pack 2)."""
    kw = dict(table_scale=SCALE, param_dtype=dtype, compute_dtype=dtype)
    jt = jax_train.Trainer(jax_zoo.get_config(name, **kw), sparse_tables=sparse)
    pt = train.Trainer(zoo.get_config(name, **kw), sparse_tables=sparse, device="cpu")
    assert pt.cfg == bridge_cfg(jt.cfg)
    assert bridge.param_shapes(pt.cfg)["tables"] == bridge.param_shapes(
        bridge_cfg(jt.cfg))["tables"]


def test_trainer_paths_not_ported_raise():
    """What the trainer refuses: int8 tables, and the card when there is
    none. (``mesh=`` and ``dedup=True`` train: ``test_torch_mesh_train.py``,
    ``test_torch_dedup.py``.)"""
    cfg = zoo.get_config("rm1", table_scale=SCALE)
    with pytest.raises(ValueError, match="float tables"):
        train.Trainer(cfg.replace(table_quant="int8"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            train.Trainer(cfg)


def test_params_are_plain_tensors_between_steps():
    """The trainer's params need grad only inside a step, so serving them
    runs no autograd."""
    pt = train.Trainer(zoo.get_config("dien", table_scale=SCALE), device="cpu")
    pt.fit(1, batch_size=8)
    assert not any(t.requires_grad for t in bridge.flatten(pt.params).values())
