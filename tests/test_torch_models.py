"""The port's zoo models (rm2, rm3, wnd, mtwnd, ncf, din, dien) against the
JAX package on the CPU, at ``table_scale=2000``.

Weights: ``bridge.init_numpy`` draws them from a seed in the JAX layout;
the same numpy arrays go to JAX ``apply`` and, through
``bridge.params_from_numpy``, to the port. The JAX outputs come from
``tests/golden/make_torch_port_fixture.py::build_model``, once per model,
and are also the ones ``chip_smoke.py`` compares with on the card
(``torch_port_zoo.npz``). Tolerances:

- f32: rtol and atol 1e-5 (the forwards differ only in summation order);
- bf16: two bf16 ulps of the output's largest magnitude
  (``chip_smoke.bf16_atol``): an f32 sum that lands near a rounding
  boundary may round the other way at one layer and move the output by
  about one ulp (measured: at most one).

``tests/test_torch_golden.py`` holds the models against
``forward_outputs.json``.

No RNN weight is scaled: with the 1/sqrt(fan_in) init DIEN's recurrence
does not amplify round-off (f32 error 4e-7 at batch 32).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu.models import get_model as jax_get_model
from deeprecsys_tpu.models import sigmoid_output as jax_sigmoid_output
from deeprecsys_tpu.models.base import stacked_mlp_apply as jax_stacked_mlp_apply
from deeprecsys_tpu_torch import bridge, zoo
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.models import dien, get_model, sigmoid_output
from deeprecsys_tpu_torch.models.base import (
    Batch, pooled_lookup, stacked_mlp_apply, stacked_mlp_init)
from tests.golden import make_torch_port_fixture as fixture

SCALE = 2000
MODELS = fixture.ZOO_MODELS


def _cfg(name, dtype="float32", **kw):
    return zoo.get_config(name, table_scale=SCALE, param_dtype=dtype,
                          compute_dtype=dtype, **kw)


def _jax_cfg(name, dtype="float32", **kw):
    return jax_zoo.get_config(name, table_scale=SCALE, param_dtype=dtype,
                              compute_dtype=dtype, **kw)


@functools.cache
def _fresh(name: str) -> dict:
    """The fixture's entries for ``name``, rebuilt with the JAX package."""
    return fixture.build_model(name)


def _batch(fresh: dict) -> Batch:
    return Batch(fresh.get("dense"), fresh["indices"])


def _port_forward(cfg, np_params, batch, **kw):
    params = bridge.params_from_numpy(np_params, cfg, "cpu")
    with torch.inference_mode():
        return get_model(cfg, "cpu").apply(params, batch.to("cpu"), **kw).float().numpy()


def _assert_close(got, want, dtype):
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=chip_smoke.bf16_atol(want))


@pytest.mark.parametrize("name", MODELS)
def test_zoo_fixture_is_current(name):
    """chip_smoke.py's fixture equals a fresh build from the JAX package."""
    stored = np.load(fixture.ZOO_PATH)
    fresh = _fresh(name)
    assert sorted(k for k in stored.files if k.startswith(f"{name}/")) == \
        sorted(f"{name}/{k}" for k in fresh)
    for k, v in fresh.items():
        if k.startswith("out_") or k == "fingerprint":
            np.testing.assert_allclose(stored[f"{name}/{k}"], v, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(stored[f"{name}/{k}"], v, err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", MODELS)
def test_matches_jax_apply(name, dtype):
    fresh = _fresh(name)
    cfg = _cfg(name, dtype)
    np_params = bridge.init_numpy(cfg, fixture.WEIGHT_SEED)
    tag = "f32" if dtype == "float32" else "bf16"
    got = _port_forward(cfg, np_params, _batch(fresh))
    assert got.shape == (fixture.ZOO_BATCH, cfg.out_dim)
    _assert_close(got, fresh[f"out_{tag}"], dtype)
    if name == "dien":  # ragged histories with an initial state
        got = _port_forward(cfg, np_params, _batch(fresh),
                            seq_lengths=torch.from_numpy(fresh["seq_lengths"]),
                            initial_h=torch.from_numpy(fresh["initial_h"]))
        _assert_close(got, fresh[f"out_ragged_{tag}"], dtype)


@pytest.mark.parametrize("name", MODELS)
def test_chip_smoke_fixture_check_on_cpu(name):
    """The comparison chip_smoke.py makes on the card, here on the CPU."""
    errs = chip_smoke.fixture_model(np.load(fixture.ZOO_PATH), name, torch.device("cpu"))
    assert set(errs) >= {"f32", "bf16"}


@pytest.mark.parametrize("name", ["ncf", "din", "dien"])
def test_logits_head_matches_jax(name):
    cfg = _cfg(name, output_head="logits")
    np_params = bridge.init_numpy(cfg, 3)
    batch = _batch(_fresh(name))
    # Shift the last bias by the mean score, so that scores of both signs come.
    head = np_params["final" if name == "ncf" else "top"][-1]
    head["b"] = head["b"] - _port_forward(cfg, np_params, batch).mean(axis=0)
    want = np.asarray(jax.jit(jax_get_model(_jax_cfg(name, output_head="logits")).apply)(
        np_params, batch))
    got = _port_forward(cfg, np_params, batch)
    _assert_close(got, want, "float32")
    assert (got < 0).any() and (got > 0).any()  # the final pre-activation is exposed
    relu = _port_forward(_cfg(name), np_params, batch)
    np.testing.assert_array_equal(relu, np.maximum(got, 0))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dien_ragged_histories_score_as_unpadded_runs(dtype):
    """The port's form of tests/test_models.py::test_dien_variable_length_histories:
    a padded batch with per-row seq_lengths (and initial states) scores
    each row as an unpadded run of that row's own length (f32: rtol 1e-5,
    atol 1e-6 as there; the batch of 1 and of 3 sum their products in
    other orders)."""
    cfg = _cfg("dien", dtype)
    params = bridge.params_from_numpy(bridge.init_numpy(cfg, 5), cfg, "cpu")
    batch = RecDataGenerator(cfg, seed=11).generate_batch(3).to("cpu")
    T = cfg.num_tables
    lengths = torch.tensor([2, (T - 3) // 2, T - 3], dtype=torch.int32)
    h0 = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 64)).astype(np.float32))
    with torch.inference_mode():
        emb = pooled_lookup(params["tables"], batch, cfg)
        padded = dien.apply_from_pooled(params, emb, batch, cfg, seq_lengths=lengths,
                                        initial_h=h0)
        for b, n in enumerate(lengths.tolist()):
            emb_b = torch.cat([emb[b:b + 1, :1], emb[b:b + 1, 1:1 + n],
                               emb[b:b + 1, T - 2:]], dim=1)
            cfg_b = cfg.replace(embedding_rows=cfg.embedding_rows[:n + 3])
            solo = dien.apply_from_pooled(params, emb_b, None, cfg_b, initial_h=h0[b:b + 1])
            tol = ({"rtol": 1e-5, "atol": 1e-6} if dtype == "float32" else
                   {"rtol": 0, "atol": chip_smoke.bf16_atol(solo.float().numpy())})
            np.testing.assert_allclose(padded[b:b + 1].float().numpy(), solo.float().numpy(),
                                       err_msg=f"row {b} (length {n})", **tol)


def _shape_tree(tree):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    return treedef, [(tuple(x.shape), np.dtype(x.dtype)) for x in leaves]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", zoo.MODEL_NAMES)
def test_init_numpy_and_port_init_match_jax_init_layout(name, dtype):
    """bridge.init_numpy, and the port's own init carried back by
    params_to_numpy, give the keys, shapes, dtypes and table layout of
    JAX ``init`` (packed bf16 d=32 tables included)."""
    cfg = _cfg(name, dtype)
    want = _shape_tree(jax.eval_shape(jax_get_model(_jax_cfg(name, dtype)).init,
                                      jax.random.PRNGKey(0)))
    assert _shape_tree(bridge.init_numpy(cfg, 0)) == want
    port = get_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    assert _shape_tree(bridge.params_to_numpy(port, cfg)) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["din", "dien"])
def test_bridge_round_trip(name, dtype):
    """DIN's stacked lists and DIEN's plain dict entries cross both ways bit
    for bit, and through flatten/unflatten (an .npz's keys)."""
    cfg = _cfg(name, dtype)
    np_params = bridge.init_numpy(cfg, 1)
    back = bridge.params_to_numpy(bridge.params_from_numpy(np_params, cfg, "cpu"), cfg)
    again = bridge.unflatten(bridge.flatten(back))
    for tree in (back, again):
        want_leaves, want_def = jax.tree_util.tree_flatten(np_params)
        got_leaves, got_def = jax.tree_util.tree_flatten(tree)
        assert got_def == want_def
        for g, w in zip(got_leaves, want_leaves):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)


def test_sigmoid_output_matches_jax():
    for name in zoo.MODEL_NAMES:
        assert sigmoid_output(zoo.get_config(name)) == \
            jax_sigmoid_output(jax_zoo.get_config(name))


@pytest.mark.parametrize("sigmoid_layer", [-1, 2])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_stacked_mlp_apply_matches_jax(dt, sigmoid_layer):
    t_dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dt]
    rng = np.random.default_rng(4)
    layers = [{"w": rng.standard_normal((5, n, m)).astype(np.float32) / np.sqrt(n),
               "b": rng.standard_normal((5, m)).astype(np.float32) * 0.1}
              for n, m in ((24, 16), (16, 8))]
    x = rng.standard_normal((7, 5, 24)).astype(np.float32)
    tp = [{k: torch.from_numpy(v).to(t_dt) for k, v in layer.items()} for layer in layers]
    xt = torch.from_numpy(x).to(t_dt)
    # JAX takes the weights as f32 arrays holding the bf16 values: its CPU
    # backend has no bf16 x bf16 -> f32 batched product
    # (make_torch_port_fixture.py); the numerics are the bf16 path's.
    jp = [{k: jnp.asarray(v.float().numpy()) for k, v in layer.items()} for layer in tp]
    xj = jnp.asarray(xt.float().numpy()).astype(jnp.bfloat16 if dt == "bfloat16" else jnp.float32)
    want = np.asarray(jax_stacked_mlp_apply(jp, xj, sigmoid_layer=sigmoid_layer)
                      .astype(jnp.float32))
    got_t = stacked_mlp_apply(tp, xt, sigmoid_layer=sigmoid_layer)
    assert got_t.dtype == t_dt and got_t.shape == (7, 5, 8)
    _assert_close(got_t.float().numpy(), want, dt)
    if sigmoid_layer == 2:
        assert ((want > 0) & (want < 1)).all()


def test_stacked_mlp_init_distributions():
    g = torch.Generator().manual_seed(1)
    plain, scaled = (stacked_mlp_init(8, (96, 64, 32), torch.float32, g, "cpu", sum_fanin=s)
                     for s in (1, 100))
    assert [tuple(l["w"].shape) for l in plain] == [(8, 96, 64), (8, 64, 32)]
    assert [tuple(l["b"].shape) for l in plain] == [(8, 64), (8, 32)]
    np.testing.assert_allclose(plain[0]["w"].std().item(), np.sqrt(2 / 160), rtol=0.05)
    np.testing.assert_allclose(plain[1]["w"].std().item(), np.sqrt(2 / 96), rtol=0.05)
    # sum_fanin scales only the last layer, by 1/sqrt(sum_fanin).
    np.testing.assert_allclose(scaled[0]["w"].std().item(), np.sqrt(2 / 160), rtol=0.05)
    np.testing.assert_allclose(scaled[1]["w"].std().item(), np.sqrt(2 / 96) / 10, rtol=0.05)
