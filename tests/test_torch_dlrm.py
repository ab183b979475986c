"""The port's rm1 against the JAX package on the same weights and inputs.

Weights come from the JAX ``model.init(PRNGKey(0))`` through
``bridge.params_from_numpy``; inputs from the (bit-identical) generators.
Tolerances: f32 rtol 1e-5 (the golden file's and chip_smoke's bound);
bf16 1 bf16 ulp of the output (2^-8 on sigmoid scores in [0.5, 1)).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu.data import RecDataGenerator as JaxGenerator
from deeprecsys_tpu.models import get_model as jax_get_model
from deeprecsys_tpu.models.base import Batch as JaxBatch
from deeprecsys_tpu.models.base import pooled_lookup as jax_pooled_lookup
from deeprecsys_tpu_torch import bridge, zoo
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.models import get_model
from deeprecsys_tpu_torch.models.base import Batch, pooled_lookup

SCALE = 2000
GOLDEN = Path(__file__).parent / "golden"


def _cfg(dtype="float32", **kw):
    return zoo.get_config("rm1", table_scale=SCALE, param_dtype=dtype,
                          compute_dtype=dtype, **kw)


def _jax_cfg(dtype="float32"):
    return jax_zoo.get_config("rm1", table_scale=SCALE, param_dtype=dtype, compute_dtype=dtype)


def _port_forward(cfg, np_params, batch):
    model = get_model(cfg, "cpu")
    params = bridge.params_from_numpy(np_params, cfg, "cpu")
    with torch.inference_mode():
        return model.apply(params, batch.to("cpu")).float().numpy()


def test_rm1_matches_golden_outputs():
    # tests/test_parity.py::_forward: init PRNGKey(0), generator seed 1, batch 8.
    cfg = _cfg()
    np_params = jax.device_get(jax_get_model(_jax_cfg()).init(jax.random.PRNGKey(0)))
    got = _port_forward(cfg, np_params, RecDataGenerator(cfg, seed=1).generate_batch(8))
    want = np.asarray(json.loads((GOLDEN / "forward_outputs.json").read_text())["rm1"],
                      dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [1, 2])
def test_rm1_matches_jax_apply(dtype, seed):
    cfg, jax_cfg = _cfg(dtype), _jax_cfg(dtype)
    model = jax_get_model(jax_cfg)
    params = model.init(jax.random.PRNGKey(0))
    if dtype == "bfloat16":  # the JAX table is packed; the bridge unpacks it
        assert cfg.resolved_table_pack == 2 and "packed" in params["tables"]
    batch = JaxGenerator(jax_cfg, seed=seed).generate_batch(32)
    want = np.asarray(model.apply(params, batch).astype(jnp.float32))
    got = _port_forward(cfg, jax.device_get(params), Batch(batch.dense, batch.indices))
    assert got.shape == want.shape == (32, 1)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip(dtype):
    cfg = _cfg(dtype)
    np_params = jax.device_get(jax_get_model(_jax_cfg(dtype)).init(jax.random.PRNGKey(0)))
    back = bridge.params_to_numpy(bridge.params_from_numpy(np_params, cfg, "cpu"), cfg)
    want_leaves, want_def = jax.tree_util.tree_flatten(np_params)
    got_leaves, got_def = jax.tree_util.tree_flatten(back)
    assert got_def == want_def
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_bridge_rejects_quantized_tables():
    """(The name is historical: the port now serves them.) The bridge
    carries per-table int8 tables in the JAX init's packed layout, and the
    port's lookup pools them: each bag's int32 sum of q times its table's
    scale, which JAX's pooled_lookup gives bit for bit."""
    cfg = _cfg(table_quant="int8")
    jax_cfg = jax_zoo.get_config("rm1", table_scale=SCALE, table_quant="int8")
    np_params = jax.device_get(jax_get_model(jax_cfg).init(jax.random.PRNGKey(0)))
    assert sorted(np_params["tables"]) == ["q_packed", "scale"]
    params = bridge.params_from_numpy(np_params, cfg, "cpu")
    assert params["tables"]["q"].dtype == torch.int8
    assert params["tables"]["q"].shape == (cfg.total_rows, 32)
    batch = RecDataGenerator(cfg, seed=1).generate_batch(4)
    got = pooled_lookup(params["tables"], batch.to("cpu"), cfg)
    q = params["tables"]["q"].long()
    flat = batch.indices.astype(np.int64) + cfg.table_offsets[None, :, None]
    want = q[torch.from_numpy(flat)].sum(dim=2).float() * params["tables"]["scale"][None, :, None]
    assert torch.equal(got, want)
    want_jax = jax_pooled_lookup(jax.tree_util.tree_map(jnp.asarray, np_params["tables"]),
                                 JaxBatch(None, jnp.asarray(batch.indices)), jax_cfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want_jax))


def test_port_init_shapes_and_range():
    cfg = _cfg("bfloat16")
    model = get_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    assert params["tables"].shape == (cfg.total_rows, 32)
    assert params["tables"].dtype == torch.bfloat16
    assert [tuple(l["w"].shape) for l in params["top"]] == [(288, 256), (256, 64), (64, 1)]
    batch = RecDataGenerator(cfg, seed=1).generate_batch(16).to("cpu")
    out = model.apply(params, batch).float()
    assert out.shape == (16, 1) and bool(((out >= 0) & (out <= 1)).all())


def test_unported_paths_raise():
    """The model's own lookup refuses embedding_impl="hotcold", with float
    or int8 tables, as the JAX package's does (a serving-engine path:
    models/hotcold.py); "auto" takes the direct lookup. Both int8 inits
    serve through the model."""
    cfg = _cfg()
    batch = RecDataGenerator(cfg, seed=1).generate_batch(2).to("cpu")
    table = torch.zeros((cfg.total_rows, 32))
    with pytest.raises(ValueError, match="a serving-engine path"):
        pooled_lookup(table, batch, cfg.replace(embedding_impl="hotcold"))
    assert torch.equal(pooled_lookup(table, batch, cfg.replace(embedding_impl="auto")),
                       pooled_lookup(table, batch, cfg))
    for quant, keys in (("int8", ["q", "scale"]), ("int8_rowwise", ["qrows"])):
        model = get_model(cfg.replace(table_quant=quant), "cpu")
        params = model.init(torch.Generator().manual_seed(0))
        assert sorted(params["tables"]) == keys
        with pytest.raises(ValueError, match="a serving-engine path"):
            pooled_lookup(params["tables"], batch, model.cfg.replace(embedding_impl="hotcold"))
        out = model.apply(params, batch)
        assert out.shape == (2, 1) and bool(((out >= 0) & (out <= 1)).all())
    with pytest.raises(ValueError, match="unknown table layout"):
        pooled_lookup({"q": table}, batch, cfg)


def test_parity_fixture_is_current():
    """chip_smoke.py's fixture equals a fresh build from the JAX package."""
    from tests.golden.make_torch_port_fixture import PATH, build

    fresh = build()
    stored = np.load(PATH)
    assert sorted(stored.files) == sorted(fresh)
    for k, v in fresh.items():
        if k.startswith("out_"):
            np.testing.assert_allclose(stored[k], v, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(stored[k], v, err_msg=k)


def test_port_matches_parity_fixture():
    """The comparison chip_smoke.py makes on the card, here on the CPU."""
    stored = np.load(GOLDEN / "torch_port_rm1.npz")
    np_params = bridge.unflatten({k: stored[k] for k in stored.files
                                  if k == "tables" or "/" in k})
    assert sorted(np_params) == ["bot", "tables", "top"]
    batch = Batch(stored["dense"], stored["indices"])
    cfg = _cfg()
    np.testing.assert_allclose(_port_forward(cfg, np_params, batch), stored["out_f32"],
                               rtol=1e-5)
    cfg16 = _cfg("bfloat16")
    params16 = bridge.tree_map(lambda a: a.astype(jnp.bfloat16), np_params)
    np.testing.assert_allclose(_port_forward(cfg16, params16, batch), stored["out_bf16"],
                               rtol=0, atol=2.0 ** -8)
