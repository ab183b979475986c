"""The port's zoo models against the pinned golden outputs, and
``bridge.init_numpy`` against the JAX init's distributions, on the CPU.

Both need the JAX ``init(PRNGKey(0))`` weights, drawn op by op as
``tests/test_parity.py`` draws them (a jitted init gives other values),
which costs a few seconds a model; this file shares one such init per
model. Golden tolerance: rtol 1e-4, atol 1e-5, as ``test_parity.py``.
"""

import functools
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu.models import get_model as jax_get_model
from deeprecsys_tpu_torch import bridge, zoo
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.models import get_model

SCALE = 2000
MODELS = ("rm2", "rm3", "wnd", "mtwnd", "ncf", "din", "dien")
GOLDEN = Path(__file__).parent / "golden" / "forward_outputs.json"


def _cfg(name):
    return zoo.get_config(name, table_scale=SCALE)


def _jax_cfg(name):
    return jax_zoo.get_config(name, table_scale=SCALE)


@functools.cache
def _jax_init(name: str) -> dict:
    return jax.device_get(jax_get_model(_jax_cfg(name)).init(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("name", MODELS)
def test_matches_golden_outputs(name):
    # tests/test_parity.py::_forward: init PRNGKey(0), generator seed 1, batch 8.
    cfg = _cfg(name)
    params = bridge.params_from_numpy(_jax_init(name), cfg, "cpu")
    batch = RecDataGenerator(cfg, seed=1).generate_batch(8).to("cpu")
    with torch.inference_mode():
        got = get_model(cfg, "cpu").apply(params, batch).numpy()
    want = np.asarray(json.loads(GOLDEN.read_text())[name], dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["mtwnd", "din", "dien"])
def test_init_numpy_matches_jax_init_distributions(name):
    """Each leaf's spread matches JAX init's (sum_fanin scaling of DIN's
    attention, 1/sqrt(fan_in) RNN weights, zero RNN biases, per-table
    uniform bounds); leaves under 1000 values are too small to compare."""
    got = bridge.flatten(bridge.init_numpy(_cfg(name), 0))
    want = bridge.flatten(_jax_init(name))
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if not w.any():
            assert not g.any(), k
        elif w.size >= 1000:
            np.testing.assert_allclose(g.std(), w.std(), rtol=0.1, err_msg=k)
            np.testing.assert_allclose(np.abs(g).max(), np.abs(w).max(), rtol=0.3, err_msg=k)
