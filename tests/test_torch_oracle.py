"""The port's eight zoo models against the independent NumPy oracle of the
reference graphs (``tests/oracle/np_reference.py``: per-table
SparseLengthsSum loops, Caffe2 (out, in) FC weights, per-table attention
chains, stepwise RNNs), as ``tests/test_parity.py::test_oracle_parity``
holds the JAX package: f32, ``table_scale=2000``, the port's own init
(``model.init``) read out through ``bridge.params_to_numpy``, rtol and atol
1e-5. The oracle imports only numpy."""

import numpy as np
import pytest
import torch

from deeprecsys_tpu_torch import bridge, zoo
from deeprecsys_tpu_torch.data import RecDataGenerator
from deeprecsys_tpu_torch.models import get_model
from tests.oracle.np_reference import csr_from_batch, oracle_forward, oracle_weights_from_params

SCALE = 2000


@pytest.mark.parametrize("name", zoo.MODEL_NAMES)
@pytest.mark.parametrize("seed", [0, 1])
def test_port_matches_the_numpy_oracle(name, seed):
    cfg = zoo.get_config(name, table_scale=SCALE)
    model = get_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(seed))
    host = RecDataGenerator(cfg, seed=seed + 1).generate_batch(8)
    with torch.inference_mode():
        ours = model.apply(params, host.to("cpu")).double().numpy()

    w = oracle_weights_from_params(bridge.params_to_numpy(params, cfg), cfg)
    S_indices, S_lengths = csr_from_batch(host.indices)
    X = None if host.dense is None else np.asarray(host.dense, dtype=np.float64)
    ref = oracle_forward(cfg, w, X, S_indices, S_lengths)

    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5,
                               err_msg=f"oracle parity failed for {name}")
