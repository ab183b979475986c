"""The port's data generator against the JAX package's: same seed, same bits."""

import numpy as np
import pytest

from deeprecsys_tpu import zoo as jax_zoo
from deeprecsys_tpu.data import RecDataGenerator as JaxGenerator
from deeprecsys_tpu_torch import zoo
from deeprecsys_tpu_torch.data import RecDataGenerator


# rm1 at scale 2000 and rm2 take the dense-fallback draw (L*(L-1) >= rows),
# rm1 at scale 100 the rejection-resampling loop, ncf the L == 1 draw.
@pytest.mark.parametrize("name,scale", [("rm1", 2000), ("rm1", 100),
                                        ("rm2", 2000), ("ncf", 2000)])
@pytest.mark.parametrize("seed,batch", [(0, 1), (1, 8), (7, 33)])
def test_generator_bit_identical_to_jax(name, scale, seed, batch):
    want = JaxGenerator(jax_zoo.get_config(name, table_scale=scale),
                        seed=seed).generate_batches(3, batch)
    got = RecDataGenerator(zoo.get_config(name, table_scale=scale),
                           seed=seed).generate_batches(3, batch)
    for w, g in zip(want, got):
        assert g.indices.dtype == np.int32 and g.indices.shape == w.indices.shape
        np.testing.assert_array_equal(g.indices, w.indices)
        if w.dense is None:
            assert g.dense is None
        else:
            assert g.dense.dtype == w.dense.dtype
            np.testing.assert_array_equal(g.dense, w.dense)


def test_groups_sorted_unique_in_range():
    cfg = zoo.get_config("rm1", table_scale=100)
    idx = RecDataGenerator(cfg, seed=3).generate_batch(16).indices
    assert (np.diff(idx, axis=-1) > 0).all()
    assert idx.min() >= 0 and idx.max() < min(cfg.scaled_rows)


@pytest.mark.parametrize("mode", ["synthetic", "dataset"])
def test_unported_modes_raise(mode):
    """Both modes are ported (tests/test_torch_data_modes.py); each raises,
    as the JAX generator does, when it is not given its input file."""
    cfg = zoo.get_config("rm1", table_scale=2000)
    with pytest.raises(ValueError, match="requires"):
        RecDataGenerator(cfg, data_generation=mode)
    with pytest.raises(ValueError, match="requires"):
        JaxGenerator(jax_zoo.get_config("rm1", table_scale=2000), data_generation=mode)
