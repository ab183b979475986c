"""``tests/golden/torch_port_train.npz``, the JAX trainer's losses that
``chip_smoke.py`` reproduces on the card, against a fresh build from the
JAX package (so it cannot go stale), and chip_smoke's check of it run here
on the CPU, where every kernel wrapper takes its plain version (the losses
within ``chip_smoke.TRAIN_LOSS_RTOL``; measured here at most 3.5e-7)."""

import numpy as np
import pytest
import torch

import chip_smoke
from tests.golden import make_torch_port_fixture as fixture


@pytest.mark.parametrize("mode", fixture.TRAIN_MODES)
@pytest.mark.parametrize("name", fixture.TRAIN_MODELS)
def test_train_fixture_is_current(name, mode):
    stored = np.load(fixture.TRAIN_PATH)
    fresh = fixture.build_train_model(name, mode)
    prefix = f"{name}/{mode}/"
    assert sorted(k for k in stored.files if k.startswith(prefix)) == \
        sorted(prefix + k for k in fresh)
    for k, v in fresh.items():
        if k in ("losses", "fingerprint"):
            np.testing.assert_allclose(stored[prefix + k], v, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(stored[prefix + k], v, err_msg=k)


@pytest.mark.parametrize("mode", fixture.TRAIN_MODES)
@pytest.mark.parametrize("name", fixture.TRAIN_MODELS)
def test_chip_smoke_train_fixture_check_on_cpu(name, mode):
    err = chip_smoke.train_fixture_case(torch.device("cpu"), np.load(fixture.TRAIN_PATH),
                                        name, mode)
    assert err <= chip_smoke.TRAIN_LOSS_RTOL
