"""The port's serving module: ``pick_bucket`` against the JAX engine's."""

import pytest

from deeprecsys_tpu.config import ServingConfig
from deeprecsys_tpu.serving.engine import pick_bucket as jax_pick_bucket
from deeprecsys_tpu_torch import serving


@pytest.mark.parametrize("max_batch", [32, 1024])
def test_pick_bucket_matches_engine(max_batch):
    scfg = ServingConfig(max_mini_batch_size=max_batch, sub_task_batch_size=32)
    buckets = tuple(b for b in sorted(serving.resolve_buckets(scfg)) if b <= max_batch)
    for n in range(1, 2 * max_batch + 1):
        assert serving.pick_bucket(buckets, n) == jax_pick_bucket(buckets, n)
