"""Serving pieces of the port.

Query sizes and their split into sub-batches (``model_batch_sizes``,
``partition_query``) and the bucket ladder (``resolve_buckets``) hold no
framework code, so they are imported from the JAX package
(``deeprecsys_tpu/serving/load_generator.py``, ``serving/buckets.py``).
``pick_bucket`` is ported: its home, ``serving/engine.py``, imports jax.
Importing this module imports the JAX package's load generator, which
builds its native pacer at first import (into ``DRS_NATIVE_CACHE`` when
that is set).
"""

from deeprecsys_tpu.serving.buckets import resolve_buckets
from deeprecsys_tpu.serving.load_generator import model_batch_sizes, partition_query

__all__ = ["model_batch_sizes", "partition_query", "pick_bucket", "resolve_buckets"]


def pick_bucket(buckets, batch_size: int) -> int:
    """Smallest bucket >= batch_size in the ascending ``buckets``; the last
    bucket caps (``deeprecsys_tpu/serving/engine.py:89``)."""
    return next((b for b in buckets if b >= batch_size), buckets[-1])
