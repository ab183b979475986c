"""Serving pieces of the port.

Query sizes and their split into sub-batches (``load_generator.py``), the
bucket ladder (``buckets.py``) and the choice of bucket (``pick_bucket``):
counterparts of ``deeprecsys_tpu/serving/{load_generator,buckets,engine}.py``,
copied, so that nothing here imports the JAX package or builds its native
pacer.
"""

from deeprecsys_tpu_torch.serving.buckets import resolve_buckets
from deeprecsys_tpu_torch.serving.load_generator import model_batch_sizes, partition_query

__all__ = ["model_batch_sizes", "partition_query", "pick_bucket", "resolve_buckets"]


def pick_bucket(buckets, batch_size: int) -> int:
    """Smallest bucket >= batch_size in the ascending ``buckets``; the last
    bucket caps (``deeprecsys_tpu/serving/engine.py:89``)."""
    return next((b for b in buckets if b >= batch_size), buckets[-1])
