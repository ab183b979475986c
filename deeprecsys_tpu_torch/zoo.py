"""The zoo configurations, shared with the JAX package (``deeprecsys_tpu/zoo.py``)."""

from deeprecsys_tpu.zoo import MODEL_NAMES, get_config

__all__ = ["MODEL_NAMES", "get_config"]
