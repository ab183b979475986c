"""DeepRecSys on PyTorch and CUDA: the port of ``deeprecsys_tpu`` to an
NVIDIA Hopper GPU.

The module names follow the JAX package, so each module's counterpart is
easy to find. Framework-neutral layers (``config``, ``zoo``, the CLI
parser, the load generator and bucket ladders) are imported from
``deeprecsys_tpu``, never copied; this package imports ``torch`` and never
``jax``.

- ``ops``     — fused pooled lookup (CUDA kernel K1 + plain version), MLPs,
  the "cat" interaction
- ``models``  — DLRM (``get_model``)
- ``data``    — the random-mode data generator, bit-identical to the JAX one
- ``serving`` — query sizes and splits, bucket ladder and choice
- ``bridge``  — JAX params pytree (as numpy) <-> the port's tensors
- ``main``    — the standalone CLI path
"""

__version__ = "0.1.0"

from deeprecsys_tpu.config import ModelConfig, ServingConfig

__all__ = ["ModelConfig", "ServingConfig"]
