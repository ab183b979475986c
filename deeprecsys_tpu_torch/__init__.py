"""DeepRecSys on PyTorch and CUDA: the port of ``deeprecsys_tpu`` to an
NVIDIA Hopper GPU.

The module names follow the JAX package, so each module's counterpart is
easy to find. This package imports ``torch`` and nothing of JAX or of the
JAX package, not even its framework-neutral modules: ``config``, ``zoo``,
the CLI parser and the serving helpers are copies, which
``tests/test_torch_config.py`` holds equal to the originals.

- ``config``  — ``ModelConfig`` and ``ServingConfig``
- ``zoo``     — the eight zoo configurations (``get_config``)

- ``ops``     — fused pooled lookup (CUDA kernel K1 + plain version), DIEN's
  RNN scan (CUDA kernel K3 + plain loop), MLPs, the "cat" interaction
- ``models``  — the six families of the eight zoo models: DLRM, WnD,
  MT-WnD, NCF, DIN, DIEN (``get_model``)
- ``data``    — the random-mode data generator, bit-identical to the JAX one
- ``serving`` — the serving stack: load generator (Poisson arrivals, query
  splitting), DeepRecSched, the inference engines (each on its own CUDA
  stream), the response aggregator and ``run_serving``
- ``bridge``  — JAX params pytree (as numpy) <-> the port's tensors, and
  a numpy draw of a model's params from a seed
- ``main``    — the CLI: ``--queue`` (serving) and standalone
"""

__version__ = "0.1.0"

from deeprecsys_tpu_torch.config import ModelConfig, ServingConfig

__all__ = ["ModelConfig", "ServingConfig"]
