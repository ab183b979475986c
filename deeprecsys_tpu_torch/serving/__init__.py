"""The serving stack of the port.

Counterparts of ``deeprecsys_tpu/serving/``: the load generator with
Poisson arrivals and query splitting (``load_generator.py``), the
DeepRecSched hill climber (``scheduler.py``), the inference engines
(``engine.py``: on the CUDA card through K1, and K3 for dien), the
response aggregator (``metrics.py``) and ``run_serving``
(``orchestrator.py``), the cpu-mp engine processes
(``process_engine.py``) and the HTTP ingress (``ingress.py``); plus the
bucket ladder (``buckets.py``), the packets and the latency model of the
sim engines. Nothing here imports the JAX package.
"""

from deeprecsys_tpu_torch.serving.buckets import resolve_buckets
from deeprecsys_tpu_torch.serving.engine import pick_bucket
from deeprecsys_tpu_torch.serving.load_generator import (
    LoadGenerator, model_batch_sizes, partition_query)
from deeprecsys_tpu_torch.serving.orchestrator import ServingResult, run_serving
from deeprecsys_tpu_torch.serving.packets import ServiceRequest, ServiceResponse
from deeprecsys_tpu_torch.serving.scheduler import DeepRecScheduler

__all__ = [
    "ServiceRequest",
    "ServiceResponse",
    "DeepRecScheduler",
    "LoadGenerator",
    "run_serving",
    "ServingResult",
    "model_batch_sizes",
    "partition_query",
    "pick_bucket",
    "resolve_buckets",
]
