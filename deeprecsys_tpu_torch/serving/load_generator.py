"""Query sizes and their split into sub-batches.

Counterpart of ``deeprecsys_tpu/serving/load_generator.py:26-72``
(reference ``loadGenerator.py:20-54``), copied without the JAX package's
pacer, scheduler and packets: the port has no serving engines yet.
"""

from __future__ import annotations

import numpy as np

from deeprecsys_tpu_torch.config import ServingConfig


def model_batch_sizes(cfg: ServingConfig, rng: np.random.Generator) -> np.ndarray:
    """Per-query sizes from the configured distribution, clipped to
    [1, max_mini_batch_size]."""
    n = cfg.num_batches
    if cfg.batch_size_distribution == "normal":
        sizes = rng.normal(cfg.avg_mini_batch_size, cfg.var_mini_batch_size, n)
    elif cfg.batch_size_distribution == "lognormal":
        sizes = rng.lognormal(cfg.avg_mini_batch_size, cfg.var_mini_batch_size, n)
    elif cfg.batch_size_distribution == "fixed":
        sizes = np.full(n, cfg.avg_mini_batch_size)
    elif cfg.batch_size_distribution == "file":
        with open(cfg.batch_dist_file) as f:
            percentiles = [float(line.strip()) for line in f if line.strip()]
        # integers(), not int(uniform()): uniform(0, high) can round to high.
        sizes = np.asarray([percentiles[rng.integers(0, len(percentiles))]
                            for _ in range(n)])
    else:
        raise ValueError(f"unknown batch_size_distribution {cfg.batch_size_distribution!r}")
    return np.clip(sizes, 1, cfg.max_mini_batch_size).astype(np.int64)


def partition_query(batch_size: int, sub_task_batch_size: int) -> list[int]:
    """Split a query into sub-batches of at most ``sub_task_batch_size``."""
    if sub_task_batch_size <= 0:
        raise ValueError(
            f"sub_task_batch_size must be positive, got {sub_task_batch_size}")
    out = []
    while batch_size > 0:
        chunk = min(sub_task_batch_size, batch_size)
        out.append(chunk)
        batch_size -= chunk
    return out
