"""Batch-bucket ladders.

Counterpart of ``deeprecsys_tpu/serving/buckets.py:35-138``, copied. The
engines serve each request at the nearest bucket >= its size;
``optimal_bucket_ladder`` picks at most K sizes that minimise the expected
padded work over a size sample, by an exact O(n^2 K) dynamic program over
the distinct sizes:

    f(i, k) = min_{j<i} f(j, k-1) + v_i * (C_i - C_j)

``autotune_buckets`` samples the ServingConfig's own size distribution,
split and routed as the engines would see it, deterministic in cfg.seed.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from deeprecsys_tpu_torch.config import ServingConfig
from deeprecsys_tpu_torch.serving.load_generator import model_batch_sizes, partition_query


def expected_padded_work(sizes, buckets) -> float:
    """Mean padded batch size when serving ``sizes`` on ``buckets``."""
    sizes = np.asarray(sizes)
    buckets = np.sort(np.asarray(buckets))
    idx = np.searchsorted(buckets, sizes)
    idx = np.clip(idx, 0, len(buckets) - 1)  # oversize requests run at cap
    return float(buckets[idx].mean())


def optimal_bucket_ladder(sizes, max_buckets: int = 6) -> tuple[int, ...]:
    """Minimise E[bucket(s)] with at most ``max_buckets`` buckets; the
    largest size is always one, and ties go to fewer buckets."""
    sizes = np.asarray(sizes, dtype=np.int64)
    if sizes.size == 0:
        raise ValueError("need at least one size sample")
    v, c = np.unique(sizes, return_counts=True)  # ascending distinct sizes
    n = len(v)
    K = min(max_buckets, n)
    if K == n:
        return tuple(int(x) for x in v)
    csum = np.concatenate([[0], np.cumsum(c)])  # C_j = count of j smallest

    # f[k][i]: min cost, k buckets covering distinct sizes 1..i, v_{i-1} a bucket.
    f = np.full((K + 1, n + 1), float("inf"))
    f[0][0] = 0.0
    choice = np.zeros((K + 1, n + 1), dtype=np.int64)
    for k in range(1, K + 1):
        for i in range(k, n + 1):
            j = np.arange(k - 1, i)
            costs = f[k - 1][j] + v[i - 1] * (csum[i] - csum[j])
            best = int(np.argmin(costs))
            f[k][i] = costs[best]
            choice[k][i] = j[best]
    best_k = int(np.argmin([f[k][n] for k in range(1, K + 1)])) + 1
    ladder = []
    i, k = n, best_k
    while k > 0:
        ladder.append(int(v[i - 1]))
        i, k = int(choice[k][i]), k - 1
    return tuple(sorted(ladder))


def autotune_buckets(cfg: ServingConfig, max_buckets: int | None = None,
                     n_samples: int = 4096) -> tuple[int, ...]:
    """The ladder for the config's own size distribution: queries at or
    above the accel threshold go whole to the accel engine, the rest are
    split into ``sub_task_batch_size`` chunks (and into every
    ``batch_configs`` size when the scheduler tunes it)."""
    rng = np.random.default_rng(cfg.seed + 9173)
    query_sizes = model_batch_sizes(dataclasses.replace(cfg, num_batches=n_samples), rng)

    sub_sizes = {cfg.sub_task_batch_size}
    if cfg.tune_batch_qps:
        sub_sizes.update(int(b) for b in cfg.batch_configs)

    engine_sizes: list[int] = []
    for s in query_sizes:
        if cfg.model_accel and s >= cfg.accel_request_size_thres:
            engine_sizes.append(int(s))
        else:
            for sub in sub_sizes:
                engine_sizes.extend(partition_query(int(s), sub))
    if cfg.model_accel and cfg.tune_accel_qps:
        engine_sizes.extend(int(s) for s in query_sizes)
    if cfg.model_accel:
        # The cap is always a bucket: a live whole query may exceed the sample's max.
        engine_sizes.append(int(cfg.max_mini_batch_size))
    if max_buckets is None:
        max_buckets = cfg.max_auto_buckets
    return optimal_bucket_ladder(engine_sizes, max_buckets)


def resolve_buckets(cfg: ServingConfig) -> tuple[int, ...]:
    """The engine-facing entry: the static ladder or the autotuned one."""
    if cfg.bucket_policy == "auto":
        return autotune_buckets(cfg)
    return tuple(cfg.batch_buckets)
