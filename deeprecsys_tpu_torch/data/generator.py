"""Synthetic input generation, random mode.

Counterpart of ``deeprecsys_tpu/data/generator.py:30-165``, which cannot be
imported here (it pulls in jax through its ``Batch``). The numpy draws are
the same calls in the same order, so one seed gives bit-identical batches in
both packages: uniform dense features, then per (table, sample) a sorted
group of ``num_indices_per_lookup`` unique ids by whole-group rejection
resampling (reference ``data_generator/dlrm_data_caffe2.py:69-124``).
Batches hold numpy arrays; ``Batch.to(device)`` moves them to tensors.
"""

from __future__ import annotations

import numpy as np

from deeprecsys_tpu.config import ModelConfig
from deeprecsys_tpu_torch.models.base import Batch


def _unique_index_groups(rng: np.random.Generator, size: int, rows: int, L: int) -> np.ndarray:
    """Draw ``rows`` groups of ``L`` unique sorted indices in [0, size)."""
    if L == 1:
        return np.round(rng.random((rows, 1)) * (size - 1)).astype(np.int32)
    if L > size:
        raise ValueError(f"pooling factor {L} exceeds table size {size}")
    if L * (L - 1) >= size:
        # Dense fallback for scaled-down tables, where rejection would
        # thrash: a random partial permutation per row.
        keys = rng.random((rows, size))
        idx = np.argpartition(keys, L - 1, axis=1)[:, :L].astype(np.int32)
        return np.sort(idx, axis=1)
    idx = np.round(rng.random((rows, L)) * (size - 1)).astype(np.int32)
    idx = np.sort(idx, axis=1)
    for _ in range(64):
        bad = (idx[:, 1:] == idx[:, :-1]).any(axis=1)
        n_bad = int(bad.sum())
        if n_bad == 0:
            return idx
        redraw = np.round(rng.random((n_bad, L)) * (size - 1)).astype(np.int32)
        idx[bad] = np.sort(redraw, axis=1)
    raise RuntimeError("rejection resampling failed to produce unique groups")


class RecDataGenerator:
    """Generates batches in the fused-table layout for one model config."""

    def __init__(self, cfg: ModelConfig, seed: int = 123,
                 data_generation: str = "random"):
        if data_generation in ("synthetic", "dataset"):
            raise NotImplementedError(
                f"data_generation={data_generation!r} is not ported yet "
                "(ROADMAP.md Queue 1 item 1); only 'random' is")
        if data_generation != "random":
            raise ValueError(f"unknown data_generation {data_generation!r}")
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)

    def generate_batch(self, batch_size: int) -> Batch:
        dense = None
        if self.cfg.dense_dim:
            dense = self.rng.random((batch_size, self.cfg.dense_dim), dtype=np.float32)
        return Batch(dense=dense, indices=self._random_indices(batch_size))

    def generate_batches(self, num_batches: int, batch_size: int) -> list[Batch]:
        return [self.generate_batch(batch_size) for _ in range(num_batches)]

    def _random_indices(self, batch_size: int) -> np.ndarray:
        cfg = self.cfg
        L = cfg.num_indices_per_lookup
        out = np.empty((batch_size, cfg.num_tables, L), dtype=np.int32)
        sizes = np.asarray(cfg.scaled_rows)
        # Identical-size tables share one batched draw (as in the JAX package).
        for size in np.unique(sizes):
            cols = np.flatnonzero(sizes == size)
            draws = _unique_index_groups(self.rng, int(size), batch_size * len(cols), L)
            out[:, cols, :] = draws.reshape(batch_size, len(cols), L)
        return out
