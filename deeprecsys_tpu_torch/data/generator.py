"""Input generation in the fused-table layout: random, synthetic and dataset.

Counterpart of ``deeprecsys_tpu/data/generator.py``, copied (the port
imports nothing of the JAX package, and that module pulls in jax through
its ``Batch``). The numpy draws are the same calls in the same order, so one
seed gives bit-identical batches in both packages:

- ``random``: uniform dense features, then per (table, sample) a sorted
  group of ``num_indices_per_lookup`` unique ids by whole-group rejection
  resampling (reference ``data_generator/dlrm_data_caffe2.py:69-124``);
- ``synthetic``: per-table stack-distance trace replay by an LRU stack
  model (``data/trace.py``; reference :152-227), each table's state made
  lazily, in table order, at its first lookup, and kept across batches;
  through the native runtime's ``drs_trace_generate_lru`` when it builds
  (``NativeLruTrace``, the JAX package's stream for a seed), else the numpy
  loop;
- ``dataset``: a Criteo TSV (``data/criteo.py``) read batch by batch,
  cycling at its end; ``generate_targets`` then returns the file's labels.

Batches hold numpy arrays; ``Batch.to(device)`` moves them to tensors.
"""

from __future__ import annotations

import numpy as np

from deeprecsys_tpu_torch.config import ModelConfig
from deeprecsys_tpu_torch.data import trace as trace_mod
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

    def __init__(self, cfg: ModelConfig, seed: int = 123, data_generation: str = "random",
                 trace_file: str | None = None, trace_enable_padding: bool = False,
                 raw_data_file: str | None = None):
        self.cfg = cfg
        self.rng = np.random.default_rng(seed)
        self.data_generation = data_generation
        self.trace_file = trace_file
        self.trace_enable_padding = trace_enable_padding
        self.raw_data_file = raw_data_file
        if data_generation not in ("random", "synthetic", "dataset"):
            raise ValueError(f"unknown data_generation {data_generation!r}")
        if data_generation == "synthetic" and trace_file is None:
            raise ValueError("synthetic mode requires a trace (distribution) file")
        if data_generation == "dataset":
            # Criteo TSV streamed into the fused layout, cycling at EOF
            # (reference dlrm_data_caffe2.py:36-37, --raw_data_file).
            if raw_data_file is None:
                raise ValueError("dataset mode requires --raw_data_file")
            from deeprecsys_tpu_torch.data.criteo import CriteoReader

            self._reader = CriteoReader(raw_data_file, cfg)
            self._ds_iter = None
            self._ds_iter_bs = None
            self.last_labels: np.ndarray | None = None

    def generate_batch(self, batch_size: int) -> Batch:
        if self.data_generation == "dataset":
            batch, self.last_labels = self._next_dataset(batch_size)
            return batch
        dense = None
        if self.cfg.dense_dim:
            dense = self.rng.random((batch_size, self.cfg.dense_dim), dtype=np.float32)
        if self.data_generation == "random":
            indices = self._random_indices(batch_size)
        else:
            indices = self._synthetic_indices(batch_size)
        return Batch(dense=dense, indices=indices)

    def generate_targets(self, batch_size: int, round_targets: bool = False) -> np.ndarray:
        """Uniform targets (reference ``dlrm_data_caffe2.py:128-148``); in
        dataset mode the file's labels of the batch ``generate_batch``
        returned last."""
        if self.data_generation == "dataset":
            if self.last_labels is None or len(self.last_labels) < batch_size:
                raise ValueError(
                    "dataset targets follow generate_batch: call it first "
                    "with batch_size >= the requested target count")
            return self.last_labels[:batch_size]
        t = self.rng.random((batch_size, self.cfg.out_dim), dtype=np.float32)
        if round_targets:
            t = np.round(t).astype(np.float32)
        return t

    def _next_dataset(self, batch_size: int):
        if self._ds_iter_bs != batch_size:
            self._ds_iter = None  # another batch size: the stream restarts
        for _ in range(2):
            if self._ds_iter is None:
                self._ds_iter = self._reader.batches(batch_size)
                self._ds_iter_bs = batch_size
            try:
                return next(self._ds_iter)
            except StopIteration:
                self._ds_iter = None  # EOF: cycle from the top
        raise ValueError(f"dataset {self.raw_data_file!r} holds fewer than "
                         f"{batch_size} rows (one full batch)")

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

    def _trace_state(self, t: int):
        """Table ``t``'s distribution and LRU line state, made at its first
        lookup and kept across batches, so the stream continues as the
        reference's pre-generate-all-batches loop does."""
        if not hasattr(self, "_trace_cache"):
            from deeprecsys_tpu_torch.runtime.native import native_available

            self._trace_cache = {}
            self._trace_native = native_available()
        if t not in self._trace_cache:
            # The reference puts the table id in the file name
            # ("dist_emb_j.log"); without a placeholder every table reads
            # the same file.
            path = self.trace_file.replace("@", str(t)) if "@" in self.trace_file \
                else self.trace_file
            la, sd, cdf = trace_mod.read_dist_from_file(path)
            trace_mod.validate_cdf(cdf, path)
            if la is None and self._trace_native:
                # A 2-line file holds no line accesses: a random permutation
                # of this table's rows (trace_generator.py:70), the draw of
                # random_line_accesses kept as an int64 array for the
                # native stream, not a list of millions of ints.
                la = self.rng.permutation(int(self.cfg.scaled_rows[t]))
            elif la is None:
                la = trace_mod.random_line_accesses(int(self.cfg.scaled_rows[t]), rng=self.rng)
            if self._trace_native:
                self._trace_cache[t] = trace_mod.NativeLruTrace(
                    la, sd, cdf, seed=int(self.rng.integers(1 << 62)),
                    enable_padding=self.trace_enable_padding)
            else:
                # [la, sd, cdf, introduced-lines counter], the counter
                # carried across calls as the native state carries it.
                self._trace_cache[t] = [la, sd, cdf, 0]
        return self._trace_cache[t]

    def _trace_refs(self, t: int, count: int) -> np.ndarray:
        state = self._trace_state(t)
        if self._trace_native:
            return state.generate(count)
        la, sd, cdf, i = state
        refs, state[3] = trace_mod.trace_generate_lru(
            la, sd, cdf, count, self.trace_enable_padding, rng=self.rng,
            i_start=i, return_i=True)
        return np.asarray(refs, dtype=np.int64)

    def _synthetic_indices(self, batch_size: int) -> np.ndarray:
        cfg = self.cfg
        L = cfg.num_indices_per_lookup
        out = np.empty((batch_size, cfg.num_tables, L), dtype=np.int32)
        for t, size in enumerate(cfg.scaled_rows):
            for b in range(batch_size):
                refs = self._trace_refs(t, L)
                if refs.min(initial=0) < 0 or refs.max(initial=0) >= size:
                    refs = np.mod(refs, size)  # the reference's mod guard (:207-215)
                # Dedup after the mod, in first-occurrence order, so that the
                # truncation to L below keeps the first draws, not the
                # smallest ids.
                group = _unique_in_draw_order(refs)
                # Top up to L; draws double on rounds that add nothing, and
                # a trace with fewer than L distinct residues fails.
                stalled = 0
                draw = max(L - group.size, 1)
                while group.size < L:
                    extra = self._trace_refs(t, draw)
                    new = _unique_in_draw_order(np.concatenate([group, np.mod(extra, size)]))
                    if new.size == group.size:
                        stalled += 1
                        draw = min(draw * 2, 4096)
                    else:
                        stalled = 0
                        draw = max(L - new.size, 1)
                    group = new
                    if stalled >= 24:
                        raise ValueError(
                            f"synthetic trace for table {t} yields only "
                            f"{group.size} distinct ids under mod {size}, "
                            f"< num_indices_per_lookup={L}; use a richer "
                            "distribution file or a smaller L")
                out[b, t, :] = np.sort(group[:L]).astype(np.int32)
        return out


def _unique_in_draw_order(a: np.ndarray) -> np.ndarray:
    """The distinct values of ``a`` in the order of their first occurrence."""
    _, idx = np.unique(a, return_index=True)
    return a[np.sort(idx)]
