"""Criteo/Kaggle click-logs adapter.

A copy of ``deeprecsys_tpu/data/criteo.py`` over the port's ``Batch`` and
``ModelConfig`` (the port imports nothing of the JAX package);
``tests/test_torch_config.py`` holds it equal to the original.

The reference CLI carries ``--data_set kaggle`` / ``--raw_data_file``
(utils/utils.py:58-60) inherited from the DLRM lineage, but the shipped
DeepRecSys path only ever exercises synthetic data. This adapter makes the
real-dataset path first-class: Criteo display-advertising TSV
(label \t 13 integer features \t 26 categorical hex features) streamed
into the fused (B, T, L=1) batch layout.

Preprocessing follows the standard DLRM recipe:
- integer features: x -> log(1 + max(x, 0)) (missing -> 0);
- categorical features: hex id hashed (splitmix-style) into the
  configured table's row range (missing -> 0);
- labels returned as (B, 1) float.

Use ``criteo_model_config`` for a DLRM config whose table layout matches
the 26 categorical columns.
"""

from __future__ import annotations

import math
from pathlib import Path

import numpy as np

from deeprecsys_tpu_torch.config import ModelConfig
from deeprecsys_tpu_torch.models.base import Batch

NUM_INT = 13
NUM_CAT = 26


def criteo_model_config(rows_per_table: int = 1_000_000, d: int = 32,
                        mlp_bot=(13, 64, 32), mlp_top=(256, 64, 1)) -> ModelConfig:
    """DLRM config matching Criteo's 13 dense + 26 categorical columns."""
    return ModelConfig(
        model_type="dlrm", model_name="criteo-dlrm",
        mlp_bot=tuple(mlp_bot), mlp_top=tuple(mlp_top),
        embedding_rows=(rows_per_table,) * NUM_CAT,
        sparse_feature_size=d, num_indices_per_lookup=1,
        interaction_op="dot",
    )


def _hash_hex(h: str, mod: int) -> int:
    """Deterministic hash of a Criteo hex id into [0, mod)."""
    try:
        x = int(h, 16)
    except ValueError:
        x = sum(h.encode())
    # splitmix64 finalizer
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (x ^ (x >> 31)) % mod


class CriteoReader:
    """Streams Criteo TSV into fused-layout batches.

    Reference interface analog: the data-layer generate/slice pattern, but
    reading a real dataset file (``--raw_data_file``).
    """

    def __init__(self, path: str | Path, cfg: ModelConfig):
        if cfg.num_tables != NUM_CAT:
            raise ValueError(f"config must have {NUM_CAT} tables for Criteo")
        if cfg.num_indices_per_lookup != 1:
            raise ValueError("Criteo has one id per categorical column")
        self.path = Path(path)
        self.cfg = cfg

    def batches(self, batch_size: int, max_batches: int | None = None):
        """Yield (Batch, labels (B,1) float32); the final partial batch is
        dropped (static shapes)."""
        rows = self.cfg.scaled_rows
        dense = np.zeros((batch_size, NUM_INT), np.float32)
        idx = np.zeros((batch_size, NUM_CAT, 1), np.int32)
        labels = np.zeros((batch_size, 1), np.float32)
        n = 0
        emitted = 0
        with open(self.path) as f:
            for line in f:
                parts = line.rstrip("\r\n").split("\t")  # CRLF-safe: a stray \r corrupts col 26's ids
                if len(parts) < 1 + NUM_INT + NUM_CAT:
                    parts = parts + [""] * (1 + NUM_INT + NUM_CAT - len(parts))
                labels[n, 0] = float(parts[0] or 0)
                for j in range(NUM_INT):
                    v = parts[1 + j]
                    x = int(v) if v not in ("", None) else 0
                    dense[n, j] = math.log1p(max(x, 0))
                for j in range(NUM_CAT):
                    v = parts[1 + NUM_INT + j]
                    idx[n, j, 0] = _hash_hex(v, rows[j]) if v else 0
                n += 1
                if n == batch_size:
                    yield Batch(dense=dense.copy(), indices=idx.copy()), labels.copy()
                    n = 0
                    emitted += 1
                    if max_batches is not None and emitted >= max_batches:
                        return


def write_synthetic_criteo(path: str | Path, num_rows: int, seed: int = 0,
                           missing_rate: float = 0.05,
                           signal: bool = False):
    """Write a synthetic Criteo-format TSV (for tests/smoke runs).
    ``signal=True`` ties the label to the first integer feature (with
    10% flip noise) so held-out AUC is a meaningful learnability check
    rather than coin-flipping on random labels."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for _ in range(num_rows):
            label = int(rng.random() < 0.25)
            ints = [
                "" if rng.random() < missing_rate else str(int(rng.integers(0, 5000)))
                for _ in range(NUM_INT)
            ]
            cats = [
                "" if rng.random() < missing_rate else f"{int(rng.integers(0, 1 << 32)):08x}"
                for _ in range(NUM_CAT)
            ]
            if signal:
                # Threshold low in the raw range: log1p compresses the
                # top decades, so a midpoint split leaves the model a
                # ~0.7 log-unit margin while 500 leaves ~2.3.
                x = int(ints[0]) if ints[0] else 0
                label = int(x > 500)
                if rng.random() < 0.10:
                    label = 1 - label
            f.write("\t".join([str(label)] + ints + cats) + "\n")
