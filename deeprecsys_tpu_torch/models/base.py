"""Common model substrate (counterpart of ``deeprecsys_tpu/models/base.py``).

A model is a pair of functions over one batch layout:

    init(generator)       -> params (dict of tensors, the JAX pytree's shape)
    apply(params, batch)  -> scores (B, out_dim)
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from deeprecsys_tpu.config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class Batch(NamedTuple):
    """One batch in the fused-table layout (see ops/embedding.py).

    The generator yields numpy arrays; ``to(device)`` gives the tensors the
    models take. ``mask`` marks ragged pooling slots; None = all full.
    """

    dense: Optional[torch.Tensor]  # (B, dense_dim) float, or None
    indices: torch.Tensor          # (B, T, L) int32, per-table-local ids
    mask: Optional[torch.Tensor] = None  # (B, T, L) bool, or None

    def to(self, device: torch.device | str) -> "Batch":
        def conv(x):
            return None if x is None else torch.as_tensor(x).to(device)

        return Batch(conv(self.dense), conv(self.indices), conv(self.mask))


class ModelFns(NamedTuple):
    name: str
    init: Callable[[torch.Generator], dict]
    apply: Callable[[dict, Batch], torch.Tensor]
    cfg: ModelConfig
    apply_from_pooled: Callable = None


def compute_dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _dtype(cfg.compute_dtype)


def param_dtype_of(cfg: ModelConfig) -> torch.dtype:
    return _dtype(cfg.param_dtype)


def _dtype(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r} (valid: {sorted(_DTYPES)})")
    return _DTYPES[name]


def table_offsets(cfg: ModelConfig, device: torch.device | str) -> torch.Tensor:
    """``cfg.table_offsets`` as an int32 tensor on ``device``."""
    return torch.as_tensor(cfg.table_offsets, dtype=torch.int32).to(device)


def init_tables(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str) -> torch.Tensor:
    """The fused ``(total_rows, d)`` table, always in the unpacked layout."""
    from deeprecsys_tpu_torch.ops import init_fused_tables

    if cfg.table_quant != "none":
        raise NotImplementedError(
            f"table_quant={cfg.table_quant!r} is not ported yet "
            "(ROADMAP.md Queue 1 item 8, quantized tables)")
    return init_fused_tables(cfg.scaled_rows, cfg.sparse_feature_size,
                             param_dtype_of(cfg), generator, device)


def pooled_lookup(tables, batch: Batch, cfg: ModelConfig,
                  offsets: torch.Tensor | None = None) -> torch.Tensor:
    """The model-facing fused pooled lookup: (B, T, d) in the compute dtype.

    ``offsets`` may be passed precomputed on the table's device (the
    models do, so a forward makes no host-to-device copy for them).
    """
    from deeprecsys_tpu_torch.ops import embedding_bag

    if cfg.embedding_impl == "hotcold":
        raise NotImplementedError(
            "embedding_impl='hotcold' is not ported yet "
            "(ROADMAP.md Queue 1 item 10, hot/cold serving)")
    if cfg.embedding_impl not in ("xla", "auto"):
        raise ValueError(f"unknown embedding_impl {cfg.embedding_impl!r} "
                         "(valid: 'xla', 'hotcold', 'auto')")
    if isinstance(tables, dict):
        raise NotImplementedError(
            f"quantized or packed tables ({sorted(tables)}) are not ported yet "
            "(ROADMAP.md Queue 1 item 8); bridge.params_from_numpy unpacks "
            "float tables")
    if offsets is None:
        offsets = table_offsets(cfg, tables.device)
    return embedding_bag(tables, offsets, batch.indices,
                         compute_dtype=compute_dtype_of(cfg), mask=batch.mask)
