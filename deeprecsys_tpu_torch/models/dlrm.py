"""DLRM (RMC1/RMC2/RMC3 via configs); counterpart of ``deeprecsys_tpu/models/dlrm.py``.

Reference: ``models/dlrm_s_caffe2.py`` — bottom MLP over dense features,
per-table pooled lookups, "cat" (the zoo's) or "dot" (the Criteo config's)
interaction, top MLP ending in a sigmoid
(``sigmoid_top = ln_top.size - 1``, :473).
"""

from __future__ import annotations

import torch

from deeprecsys_tpu_torch.config import ModelConfig
from deeprecsys_tpu_torch.models.base import (
    Batch, compute_dtype_of, init_tables, param_dtype_of, pooled_lookup)
from deeprecsys_tpu_torch.ops import cat_interaction, dot_interaction, mlp_apply, mlp_init


def init(generator: torch.Generator, cfg: ModelConfig,
         device: torch.device | str) -> dict:
    if cfg.mlp_bot[-1] != cfg.sparse_feature_size:
        raise ValueError(
            f"bottom-MLP out dim {cfg.mlp_bot[-1]} must equal sparse feature "
            f"size {cfg.sparse_feature_size} (reference dlrm_s_caffe2.py:436-438)")
    pdt = param_dtype_of(cfg)
    return {
        "tables": init_tables(cfg, generator, device),
        "bot": mlp_init(cfg.mlp_bot, pdt, generator, device),
        "top": mlp_init(cfg.ln_top, pdt, generator, device),
    }


def apply_from_pooled(params: dict, pooled: torch.Tensor, batch: Batch,
                      cfg: ModelConfig) -> torch.Tensor:
    """Forward from pooled embeddings (B, T, d)."""
    x = batch.dense.to(compute_dtype_of(cfg))
    dense_out = mlp_apply(params["bot"], x)  # all-ReLU (sigmoid_bot = -1)
    if cfg.interaction_op == "dot":
        z = dot_interaction(dense_out, pooled, self_interaction=cfg.interaction_itself)
    else:
        z = cat_interaction(dense_out, pooled)
    # Sigmoid on the final top layer (reference sigmoid_top).
    return mlp_apply(params["top"], z, sigmoid_layer=len(cfg.ln_top) - 1)


def apply(params: dict, batch: Batch, cfg: ModelConfig,
          offsets: torch.Tensor | None = None) -> torch.Tensor:
    pooled = pooled_lookup(params["tables"], batch, cfg, offsets=offsets)
    return apply_from_pooled(params, pooled, batch, cfg)
