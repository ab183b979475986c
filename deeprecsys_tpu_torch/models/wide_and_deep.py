"""Wide & Deep; counterpart of ``deeprecsys_tpu/models/wide_and_deep.py``.

Reference: ``models/wide_and_deep.py`` — no bottom MLP: the dense features
(width ``mlp_bot[0]``) are concatenated raw with all pooled embeddings,
then a top MLP ending in a sigmoid (:383).
"""

from __future__ import annotations

import torch

from deeprecsys_tpu_torch.config import ModelConfig
from deeprecsys_tpu_torch.models.base import (
    Batch, compute_dtype_of, init_tables, param_dtype_of, pooled_lookup)
from deeprecsys_tpu_torch.ops import cat_interaction, mlp_apply, mlp_init


def init(generator: torch.Generator, cfg: ModelConfig,
         device: torch.device | str) -> dict:
    if len(cfg.mlp_bot) != 1:
        raise ValueError("WnD takes raw dense features; mlp_bot must be a single "
                         "width (reference check wide_and_deep.py:307-313)")
    return {
        "tables": init_tables(cfg, generator, device),
        "top": mlp_init(cfg.ln_top, param_dtype_of(cfg), generator, device),
    }


def apply_from_pooled(params: dict, pooled: torch.Tensor, batch: Batch,
                      cfg: ModelConfig) -> torch.Tensor:
    z = cat_interaction(batch.dense.to(compute_dtype_of(cfg)), pooled)
    return mlp_apply(params["top"], z, sigmoid_layer=len(cfg.ln_top) - 1)


def apply(params: dict, batch: Batch, cfg: ModelConfig,
          offsets: torch.Tensor | None = None) -> torch.Tensor:
    pooled = pooled_lookup(params["tables"], batch, cfg, offsets=offsets)
    return apply_from_pooled(params, pooled, batch, cfg)
