"""Multi-Task Wide & Deep; counterpart of ``deeprecsys_tpu/models/multi_task_wnd.py``.

Reference: ``models/multi_task_wnd.py`` — the WnD input, an all-ReLU shared
top MLP (:304), then ``num_multi_tasks`` independent task heads over
``mlp_tasks`` (:306-316). The heads are called with ``sigmoid_layer =
len(ln_top) - 1`` (:311, :396), an index into the heads' own layers; the
port keeps that index semantics exactly. The heads are stacked and run as
one batched product a layer (``stacked_mlp_apply``).
"""

from __future__ import annotations

import torch

from deeprecsys_tpu_torch.config import ModelConfig
from deeprecsys_tpu_torch.models.base import (
    Batch, compute_dtype_of, init_tables, param_dtype_of, pooled_lookup,
    stacked_mlp_apply, stacked_mlp_init)
from deeprecsys_tpu_torch.ops import cat_interaction, mlp_apply, mlp_init


def init(generator: torch.Generator, cfg: ModelConfig,
         device: torch.device | str) -> dict:
    if len(cfg.mlp_bot) != 1:
        raise ValueError("MT-WnD takes raw dense features; mlp_bot must be a single width")
    if cfg.ln_top[-1] != cfg.mlp_tasks[0]:
        raise ValueError("shared top-MLP output dim must equal task-head input dim "
                         "(reference check multi_task_wnd.py:362)")
    pdt = param_dtype_of(cfg)
    return {
        "tables": init_tables(cfg, generator, device),
        "top": mlp_init(cfg.ln_top, pdt, generator, device),
        "tasks": stacked_mlp_init(cfg.num_multi_tasks, cfg.mlp_tasks, pdt,
                                  generator, device),
    }


def apply_from_pooled(params: dict, pooled: torch.Tensor, batch: Batch,
                      cfg: ModelConfig) -> torch.Tensor:
    z = cat_interaction(batch.dense.to(compute_dtype_of(cfg)), pooled)
    shared = mlp_apply(params["top"], z)  # all-ReLU shared trunk
    B = shared.shape[0]
    x = shared[:, None, :].expand(B, cfg.num_multi_tasks, shared.shape[1])
    heads = stacked_mlp_apply(params["tasks"], x, sigmoid_layer=len(cfg.ln_top) - 1)
    return heads.reshape(B, -1)  # (B, num_tasks * task_out)


def apply(params: dict, batch: Batch, cfg: ModelConfig,
          offsets: torch.Tensor | None = None) -> torch.Tensor:
    pooled = pooled_lookup(params["tables"], batch, cfg, offsets=offsets)
    return apply_from_pooled(params, pooled, batch, cfg)
