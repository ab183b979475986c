"""Deep Interest Network; counterpart of ``deeprecsys_tpu/models/din.py``.

Reference: ``models/din.py``. Table 0 is the user profile, tables 1..T-3
the behaviour history (one table a history slot), T-2 the candidate ad,
T-1 the context. Each behaviour table has its own attention MLP
``[3m] + mlp_bot + [m]`` over ``concat(behaviour, ad, behaviour + ad)``
(:246-285), and their outputs are summed. The top MLP takes
``concat(profile, attention, ad, context)``, 4m wide, and ends in a ReLU,
or its pre-activation under ``output_head="logits"``.

The ~251 attention MLPs are stacked and run as one batched product a
layer (``stacked_mlp_apply``), as in the JAX package.
"""

from __future__ import annotations

import torch

from deeprecsys_tpu_torch.config import ModelConfig
from deeprecsys_tpu_torch.models.base import (
    Batch, init_tables, param_dtype_of, pooled_lookup, stacked_mlp_apply,
    stacked_mlp_init)
from deeprecsys_tpu_torch.ops import mlp_apply, mlp_init


def _attention_dims(cfg: ModelConfig) -> tuple[int, ...]:
    m = cfg.sparse_feature_size
    return (3 * m,) + cfg.mlp_bot + (m,)


def init(generator: torch.Generator, cfg: ModelConfig,
         device: torch.device | str) -> dict:
    pdt = param_dtype_of(cfg)
    num_behavior = len(cfg.behavior_table_ids)
    return {
        "tables": init_tables(cfg, generator, device),
        # The attention outputs are summed, so the last layer is scaled by
        # 1/sqrt(num_behavior) (JAX models/din.py:49-52).
        "attention": stacked_mlp_init(num_behavior, _attention_dims(cfg), pdt,
                                      generator, device, sum_fanin=num_behavior),
        "top": mlp_init(cfg.ln_top, pdt, generator, device),  # (4m,) + mlp_top
    }


def apply_from_pooled(params: dict, emb: torch.Tensor, batch: Batch,
                      cfg: ModelConfig) -> torch.Tensor:
    T = cfg.num_tables
    profile, ad, ctx = emb[:, 0, :], emb[:, T - 2, :], emb[:, T - 1, :]
    behavior = emb[:, 1:T - 2, :]  # (B, T_b, m)
    ad_b = ad[:, None, :].expand_as(behavior)
    att_in = torch.cat([behavior, ad_b, behavior + ad_b], dim=-1)  # (B, T_b, 3m)
    att_out = stacked_mlp_apply(params["attention"], att_in)  # all-ReLU
    # JAX's sum of a bf16 array accumulates in f32 and rounds once.
    attention = att_out.float().sum(dim=1).to(att_out.dtype)
    z = torch.cat([profile, attention, ad, ctx], dim=1)  # (B, 4m)
    return mlp_apply(params["top"], z, final_relu=cfg.output_head != "logits")


def apply(params: dict, batch: Batch, cfg: ModelConfig,
          offsets: torch.Tensor | None = None) -> torch.Tensor:
    pooled = pooled_lookup(params["tables"], batch, cfg, offsets=offsets)
    return apply_from_pooled(params, pooled, batch, cfg)
