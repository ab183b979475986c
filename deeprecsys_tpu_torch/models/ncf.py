"""Neural Collaborative Filtering; counterpart of ``deeprecsys_tpu/models/ncf.py``.

Reference: ``models/ncf.py`` — 4 tables, 1 id each. Tables 0 and 1 feed
the MF branch, an elementwise sum (``create_mf_interaction``); tables 2
and 3 are concatenated and fed an all-ReLU MLP over ``ln_top[:-1]``. The
two branches are concatenated into a final FC with a ReLU (no sigmoid), or
its pre-activation under ``output_head="logits"``. No dense input.
"""

from __future__ import annotations

import torch

from deeprecsys_tpu_torch.config import ModelConfig
from deeprecsys_tpu_torch.models.base import (
    Batch, init_tables, param_dtype_of, pooled_lookup)
from deeprecsys_tpu_torch.ops import mlp_apply, mlp_init


def init(generator: torch.Generator, cfg: ModelConfig,
         device: torch.device | str) -> dict:
    pdt = param_dtype_of(cfg)
    m, ln_top = cfg.sparse_feature_size, cfg.ln_top  # (2m,) + mlp_top
    return {
        "tables": init_tables(cfg, generator, device),
        "mlp": mlp_init(ln_top[:-1], pdt, generator, device),
        "final": mlp_init((m + ln_top[-2], ln_top[-1]), pdt, generator, device),
    }


def apply_from_pooled(params: dict, emb: torch.Tensor, batch: Batch,
                      cfg: ModelConfig) -> torch.Tensor:
    zmf = emb[:, 0, :] + emb[:, 1, :]
    zmlp = torch.cat([emb[:, 2, :], emb[:, 3, :]], dim=1)
    r = torch.cat([zmf, mlp_apply(params["mlp"], zmlp)], dim=1)
    return mlp_apply(params["final"], r, final_relu=cfg.output_head != "logits")


def apply(params: dict, batch: Batch, cfg: ModelConfig,
          offsets: torch.Tensor | None = None) -> torch.Tensor:
    pooled = pooled_lookup(params["tables"], batch, cfg, offsets=offsets)
    return apply_from_pooled(params, pooled, batch, cfg)
