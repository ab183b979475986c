"""Model registry (counterpart of ``deeprecsys_tpu/models/__init__.py``).

``get_model(cfg, device)`` returns the (init, apply) pair for a config's
``model_type``, closed over the config, the device and the table offsets
on that device. Only DLRM is ported; the other families raise and name
their ROADMAP.md item.
"""

from __future__ import annotations

import functools

import torch

from deeprecsys_tpu.config import ModelConfig
from deeprecsys_tpu_torch.models import dlrm
from deeprecsys_tpu_torch.models.base import Batch, ModelFns, table_offsets

_NOT_PORTED = {
    "wnd": "Queue 1 item 4",
    "mtwnd": "Queue 1 item 4",
    "ncf": "Queue 1 item 4",
    "din": "Queue 1 item 5",
    "dien": "Queue 1 item 6",
}


def get_model(cfg: ModelConfig, device: torch.device | str) -> ModelFns:
    if cfg.model_type != "dlrm":
        raise NotImplementedError(
            f"model_type {cfg.model_type!r} is not ported yet "
            f"(ROADMAP.md {_NOT_PORTED.get(cfg.model_type, 'Queue 1')})")
    device = torch.device(device)
    offsets = table_offsets(cfg, device)
    return ModelFns(
        name=cfg.model_name,
        init=functools.partial(dlrm.init, cfg=cfg, device=device),
        apply=functools.partial(dlrm.apply, cfg=cfg, offsets=offsets),
        cfg=cfg,
        apply_from_pooled=functools.partial(dlrm.apply_from_pooled, cfg=cfg),
    )


__all__ = ["get_model", "Batch", "ModelFns"]
