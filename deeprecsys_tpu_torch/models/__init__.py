"""Model registry (counterpart of ``deeprecsys_tpu/models/__init__.py``).

``get_model(cfg, device)`` returns the (init, apply) pair for a config's
``model_type``, closed over the config, the device and the table offsets
on that device.
"""

from __future__ import annotations

import functools

import torch

from deeprecsys_tpu_torch.config import ModelConfig
from deeprecsys_tpu_torch.models import dien, din, dlrm, multi_task_wnd, ncf, wide_and_deep
from deeprecsys_tpu_torch.models.base import Batch, ModelFns, table_offsets

_REGISTRY = {
    "dlrm": dlrm,
    "wnd": wide_and_deep,
    "mtwnd": multi_task_wnd,
    "ncf": ncf,
    "din": din,
    "dien": dien,
}


def get_model(cfg: ModelConfig, device: torch.device | str) -> ModelFns:
    mod = _REGISTRY[cfg.model_type]
    device = torch.device(device)
    return ModelFns(
        name=cfg.model_name,
        init=functools.partial(mod.init, cfg=cfg, device=device),
        apply=functools.partial(mod.apply, cfg=cfg, offsets=table_offsets(cfg, device)),
        cfg=cfg,
        apply_from_pooled=functools.partial(mod.apply_from_pooled, cfg=cfg),
    )


# Families whose reference graphs end in a sigmoid (scores are
# probabilities); ncf, din and dien end in FC + ReLU (JAX
# models/__init__.py:40-50).
_SIGMOID_OUTPUT_TYPES = frozenset({"dlrm", "wnd", "mtwnd"})


def sigmoid_output(cfg: ModelConfig) -> bool:
    """Whether this model's apply() returns sigmoid probabilities."""
    return cfg.model_type in _SIGMOID_OUTPUT_TYPES


__all__ = ["get_model", "Batch", "ModelFns", "sigmoid_output"]
