"""Weights across the two packages.

``params_from_numpy`` maps a JAX params pytree, held as numpy arrays
(``jax.device_get(params)``), to the port's tensors; ``params_to_numpy``
maps them back. The layout is the same on both sides (dicts, lists of
``{"w", "b"}`` with ``w`` as ``(in, out)``) except for the fused table: the
JAX package may store it packed, ``{"packed": (ceil(R/p), p*d)}`` (bf16
d=32 resolves to p=2, ``config.py:193-214``); the port keeps ``(R, d)``.
Quantized tables (``q``, ``q_packed``, ``qrows``) are not ported yet.

bfloat16 arrays on the numpy side are ``ml_dtypes.bfloat16``; they cross
by their 16-bit patterns, so no value changes.
"""

from __future__ import annotations

import numpy as np
import torch

from deeprecsys_tpu.config import ModelConfig
from deeprecsys_tpu_torch.ops.embedding import unpack_table

_QUANTIZED_KEYS = ("q", "q_packed", "qrows")


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: device_get arrays are read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def unflatten(arrays) -> dict:
    """The params pytree from flat ``"tower/<i>/<k>"`` keys (the layout of
    ``tests/golden/torch_port_rm1.npz``); other keys are left out."""
    params: dict = {}
    for key in arrays:
        parts = key.split("/")
        if key == "tables":
            params["tables"] = arrays[key]
        elif len(parts) == 3:
            tower, i, k = parts
            layers = params.setdefault(tower, [])
            while len(layers) <= int(i):
                layers.append({})
            layers[int(i)][k] = arrays[key]
    return params


def params_from_numpy(np_params: dict, cfg: ModelConfig,
                      device: torch.device | str) -> dict:
    """The port's params for a JAX params pytree of numpy arrays."""
    params = {k: _map(v, lambda a: _to_tensor(a, device))
              for k, v in np_params.items() if k != "tables"}
    tables = np_params["tables"]
    if isinstance(tables, dict):
        if any(k in tables for k in _QUANTIZED_KEYS):
            raise NotImplementedError(
                f"quantized tables ({sorted(tables)}) are not ported yet "
                "(ROADMAP.md Queue 1 item 8)")
        packed = tables["packed"]
        pack = packed.shape[1] // cfg.sparse_feature_size
        # unpack_table's slice of a contiguous tensor is contiguous.
        params["tables"] = unpack_table(_to_tensor(packed, device), pack, cfg.total_rows)
    else:
        params["tables"] = _to_tensor(tables, device)
    return params


def params_to_numpy(params: dict, cfg: ModelConfig) -> dict:
    """The JAX params pytree (numpy arrays) for the port's params, with the
    table in the layout the JAX package resolves for ``cfg``."""
    out = {k: _map(v, _to_numpy) for k, v in params.items() if k != "tables"}
    table = _to_numpy(params["tables"])
    pack = cfg.resolved_table_pack
    if pack > 1:
        rows, d = table.shape
        pad = -rows % pack
        table = np.concatenate([table, np.zeros((pad, d), table.dtype)])
        out["tables"] = {"packed": table.reshape(-1, pack * d)}
    else:
        out["tables"] = table
    return out
