"""Common model substrate (counterpart of ``deeprecsys_tpu/models/base.py``).

A model is a pair of functions over one batch layout:

    init(generator)       -> params (dict of tensors, the JAX pytree's shape)
    apply(params, batch)  -> scores (B, out_dim)
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from deeprecsys_tpu_torch.config import ModelConfig

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


def stacked_mlp_init(num: int, dims, dtype: torch.dtype, generator: torch.Generator,
                     device: torch.device | str, sum_fanin: int = 1) -> list[dict]:
    """``num`` independent same-shape MLPs as stacked ``(num, n, m)`` weights
    and ``(num, m)`` biases, with ``mlp_init``'s distributions. ``sum_fanin``
    > 1 (the caller sums the ``num`` outputs, as DIN does) divides the last
    layer's weights and biases by sqrt(sum_fanin) (JAX ``models/base.py:54-86``)."""
    params = []
    for i, (n, m) in enumerate(zip(dims[:-1], dims[1:]), start=1):
        w = torch.randn((num, n, m), generator=generator, device=device) * math.sqrt(2.0 / (m + n))
        b = torch.randn((num, m), generator=generator, device=device) * math.sqrt(1.0 / m)
        if sum_fanin > 1 and i == len(dims) - 1:
            w, b = w / math.sqrt(sum_fanin), b / math.sqrt(sum_fanin)
        params.append({"w": w.to(dtype), "b": b.to(dtype)})
    return params


def stacked_mlp_apply(params, x: torch.Tensor, sigmoid_layer: int = -1) -> torch.Tensor:
    """Stacked MLPs: ``x (B, num, n) -> (B, num, out)``, MLP t on ``x[:, t]``.

    Each layer is one batched product over the ``num`` axis, with
    ``mlp_apply``'s numerics: f32 accumulation, f32 bias and activation, a
    cast to the input dtype at each layer. ``sigmoid_layer`` is 1-based;
    every other layer is a ReLU.
    """
    out_dtype = x.dtype
    for i, layer in enumerate(params, start=1):
        y = torch.einsum("btn,tnm->btm", x.float(), layer["w"].float())
        y = y + layer["b"].float()[None, :, :]
        y = torch.sigmoid(y) if i == sigmoid_layer else torch.relu(y)
        x = y.to(out_dtype)
    return x


def table_offsets(cfg: ModelConfig, device: torch.device | str) -> torch.Tensor:
    """``cfg.table_offsets`` as an int32 tensor on ``device``."""
    return torch.as_tensor(cfg.table_offsets, dtype=torch.int32).to(device)


def init_tables(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device | str):
    """The fused table per the config's quantization (JAX
    ``models/base.py:104-125``), always unpacked: a ``(total_rows, d)``
    tensor, ``{"q", "scale"}`` (int8) or ``{"qrows"}`` (int8_rowwise)."""
    from deeprecsys_tpu_torch.ops import (
        init_fused_tables, init_fused_tables_int8, init_fused_tables_int8_rowwise)

    rows, d = cfg.scaled_rows, cfg.sparse_feature_size
    if cfg.table_quant == "int8":
        return init_fused_tables_int8(rows, d, generator, device)
    if cfg.table_quant == "int8_rowwise":
        return {"qrows": init_fused_tables_int8_rowwise(rows, d, generator, device)}
    if cfg.table_quant != "none":
        raise ValueError(f"unknown table_quant {cfg.table_quant!r}")
    return init_fused_tables(rows, d, param_dtype_of(cfg), generator, device)


def pooled_lookup(tables, batch: Batch, cfg: ModelConfig,
                  offsets: torch.Tensor | None = None) -> torch.Tensor:
    """The model-facing fused pooled lookup: (B, T, d) in the compute dtype,
    dispatching on the table's layout as JAX ``models/base.py:163-184``
    does: a tensor goes to ``embedding_bag`` (K1), ``{"q", "scale"}`` to
    ``embedding_bag_int8`` (K1-int8), ``{"qrows"}`` to
    ``embedding_bag_int8_rowwise`` (K4).

    ``offsets`` may be passed precomputed on the table's device (the
    models do, so a forward makes no host-to-device copy for them).
    """
    from deeprecsys_tpu_torch.ops import (
        embedding_bag, embedding_bag_int8, embedding_bag_int8_rowwise)

    if cfg.embedding_impl == "hotcold":
        # The split needs the host splitter in the loop (models/hotcold.py);
        # falling through to the direct lookup would measure the wrong path
        # (JAX models/base.py:138-145).
        raise ValueError(
            "embedding_impl='hotcold' is a serving-engine path (use --queue/"
            "--serve, or models.hotcold.make_hotcold_model directly); the "
            "plain apply would silently run the xla gather instead")
    # "auto" is decided by a serving engine at warm-up; elsewhere the direct
    # lookup is the right one, as in the JAX package.
    if cfg.embedding_impl not in ("xla", "auto"):
        raise ValueError(f"unknown embedding_impl {cfg.embedding_impl!r} "
                         "(valid: 'xla', 'hotcold', 'auto')")
    cdt, indices, mask = compute_dtype_of(cfg), batch.indices, batch.mask
    if offsets is None:
        offsets = table_offsets(cfg, indices.device)
    if not isinstance(tables, dict):
        return embedding_bag(tables, offsets, indices, compute_dtype=cdt, mask=mask)
    if set(tables) == {"q", "scale"}:
        return embedding_bag_int8(tables["q"], tables["scale"], offsets, indices,
                                  compute_dtype=cdt, mask=mask)
    if set(tables) == {"qrows"}:
        return embedding_bag_int8_rowwise(tables["qrows"], offsets, indices,
                                          compute_dtype=cdt, mask=mask)
    raise ValueError(f"unknown table layout {sorted(tables)} (the port takes a tensor, "
                     "{'q', 'scale'} or {'qrows'}; bridge.params_from_numpy unpacks "
                     "the JAX package's packed layouts)")
