"""Deep Interest Evolution Network; counterpart of ``deeprecsys_tpu/models/dien.py``.

Reference: ``models/dien.py``. The table roles are DIN's. The behaviour
embeddings, time-major ``(T_b, B, m)`` (time step t is behaviour table t),
go through BasicRNN 0; a per-step FC, a softmax over H and a sum with the
RNN's output form a gate (:346-356); BasicRNN 1 runs over the gated
sequence and keeps its last state. The top MLP takes
``concat(last, profile, ad, context)``, H + 3m wide, and ends in a ReLU, or
its pre-activation under ``output_head="logits"``.

Both scans run through ``ops/rnn.py::basic_rnn_scan``: kernel K3 on the
card, one launch a scan. Optional ``seq_lengths`` and ``initial_h`` give
the reference's ragged histories: each row's state freezes at its own
length, so a padded batch scores each row as an unpadded run.
"""

from __future__ import annotations

import torch

from deeprecsys_tpu_torch.config import ModelConfig
from deeprecsys_tpu_torch.models.base import (
    Batch, init_tables, param_dtype_of, pooled_lookup)
from deeprecsys_tpu_torch.ops import basic_rnn_init, basic_rnn_scan, mlp_apply, mlp_init


def init(generator: torch.Generator, cfg: ModelConfig,
         device: torch.device | str) -> dict:
    pdt = param_dtype_of(cfg)
    m, H = cfg.sparse_feature_size, cfg.hidden_size
    return {
        "tables": init_tables(cfg, generator, device),
        "rnn0": basic_rnn_init(m, H, pdt, generator, device),
        "gate_fc": mlp_init((H, H), pdt, generator, device)[0],
        "rnn1": basic_rnn_init(H, H, pdt, generator, device),
        "top": mlp_init(cfg.ln_top, pdt, generator, device),  # (H + 3m,) + mlp_top
    }


def apply_from_pooled(params: dict, emb: torch.Tensor, batch: Batch, cfg: ModelConfig,
                      seq_lengths: torch.Tensor | None = None,
                      initial_h: torch.Tensor | None = None) -> torch.Tensor:
    T = cfg.num_tables
    profile, ad, ctx = emb[:, 0, :], emb[:, T - 2, :], emb[:, T - 1, :]
    seq = emb[:, 1:T - 2, :].transpose(0, 1)  # time-major (T_b, B, m)
    out0, _ = basic_rnn_scan(params["rnn0"], seq, h0=initial_h, seq_lengths=seq_lengths)
    # The gate's FC, bias and softmax in f32, then one cast to the compute
    # dtype (JAX models/dien.py:64-71).
    gate = out0.float() @ params["gate_fc"]["w"].float() + params["gate_fc"]["b"].float()
    gated = out0 + torch.softmax(gate, dim=2).to(out0.dtype)
    _, last = basic_rnn_scan(params["rnn1"], gated, h0=initial_h, seq_lengths=seq_lengths)
    z = torch.cat([last, profile, ad, ctx], dim=1)  # (B, H + 3m)
    return mlp_apply(params["top"], z, final_relu=cfg.output_head != "logits")


def apply(params: dict, batch: Batch, cfg: ModelConfig,
          offsets: torch.Tensor | None = None,
          seq_lengths: torch.Tensor | None = None,
          initial_h: torch.Tensor | None = None) -> torch.Tensor:
    pooled = pooled_lookup(params["tables"], batch, cfg, offsets=offsets)
    return apply_from_pooled(params, pooled, batch, cfg,
                             seq_lengths=seq_lengths, initial_h=initial_h)
