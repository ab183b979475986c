"""Feature interactions.

Counterpart of ``deeprecsys_tpu/ops/interactions.py:52-58``. Only "cat" is
ported: every zoo config uses it. ``dot_interaction`` is kernel K8 in
ROADMAP.md Queue 2.
"""

from __future__ import annotations

import torch


def cat_interaction(dense_out: torch.Tensor | None, emb_out: torch.Tensor) -> torch.Tensor:
    """"cat" interaction: flatten pooled embeddings, prepend dense features."""
    flat = emb_out.reshape(emb_out.shape[0], -1)
    if dense_out is None:
        return flat
    return torch.cat([dense_out, flat], dim=1)
