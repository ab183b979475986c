"""Feature interactions.

Counterpart of ``deeprecsys_tpu/ops/interactions.py``. Every zoo config
uses "cat"; "dot" is the Criteo DLRM's (``data/criteo.py``). The pairwise
dot is one batched matrix product, which the JAX package leaves to XLA and
the port to ``torch.bmm``; a hand kernel for it is K8 in ROADMAP.md
Queue 2.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _tril_pairs(num_fea: int, include_diag: bool,
                device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's lower-triangle pairs (i, j), row by row, j < i (j <= i
    with the diagonal), as index tensors on ``device``: made once, so that a
    forward copies nothing from the host (a serving engine captures it as a
    CUDA graph). Made outside inference mode, so that a training step may
    save them for its backward."""
    ii, jj = np.tril_indices(num_fea, 0 if include_diag else -1)
    with torch.inference_mode(False):
        return (torch.from_numpy(ii.astype(np.int64)).to(device),
                torch.from_numpy(jj.astype(np.int64)).to(device))


def dot_interaction(dense_out: torch.Tensor, emb_out: torch.Tensor, *,
                    self_interaction: bool = False) -> torch.Tensor:
    """DLRM "dot": ``(B, d)`` dense and ``(B, T, d)`` pooled features ->
    ``(B, d + P)``, the dense features followed by the P pairwise dot
    products of the lower triangle. The products accumulate in f32 and are
    rounded once to the features' dtype (JAX ``ops/interactions.py:41-56``)."""
    feats = torch.cat([dense_out[:, None, :], emb_out], dim=1)  # (B, F, d)
    f32 = feats.float()
    z = torch.bmm(f32, f32.transpose(1, 2)).to(feats.dtype)
    ii, jj = _tril_pairs(feats.shape[1], self_interaction, feats.device)
    return torch.cat([dense_out, z[:, ii, jj]], dim=1)


def cat_interaction(dense_out: torch.Tensor | None, emb_out: torch.Tensor) -> torch.Tensor:
    """"cat" interaction: flatten pooled embeddings, prepend dense features."""
    flat = emb_out.reshape(emb_out.shape[0], -1)
    if dense_out is None:
        return flat
    return torch.cat([dense_out, flat], dim=1)
