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
def _tril_pairs(num_fea: int, include_diag: bool) -> tuple[np.ndarray, np.ndarray]:
    """The reference's lower-triangle pairs (i, j), row by row, j < i (j <= i
    with the diagonal)."""
    ii, jj = np.tril_indices(num_fea, 0 if include_diag else -1)
    return ii.astype(np.int64), jj.astype(np.int64)


def dot_interaction(dense_out: torch.Tensor, emb_out: torch.Tensor, *,
                    self_interaction: bool = False) -> torch.Tensor:
    """DLRM "dot": ``(B, d)`` dense and ``(B, T, d)`` pooled features ->
    ``(B, d + P)``, the dense features followed by the P pairwise dot
    products of the lower triangle. The products accumulate in f32 and are
    rounded once to the features' dtype (JAX ``ops/interactions.py:41-56``)."""
    feats = torch.cat([dense_out[:, None, :], emb_out], dim=1)  # (B, F, d)
    f32 = feats.float()
    z = torch.bmm(f32, f32.transpose(1, 2)).to(feats.dtype)
    ii, jj = _tril_pairs(feats.shape[1], self_interaction)
    return torch.cat([dense_out, z[:, ii, jj]], dim=1)


def cat_interaction(dense_out: torch.Tensor | None, emb_out: torch.Tensor) -> torch.Tensor:
    """"cat" interaction: flatten pooled embeddings, prepend dense features."""
    flat = emb_out.reshape(emb_out.shape[0], -1)
    if dense_out is None:
        return flat
    return torch.cat([dense_out, flat], dim=1)
