"""Training losses (counterpart of ``deeprecsys_tpu/parallel/sharding.py:427-462``).

They live here so that a reader finds them at the JAX path. The JAX
module's sharded helpers are ROADMAP.md Queue 1 item 12 (multi-device) and
come with it. All the math is f32, whatever the score dtype.
"""

from __future__ import annotations

import torch


def bce_loss(scores: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on sigmoid scores, clipped to [1e-7, 1 - 1e-7];
    a score outside the clip gets no gradient (the clip's VJP)."""
    eps = 1e-7
    s = torch.clamp(scores.float(), eps, 1.0 - eps)
    t = targets.float()
    return -torch.mean(t * torch.log(s) + (1.0 - t) * torch.log(1.0 - s))


def bce_logits_loss(scores: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on raw logits, in the stable form
    max(s, 0) - s t + log1p(exp(-|s|)), for the families whose graphs end
    without a sigmoid (ncf, din, dien)."""
    s = scores.float()
    t = targets.float()
    return torch.mean(torch.clamp_min(s, 0.0) - s * t + torch.log1p(torch.exp(-torch.abs(s))))


def mse_loss(scores: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.mean((scores.float() - targets.float()) ** 2)


def loss_fn_for(loss: str, sigmoid_output: bool):
    """"bce" in probability space for sigmoid-headed models (dlrm, wnd,
    mtwnd) and in logit space otherwise (ncf, din, dien); or "mse"."""
    if loss == "mse":
        return mse_loss
    if loss == "bce":
        return bce_loss if sigmoid_output else bce_logits_loss
    raise ValueError(f"unknown loss {loss!r} (use 'bce' or 'mse')")
