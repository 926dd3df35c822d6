"""Reconstruction losses (counterpart of mfvi_dip_mia_tpu/ops/losses.py).

The network's second output channel is the *negative* log variance, so
    loss = exp(neg_logvar) * (target - mu)^2 - neg_logvar
with neg_logvar clamped to [-20, 20]."""

from __future__ import annotations

import torch


def gaussian_nll(mu: torch.Tensor, neg_logvar: torch.Tensor,
                 target: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    neg_logvar = torch.clamp(neg_logvar, -20.0, 20.0)
    loss = torch.exp(neg_logvar) * (target - mu) ** 2 - neg_logvar
    return loss.mean() if reduction == "mean" else loss.sum()


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)
