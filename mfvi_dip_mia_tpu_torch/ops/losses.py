"""Reconstruction losses (counterpart of mfvi_dip_mia_tpu/ops/losses.py).

The network's second output channel is the *negative* log variance, so
    loss = exp(neg_logvar) * (target - mu)^2 - neg_logvar
with neg_logvar clamped to [-20, 20]. Besides: MSE, the total-variation
loss and BayTorch's (mu, logvar) NLLLoss2d."""

from __future__ import annotations

import torch


def gaussian_nll(mu: torch.Tensor, neg_logvar: torch.Tensor,
                 target: torch.Tensor, reduction: str = "mean") -> torch.Tensor:
    neg_logvar = torch.clamp(neg_logvar, -20.0, 20.0)
    loss = torch.exp(neg_logvar) * (target - mu) ** 2 - neg_logvar
    return loss.mean() if reduction == "mean" else loss.sum()


def gaussian_nll_masked(mu: torch.Tensor, neg_logvar: torch.Tensor,
                        target: torch.Tensor, mask: torch.Tensor,
                        reduction: str = "mean") -> torch.Tensor:
    """The inpainting NLL: gaussian_nll's terms times the mask; the mean is
    over all pixels, known or not, as the reference takes it."""
    neg_logvar = torch.clamp(neg_logvar, -20.0, 20.0)
    loss = (torch.exp(neg_logvar) * (target - mu) ** 2 - neg_logvar) * mask
    return loss.mean() if reduction == "mean" else loss.sum()


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2)


def tv_loss(x: torch.Tensor, beta: float = 0.5) -> torch.Tensor:
    """Total-variation loss of an NCHW ``x`` (losses.py:42): the sum over
    the pixels with both a lower and a right neighbour of (dh^2 + dw^2)^beta."""
    dh = (x[:, :, 1:, :] - x[:, :, :-1, :]) ** 2
    dw = (x[:, :, :, 1:] - x[:, :, :, :-1]) ** 2
    return torch.sum((dh[:, :, :, :-1] + dw[:, :, :-1, :]) ** beta)


def nll_loss_2d(out: torch.Tensor, target: torch.Tensor, eps: float = 1e-6,
                reduction: str = "mean") -> torch.Tensor:
    """BayTorch's NLLLoss2d (losses.py:50): ``out`` holds (mu, logvar)
    stacked on the channel axis (1 of NCHW); loss = 0.5 * (exp(-logvar) *
    (target - mu)^2 + logvar). ``eps`` is unused, as in JAX."""
    c = out.shape[1] // 2
    mu, logvar = out[:, :c], out[:, c:]
    loss = 0.5 * (torch.exp(-logvar) * (target - mu) ** 2 + logvar)
    return loss.mean() if reduction == "mean" else loss.sum()
