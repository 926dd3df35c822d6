"""Parameter initializers with torch-default parity (counterpart of
mfvi_dip_mia_tpu/nn/init.py): conv weight and bias ~ U(-1/sqrt(fan_in),
1/sqrt(fan_in)); variational mu/rho ~ Normal draws. Kernels are OIHW."""

from __future__ import annotations

import math

import torch


def conv_kernel_torch_default(generator: torch.Generator, kh: int, kw: int,
                              c_in: int, c_out: int) -> torch.Tensor:
    """(c_out, c_in, kh, kw) kernel ~ U(-b, b), b = 1/sqrt(c_in*kh*kw)."""
    bound = 1.0 / math.sqrt(c_in * kh * kw)
    u = torch.rand((c_out, c_in, kh, kw), generator=generator)
    return u * (2 * bound) - bound


def conv_bias_torch_default(generator: torch.Generator, c_out: int,
                            fan_in: int) -> torch.Tensor:
    bound = 1.0 / math.sqrt(fan_in)
    return torch.rand((c_out,), generator=generator) * (2 * bound) - bound


def normal(generator: torch.Generator, shape, mean: float,
           std: float) -> torch.Tensor:
    return mean + std * torch.randn(tuple(shape), generator=generator)
