"""MC dropout as a network transform, and Gaussian dropout (counterpart of
mfvi_dip_mia_tpu/bayes/dropout.py): ``mc_dropout_apply`` puts always-on
dropout at the output of any apply function (in the skip U-Net MC dropout
is set when the net is built instead: nn/skip.py, the ``dropout_mode_*``
keywords); ``gaussian_dropout_conv`` / ``_dense`` are the multiplicative
Gaussian noise of BayTorch's GaussianDropout layers in moment-matched form,
out = mu + sqrt(p / (1 - p) * second) * eps, with mu = x * w and second =
x^2 * w^2.

For a batch-1 NCHW input the conv variant computes (mu, second) on the
port's LRT double-conv kernel (ops/kernels/lrt_conv.py::double_conv,
csrc/lrt_conv.cu) with (w, w^2), its backward on the conv kernels' dx and
dw. JAX computes it with the XLA double conv (``_fused_double_conv``,
ops/pallas/lrt_conv.py:30); the port takes its own kernel, as its LRT path
does. A batch above 1 takes F.conv2d, as nn/var_conv.py does, and the
dense variant is two matrix products, as JAX computes them outside Pallas.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..nn import layers
from ..ops.kernels import lrt_conv


def mc_dropout_apply(apply_fn, p: float = 0.5, mode: str = "2d"):
    """Wrap ``apply_fn(params, x, generator, **kw)`` with dropout of rate
    ``p`` on its NCHW output, drawn from the same generator after the
    forward ('2d': whole channels, else elements). Without a generator the
    output passes unchanged, as JAX's does without a key."""

    def wrapped(params, x, generator=None, **kwargs):
        out = apply_fn(params, x, generator, **kwargs)
        if generator is None:
            return out
        if mode == "2d":
            return layers.dropout2d(out, p, generator)
        return layers.dropout(out, p, generator)

    return wrapped


def gaussian_eps(shape, generator: torch.Generator) -> torch.Tensor:
    """The standard-normal noise of one Gaussian-dropout call (f32, on the
    generator's device). Every such draw goes through here, so a caller can
    hold it to a fixed table."""
    return torch.randn(tuple(shape), generator=generator,
                       device=generator.device)


def _noisy(mu: torch.Tensor, second: torch.Tensor, p: float,
           generator: torch.Generator) -> torch.Tensor:
    sigma = torch.sqrt(torch.clamp(p / (1.0 - p) * second, min=0.0))
    return mu + sigma * gaussian_eps(mu.shape, generator).to(mu.dtype)


def gaussian_dropout_conv(x: torch.Tensor, w: torch.Tensor, p: float,
                          generator: torch.Generator, stride: int = 1,
                          padding: int = 0, bias: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """Gaussian dropout of a conv layer (dropout.py:35): x (N, C, H, W), w
    (O, C, k, k), zero padding; out = conv(x, w) [+ bias] + sqrt(p/(1-p) *
    conv(x^2, w^2)) * eps."""
    if x.shape[0] == 1:
        xs = F.pad(x[0], (padding,) * 4) if padding else x[0]
        mu, second = lrt_conv.double_conv(xs, w, w * w, stride)
        mu, second = mu[None], second[None]
    else:
        mu = F.conv2d(x, w, stride=stride, padding=padding)
        second = F.conv2d(x * x, w * w, stride=stride, padding=padding)
    if bias is not None:
        mu = mu + bias[None, :, None, None].to(mu.dtype)
    return _noisy(mu, second, p, generator)


def gaussian_dropout_dense(x: torch.Tensor, w: torch.Tensor, p: float,
                           generator: torch.Generator) -> torch.Tensor:
    """The dense variant (dropout.py:48): x (N, in), w (in, out)."""
    return _noisy(x @ w, (x * x) @ (w * w), p, generator)
