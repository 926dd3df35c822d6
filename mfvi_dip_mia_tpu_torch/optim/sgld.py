"""The paper's "as-used" SGLD (counterpart of the add_param_noise :108 and
exponential_decay_floored :159 of mfvi_dip_mia_tpu/optim/sgld.py): AdamW
plus Gaussian parameter noise sigma * lr on every conv kernel before each
forward, with ExponentialLR(gamma) stopped at the 1e-8 floor.

On the flat parameter buffer (bayes/vi.py::FlatParams) the conv kernels are
a fixed set of positions, ``kernel_index``, built once before a fit's step
is captured. The noise is one draw from the fit's generator through
``param_noise_eps`` (so a caller can hold it to a fixed table), added at
those positions in one pass. The library optimizers ``sgld`` / ``psgld`` /
``param_noise_transform`` (sgld.py:35, :60-100, :123) are not ported yet
(ROADMAP Queue 1 item 8). Plain torch, as in JAX, where this runs outside
any Pallas kernel.
"""

from __future__ import annotations

import math

import torch

from ..bayes.vi import FlatParams

LR_FLOOR = 1e-8


def kernel_index(params: FlatParams) -> torch.Tensor:
    """The positions of every rank-4 leaf (conv kernel) in ``params.flat``,
    in buffer order (int64, unique, on the buffer's device): the leaves
    JAX's add_param_noise perturbs (it filters ``ndim == 4``)."""
    spans = [torch.arange(o, o + math.prod(s))
             for s, o in zip(params.shapes, params.offsets) if len(s) == 4]
    idx = torch.cat(spans) if spans else torch.zeros(0, dtype=torch.int64)
    return idx.to(params.flat.device)


def param_noise_eps(n: int, generator: torch.Generator) -> torch.Tensor:
    """The standard-normal draw of one step's parameter noise (n f32 values
    on the generator's device). Every draw goes through here, so a caller
    can hold it to a fixed table."""
    return torch.randn((n,), generator=generator, device=generator.device)


def add_param_noise(flat: torch.Tensor, index: torch.Tensor,
                    generator: torch.Generator, sigma: float,
                    lr: float) -> None:
    """``flat[index] += N(0, 1) * sigma * lr`` in place (sgld.py:108). The
    indices are unique, so the add touches each position once and its result
    does not depend on the order of the adds."""
    eps = param_noise_eps(index.numel(), generator)
    flat.index_add_(0, index, eps * sigma * lr)


class DecayedLR:
    """ExponentialLR(gamma) with the reference's stop-at-floor rule, as the
    JAX trainer's ``_sgld_lr`` (trainer.py:135) computes it: n_stop =
    ceil(log(floor / lr) / log(gamma)) in float32 (infinite for
    gamma >= 1, at least 0), then lr * gamma^min(it, n_stop) in float32.
    The constants are made on the host once, before any capture; ``at(it)``
    reads the iteration from a device tensor, so a CUDA graph replay takes
    the rate of the iteration it runs, not the one it was captured at."""

    def __init__(self, lr: float, gamma: float, device,
                 floor: float = LR_FLOOR):
        lr_t = torch.tensor(lr, dtype=torch.float32)
        gamma_t = torch.tensor(gamma, dtype=torch.float32)
        n_stop = torch.ceil(torch.log(torch.tensor(floor, dtype=torch.float32)
                                      / lr_t) / torch.log(gamma_t))
        n_stop = torch.where(gamma_t >= 1.0, torch.tensor(math.inf),
                             torch.clamp(n_stop, min=0.0))
        self.lr, self.gamma, self.n_stop = (
            t.to(device) for t in (lr_t, gamma_t, n_stop))

    def at(self, it: torch.Tensor) -> torch.Tensor:
        expo = torch.minimum(it.to(torch.float32), self.n_stop)
        return self.lr * torch.pow(self.gamma, expo)


def exponential_decay_floored(init_lr: float, gamma: float,
                              floor: float = LR_FLOOR):
    """ExponentialLR(gamma) that stops decaying at the first value at or
    below ``floor`` and holds it (sgld.py:159; n_stop in float64, as
    there): ``schedule(count)`` -> float32 tensor."""
    if gamma >= 1.0 or init_lr <= floor:
        n_stop = 0.0 if init_lr <= floor else math.inf
    else:
        n_stop = float(math.ceil(math.log(floor / init_lr) / math.log(gamma)))

    def schedule(count) -> torch.Tensor:
        expo = torch.clamp(torch.as_tensor(count, dtype=torch.float32),
                           max=n_stop)
        return init_lr * torch.pow(torch.tensor(gamma, dtype=torch.float32),
                                   expo)

    return schedule
