"""SGLD-family optimizers (counterpart of mfvi_dip_mia_tpu/optim/sgld.py).

The library optimizers, as gradient transformations over the port's
parameter dict (optim/transform.py), each with an ``init(params)`` whose
state holds its own ``torch.Generator`` (seeded by ``seed``, on the
parameters' device) and an ``update(grads, state, params)``:

  * ``sgld`` (sgld.py:35): update = -lr * 0.5 * (g + wd * p) + lr * N(0, 1).
    The Langevin noise is scaled by lr, not sqrt(lr), as the reference
    scales it; ``addnoise=False`` returns -lr * (g + wd * p), without the
    one half.
  * ``psgld`` (sgld.py:68): RMSProp-preconditioned SGLD, V <- V + (1 - a)
    (g^2 - V) from V = 1, P = 1 / sqrt(V + eps), update = -lr * (0.5 P g
    N_batches + N(0, 1) sigma sqrt(P)), sigma = 1 / sqrt(lr) once the count
    passes ``num_burn_in_steps``, else 0 (the noise is drawn all the same).
  * ``param_noise_transform`` (sgld.py:124): update += N(0, 1) * sigma *
    lr_schedule(count) on the rank-4 leaves (conv kernels) only.

The paper's "as-used" SGLD (add_param_noise :108, exponential_decay_floored
:159) is AdamW plus Gaussian parameter noise sigma * lr on every conv kernel
before each forward, with ExponentialLR(gamma) stopped at the 1e-8 floor.
On the flat parameter buffer (bayes/vi.py::FlatParams) the conv kernels are
a fixed set of positions, ``kernel_index``, built once before a fit's step
is captured. The noise is one draw from the fit's generator through
``param_noise_eps`` (so a caller can hold it to a fixed table), added at
those positions in one pass. Plain torch, as in JAX, where this runs outside
any Pallas kernel.
"""

from __future__ import annotations

import math

import torch

from ..bayes.vi import FlatParams
from .transform import Transform

LR_FLOOR = 1e-8


# -- the library optimizers -----------------------------------------------------

def _generator_for(params: dict, seed: int) -> torch.Generator:
    device = next(iter(params.values())).device
    return torch.Generator(device=device).manual_seed(seed)


def _normal(g: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(g.shape, generator=generator, device=g.device,
                       dtype=g.dtype)


def sgld(lr: float, weight_decay: float = 0.0, addnoise: bool = True,
         seed: int = 0) -> Transform:
    """Library SGLD; the state is {"generator"}."""

    def init(params: dict) -> dict:
        return {"generator": _generator_for(params, seed)}

    def update(grads: dict, state: dict, params: dict | None = None):
        if weight_decay != 0.0:
            if params is None:
                raise ValueError("weight_decay needs params")
            grads = {n: g + weight_decay * params[n]
                     for n, g in grads.items()}
        if not addnoise:
            return {n: -lr * g for n, g in grads.items()}, state
        gen = state["generator"]
        return {n: -lr * 0.5 * g + lr * _normal(g, gen)
                for n, g in grads.items()}, state

    return Transform(init, update)


def psgld(lr: float = 1e-2, precondition_decay_rate: float = 0.95,
          num_pseudo_batches: int = 1, num_burn_in_steps: int = 3000,
          diagonal_bias: float = 1e-8, seed: int = 0) -> Transform:
    """pSGLD; the state is {"generator", "momentum" (a dict, ones at init),
    "count" (an int32 device tensor)}."""

    def init(params: dict) -> dict:
        first = next(iter(params.values()))
        return {"generator": _generator_for(params, seed),
                "momentum": {n: torch.ones_like(p)
                             for n, p in params.items()},
                "count": torch.zeros((), dtype=torch.int32,
                                     device=first.device)}

    def update(grads: dict, state: dict, params: dict | None = None):
        count = state["count"] + 1
        momentum = {n: v + (1.0 - precondition_decay_rate)
                    * (grads[n] * grads[n] - v)
                    for n, v in state["momentum"].items()}
        sigma = torch.where(
            count > num_burn_in_steps,
            1.0 / torch.sqrt(torch.tensor(lr, dtype=torch.float32,
                                          device=count.device)),
            torch.zeros((), device=count.device))
        gen = state["generator"]
        out = {}
        for n, g in grads.items():
            precond = 1.0 / torch.sqrt(momentum[n] + diagonal_bias)
            noise = _normal(g, gen)
            scaled = (0.5 * precond * g * num_pseudo_batches
                      + noise * sigma * torch.sqrt(precond))
            out[n] = -lr * scaled
        return out, {"generator": gen, "momentum": momentum, "count": count}

    return Transform(init, update)


def param_noise_transform(param_noise_sigma: float, lr_schedule,
                          seed: int = 0) -> Transform:
    """Adds N(0, 1) * param_noise_sigma * lr_schedule(count) to the update
    of every rank-4 leaf (conv kernel); the others pass unchanged. The
    state is {"generator", "count" (an int32 device tensor)}. The fits
    perturb the parameters before the forward instead (``add_param_noise``);
    this is for users composing transformations."""

    def init(params: dict) -> dict:
        first = next(iter(params.values()))
        return {"generator": _generator_for(params, seed),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=first.device)}

    def update(grads: dict, state: dict, params: dict | None = None):
        lr = lr_schedule(state["count"])
        gen = state["generator"]
        out = {n: (g + _normal(g, gen) * param_noise_sigma * lr
                   if g.dim() == 4 else g) for n, g in grads.items()}
        return out, {"generator": gen, "count": state["count"] + 1}

    return Transform(init, update)


# -- the paper's "as-used" SGLD ---------------------------------------------------


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
