"""Gradient transformations over the port's parameter dict (name -> tensor),
the counterpart of the optax transformations the JAX package's library
code takes: ``init(params) -> state``, ``update(grads, state, params) ->
(updates, state)``, and ``apply_updates`` adds the updates. Plain torch,
elementwise per leaf, as optax runs them outside any Pallas kernel."""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .fused_adamw import adamw_update


class Transform(NamedTuple):
    init: Callable
    update: Callable


def apply_updates(params: dict, updates: dict) -> dict:
    """params + updates, leaf by leaf (optax.apply_updates)."""
    return {n: p + updates[n].to(p.dtype) for n, p in params.items()}


def adamw(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> Transform:
    """optax.adamw with optax's defaults, weight decay 1e-4 included
    (torch.optim.AdamW's default is 1e-2), leaf by leaf with the flat
    AdamW's formulas (optim/fused_adamw.py::adamw_update); the state is
    {"count" (an int32 device tensor), "mu", "nu" (dicts)}."""

    def init(params: dict) -> dict:
        first = next(iter(params.values()))
        return {"count": torch.zeros((), dtype=torch.int32,
                                     device=first.device),
                "mu": {n: torch.zeros_like(p) for n, p in params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in params.items()}}

    def update(grads: dict, state: dict, params: dict):
        count = state["count"] + 1
        mu, nu, upd = {}, {}, {}
        for n, g in grads.items():
            upd[n], mu[n], nu[n] = adamw_update(
                params[n], g, state["mu"][n], state["nu"][n], count, lr=lr,
                weight_decay=weight_decay, b1=b1, b2=b2, eps=eps)
        return upd, {"count": count, "mu": mu, "nu": nu}

    return Transform(init, update)
