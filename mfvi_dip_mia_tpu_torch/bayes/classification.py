"""Supervised Bayesian trainer and MC predictor (counterpart of
mfvi_dip_mia_tpu/bayes/classification.py; BayTorch's ClassificationTrainer
/ Predictor): an ELBO step, NLL + beta * KL with the KL warm-up schedules
of ``bayes.uncertainty.get_beta``, AdamW with optax's defaults, and
checkpoints of the parameters and the optimizer state in one npz.

Parameters are the port's flat-name dict (``l1.w_mu``, ``l1.w_rho``, ...;
conv kernels OIHW); the KL is ``vi.kl_mfvi`` over ``vi.flatten`` of them.
``apply_fn(params, x, generator, training=True)`` returns the logits; its
random draws (RT weights, dropout masks) come from the generator. The
DIP runners do not use this module; it is library capability, and runs on
the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..optim.transform import adamw, apply_updates
from ..utils.device import resolve_device
from . import vi
from .uncertainty import get_beta


@dataclasses.dataclass
class TrainLog:
    losses: list
    accuracies: list


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean negative log-softmax of each row's label."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def make_elbo_step(apply_fn: Callable, optimizer, prior_sigma: float,
                   n_batches: int, beta_type="Standard",
                   loss_fn: Callable = cross_entropy) -> Callable:
    """``step(params, opt_state, x, y, generator, batch_idx)`` -> (params,
    opt_state, loss, accuracy): one ELBO gradient step of ``optimizer``
    (an optim/transform.py Transform). beta follows ``beta_type`` at
    ``batch_idx`` (an int or a tensor), so the Blundell warm-up
    2^(M-i)/(2^M-1) advances with the batch within an epoch; a number is a
    constant beta."""

    def step(params: dict, opt_state, x, y, generator, batch_idx):
        p = {n: t.detach().requires_grad_(True) for n, t in params.items()}
        logits = apply_fn(p, x, generator, training=True)
        nll = loss_fn(logits, y)
        kl = vi.kl_mfvi(vi.flatten(p), 0.0, prior_sigma)
        beta = (get_beta(beta_type, m=n_batches, batch_idx=batch_idx)
                if isinstance(beta_type, str) else beta_type)
        loss = nll + beta * kl
        grads = torch.autograd.grad(loss, list(p.values()),
                                    allow_unused=True)
        grads = {n: torch.zeros_like(t) if g is None else g
                 for (n, t), g in zip(p.items(), grads)}
        with torch.no_grad():
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = apply_updates(params, updates)
            acc = (logits.argmax(-1) == y).float().mean()
        return params, opt_state, loss.detach(), acc

    return step


def _tensor(a, device, dtype) -> torch.Tensor:
    """A numpy array or a tensor as a tensor on ``device``."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a))
    return a.to(device=device, dtype=dtype)


def _flat_items(tree, prefix: str = ""):
    """(path, tensor) pairs of a nested dict of tensors."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _filled(tree, arrays: dict, device, prefix: str = ""):
    """``tree`` with every tensor replaced by ``arrays[path]`` on
    ``device``, in the tree's dtypes."""
    return {k: (_filled(v, arrays, device, f"{prefix}{k}/")
                if isinstance(v, dict) else
                torch.as_tensor(arrays[f"{prefix}{k}"]).to(device=device,
                                                             dtype=v.dtype))
            for k, v in tree.items()}


class ClassificationTrainer:
    """Epoch-driven trainer over (x, y) numpy batches, on ``device`` (the
    card unless "cpu" is asked for)."""

    def __init__(self, apply_fn, params: dict, lr: float = 1e-3,
                 prior_sigma: float = 0.1, n_batches: int = 1,
                 beta_type="Standard", loss_fn=cross_entropy, device=None):
        self.device = resolve_device(device)
        self.apply_fn = apply_fn
        self.params = {n: t.to(self.device, torch.float32)
                       for n, t in params.items()}
        self.optimizer = adamw(lr)
        self.opt_state = self.optimizer.init(self.params)
        self.step = make_elbo_step(apply_fn, self.optimizer, prior_sigma,
                                   n_batches, beta_type, loss_fn)
        self.log = TrainLog([], [])

    def train_epoch(self, batches, generator: torch.Generator) -> float:
        """One pass over ``batches``; returns the mean loss. The draws of
        every batch come from ``generator`` in turn."""
        losses = []
        for i, (x, y) in enumerate(batches):
            x = _tensor(x, self.device, torch.float32)
            y = _tensor(y, self.device, torch.int64)
            self.params, self.opt_state, loss, acc = self.step(
                self.params, self.opt_state, x, y, generator, i)
            losses.append(float(loss))
            self.log.losses.append(float(loss))
            self.log.accuracies.append(float(acc))
        return float(np.mean(losses))

    # -- checkpoints: the parameters and the optimizer state in one npz ------
    def save(self, path: str):
        state = {"params": self.params, "opt": self.opt_state}
        np.savez(path, **{k: v.detach().cpu().numpy()
                          for k, v in _flat_items(state)})

    def load(self, path: str):
        with np.load(path) as z:
            arrays = dict(z)
        state = _filled({"params": self.params, "opt": self.opt_state},
                        arrays, self.device)
        self.params, self.opt_state = state["params"], state["opt"]


class Predictor:
    """MC-averaged predictor: the softmax averaged over ``n_samples``
    stochastic forwards (training-mode draws), under no_grad."""

    def __init__(self, apply_fn, params: dict, n_samples: int = 25):
        self.apply_fn = apply_fn
        self.params = params
        self.n_samples = n_samples

    def __call__(self, x, generator: Optional[torch.Generator] = None):
        device = next(iter(self.params.values())).device
        x = _tensor(x, device, torch.float32)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        with torch.no_grad():
            probs = [torch.softmax(self.apply_fn(self.params, x, generator,
                                                 training=True), dim=-1)
                     for _ in range(self.n_samples)]
        return torch.stack(probs).mean(dim=0)
