"""Predictive uncertainty from MC posterior samples (counterpart of
mfvi_dip_mia_tpu/bayes/uncertainty.py): ``mc_predict`` and Gal's regression
decomposition, epistemic = Var_samples[mu], aleatoric =
E_samples[exp(-neg_logvar)]. NCHW: the channel axis is 2 of (S, N, C, H, W).
Besides: Kwon's decomposition for class probabilities, the per-weight
signal-to-noise ratio and the global SNR pruning masks, and the KL
warm-up schedules of the classification trainer.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..nn.var_conv import REPARAMS
from ..ops import kernels
from ..utils import compile_guard
from ..utils.graphs import capture, capture_stream
from . import vi


def mc_predict(apply_fn, params: vi.FlatParams, x: torch.Tensor,
               generator: torch.Generator, n_samples: int,
               reparam: str = "rt", eager: bool = False) -> torch.Tensor:
    """``n_samples`` stochastic forwards under no_grad, as
    uncertainty.py:41-50 draws them: under ``reparam='rt'`` each on one
    whole-tree RT draw (vi.sample_mfvi_tree) of a variational tree, or on a
    deterministic tree as it is, ``apply_fn(leaves, x, generator)``: the
    generator reaches the forward for its dropout masks, as JAX's key does;
    under 'lrt' each on the unsampled mu / rho tree with fresh activation
    noise, ``apply_fn(leaves, x, generator, reparam='lrt')``. apply_fn
    returns (N, C, H, W); the result is (S, N, C, H, W).

    On the card one sample's forward is captured as a CUDA graph, the
    counterpart of the one compiled graph JAX maps the samples through, and
    replayed once per sample (``_replayed``), with the eager loop's bits
    (each replay draws fresh RT weights, activation noise or dropout masks
    from the registered generator);
    ``eager=True`` runs the samples one after another instead, as the CPU
    always does."""
    if reparam not in REPARAMS:
        raise ValueError(f"unknown reparam {reparam!r}")

    def one():
        if reparam == "lrt":
            return apply_fn(params.leaves(), x, generator, reparam="lrt")
        leaves = (vi.sample_mfvi_tree(params, generator) if params.n_var
                  else params.leaves())
        return apply_fn(leaves, x, generator)

    with torch.no_grad():
        if eager or x.device.type != "cuda":
            return torch.stack([one() for _ in range(n_samples)])
        return _replayed(one, generator, n_samples, x.device)


def _replayed(one, generator: torch.Generator, n_samples: int,
              device: torch.device) -> torch.Tensor:
    """``one()`` (a sample drawn from ``generator``) run ``n_samples`` times
    as replays of its CUDA graph. One sample first runs eagerly on the
    capture stream (utils/graphs.py::capture_stream) and is thrown away: it
    builds the kernels and fills every lazy cache (pad tables, Radon plans,
    interpolation matrices) before the capture, so the capture records
    kernels only. The generator is then reset and registered with the
    graph, so replay i draws what the i-th eager sample would. Each replay
    overwrites the graph's output, which is copied into the stacked result
    before the next; the graph and its memory pool are released on return.
    Kernel launches are counted once per replay (ops/kernels). The warm
    sample and the capture hold the compile lock (utils/compile_guard.py),
    as a fit's do."""
    side = capture_stream(device)
    with compile_guard.LOCK:
        side.wait_stream(torch.cuda.current_stream(device))
        start = generator.get_state()
        with torch.cuda.stream(side):
            warm = one()
        torch.cuda.current_stream(device).wait_stream(side)
        generator.set_state(start)
        outs = torch.empty((n_samples, *warm.shape), dtype=warm.dtype,
                           device=device)
        del warm
        graph, launches, static = capture(one, [generator], side)
    for i in range(n_samples):
        graph.replay()
        kernels.add_counts(launches)
        outs[i].copy_(static)
    del static, graph
    return outs


def uncert_regression_gal(outputs: torch.Tensor, mean_channels: int = 1):
    """Stacked MC outputs (S, N, C, H, W) -> (mean, aleatoric, epistemic),
    each (N, mean_channels, H, W). Channels [0:mean_channels] are mu, the
    rest neg_logvar; the variance is the biased one (jnp.var)."""
    mu = outputs[:, :, :mean_channels]
    mean = mu.mean(dim=0)
    epistemic = mu.var(dim=0, unbiased=False)
    if outputs.shape[2] > mean_channels:
        aleatoric = torch.exp(-outputs[:, :, mean_channels:]).mean(dim=0)
    else:
        aleatoric = torch.zeros_like(epistemic)
    return mean, aleatoric, epistemic


def uncert_classification_kwon(probs: torch.Tensor):
    """Kwon et al.'s decomposition of stacked MC class probabilities
    (S, N, K, ...) -> (mean, aleatoric, epistemic): aleatoric =
    E[p - p^2], epistemic = E[(p - E p)^2] (uncertainty.py:72)."""
    p_mean = probs.mean(dim=0)
    aleatoric = (probs - probs ** 2).mean(dim=0)
    epistemic = ((probs - p_mean[None]) ** 2).mean(dim=0)
    return p_mean, aleatoric, epistemic


def snr(mu: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """Per-weight signal-to-noise ratio |mu| / softplus(rho)."""
    return mu.abs() / F.softplus(rho)


def prune_mask_by_snr(params: dict, amount: float) -> dict:
    """Global SNR pruning of a variational parameter dict: 0/1 masks that
    zero the lowest-SNR share ``amount`` of the kernel weights, as
    ``{"<prefix>.w": mask}`` for every '<prefix>.w_mu' / '<prefix>.w_rho'
    pair (uncertainty.py:88). The threshold is JAX's: the k-th smallest of
    all SNRs, k = int(amount * n); a weight is kept when its SNR is above
    it."""
    prefixes = [n[:-len(".w_mu")] for n in params if n.endswith(".w_mu")]
    if not prefixes:
        raise ValueError("no variational leaves to prune")
    snrs = {p: snr(params[f"{p}.w_mu"], params[f"{p}.w_rho"])
            for p in prefixes}
    all_snr = torch.cat([v.reshape(-1) for v in snrs.values()])
    k = int(amount * all_snr.numel())
    if k > 0:
        thresh = torch.sort(all_snr).values[k - 1]
    else:
        thresh = torch.tensor(-float("inf"), device=all_snr.device)
    return {f"{p}.w": (v > thresh).to(torch.float32)
            for p, v in snrs.items()}


def get_beta(beta_type, epoch: int | None = None,
             num_epochs: int | None = None, batch_idx=0, m: int = 1):
    """KL warm-up schedules (uncertainty.py:127): 'Blundell'
    2^(M-i)/(2^M-1), in the overflow-free form 2^-(i+1) / (1 - 2^-M), for
    an int or a tensor ``batch_idx``; 'Soenderby' min(epoch / (n // 4), 1);
    'Standard' 1/M; else the constant ``beta_type``."""
    if beta_type == "Blundell":
        return 2.0 ** (-(batch_idx + 1.0)) / (1.0 - 2.0 ** (-float(m)))
    if beta_type == "Soenderby":
        if epoch is None or num_epochs is None:
            raise ValueError("Soenderby schedule needs epoch/num_epochs")
        return min(epoch / (num_epochs // 4), 1.0)
    if beta_type == "Standard":
        return 1.0 / m
    return beta_type
