"""Predictive uncertainty from MC posterior samples (counterpart of
mfvi_dip_mia_tpu/bayes/uncertainty.py): ``mc_predict`` and Gal's regression
decomposition, epistemic = Var_samples[mu], aleatoric =
E_samples[exp(-neg_logvar)]. NCHW: the channel axis is 2 of (S, N, C, H, W).
"""

from __future__ import annotations

import torch

from ..nn.var_conv import REPARAMS
from ..ops import kernels
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
    Kernel launches are counted once per replay (ops/kernels)."""
    side = capture_stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    start = generator.get_state()
    with torch.cuda.stream(side):
        warm = one()
    torch.cuda.current_stream(device).wait_stream(side)
    generator.set_state(start)
    outs = torch.empty((n_samples, *warm.shape), dtype=warm.dtype,
                       device=device)
    del warm
    graph, launches, static = capture(one, generator, side)
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
