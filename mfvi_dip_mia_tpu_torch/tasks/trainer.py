"""The DIP trainer (counterpart of mfvi_dip_mia_tpu/tasks/trainer.py) for the
MFVI method, as a plain Python loop on the device.

Semantics kept from the JAX step (each with its reference line there):
  * ``num_iter + 1`` total iterations
  * input jitter: z + 0.1 * N(0, 1), fresh every iteration
  * one whole-tree RT draw per step (bayes/vi.py::sample_mfvi_tree); under
    ``reparam='lrt'`` none: the net samples each site in activation space
    from the fit's generator (trainer.py:198, :251-254)
  * prior sigma = sqrt(temp) * sigma; the KL value under no_grad, its
    gradient fused into the flat AdamW (optim/fused_adamw.py)
  * NaN guard: a non-finite loss skips the parameter AND optimizer update
  * EMA out_avg = 0.99 * out_avg + 0.01 * out_t, seeded with the first iterate
  * a 25-slot flat MC ring (unbiased variance at snapshots), PSNR/SSIM
    triples every ``metrics_every``, snapshots every ``show_every``
  * ``compute_dtype`` f32/bf16: the sampled weights (under LRT the mu / rho
    leaves, before any softplus, as cast_tree does) and the input are cast
    once; the master parameters, the KL and the loss stay f32

The host stays out of the loop: metric rows are written to a device buffer
and read once per ``show_every`` chunk (and at snapshots), never per step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..bayes import vi
from ..optim.fused_adamw import flat_adamw_update
from ..utils import images as I
from ..utils.device import resolve_device
from .problems import Problem

MC_RING = 25
EXP_WEIGHT = 0.99
REG_NOISE_STD = 0.1


@dataclasses.dataclass(frozen=True)
class Method:
    """Inference-mode hyperparameters (the two BO axes of MFVI). The other
    methods' fields ride along for the runners (tasks/runners.py::
    method_for); MFVI uses none of them and its weight decay is 0."""
    name: str                      # 'mfvi'
    temp: float = 0.0
    sigma: float = 0.0
    dropout_p: float = 0.3         # mcd
    weight_decay: float = 0.0      # mcd / sgld
    gamma: float = 0.9999          # sgld lr decay

    @property
    def prior_sigma(self) -> float:
        # the POTOBIM coupling: prior sigma = sqrt(temp) * sigma
        return float(np.sqrt(self.temp) * self.sigma)


class HyperParams(NamedTuple):
    """The fit's numeric hyperparameters. The JAX trainer traces them so
    that one compiled graph serves every BO candidate; eager PyTorch traces
    nothing, so here they are plain floats."""
    lr: float
    temp: float
    prior_sigma: float

    @staticmethod
    def of(method: Method, lr: float) -> "HyperParams":
        return HyperParams(float(lr), float(method.temp), method.prior_sigma)


@dataclasses.dataclass
class FitResult:
    mse_corrupted: np.ndarray      # (N,)
    mse_gt: np.ndarray             # (N,)
    psnrs: np.ndarray              # (N, 3)
    ssims: np.ndarray              # (N, 3)
    recons: np.ndarray             # (S, mean_ch, H, W)
    uncerts_epi: np.ndarray        # (S, mean_ch, H, W)
    uncerts_ale: np.ndarray        # (S, mean_ch, H, W)
    params: dict                   # final parameters, name -> numpy (OIHW)
    net_input: np.ndarray          # the fixed DIP input (1, H, W, D)
    iters_per_sec: float           # after the first show_every chunk
    compile_seconds: float         # first chunk's wall, kernel build included
    final_psnr: float              # psnrs[-1, 2]: the BO objective
    executed: int = 0
    wall_seconds: float = 0.0


def resolve_compute_dtype(dtype) -> torch.dtype:
    """'f32' / 'bf16' (or torch dtypes) -> torch dtype; None -> float32."""
    names = {None: torch.float32, "f32": torch.float32,
             "float32": torch.float32, "bf16": torch.bfloat16,
             "bfloat16": torch.bfloat16, torch.float32: torch.float32,
             torch.bfloat16: torch.bfloat16}
    if dtype not in names:
        raise ValueError(f"unknown compute_dtype {dtype!r}")
    return names[dtype]


def init_params(problem: Problem, method: Method, seed: int) -> dict:
    """The fit's initial parameters (CPU tensors): torch-default conv init,
    then the MFVI re-initialization, from one seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    return vi.to_mfvi(problem.net.init_params(gen), gen)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fit(problem: Problem, method: Method, *, num_iter: int, lr: float,
        seed: int = 42, show_every: int = 100,
        snapshot_fn: Optional[Callable] = None, device=None,
        metrics_every: int = 1, compute_dtype="f32",
        collect_snapshots: bool = True,
        rng: np.random.Generator | None = None,
        log_fn: Optional[Callable] = None,
        reparam: str = "rt") -> FitResult:
    """Run one MFVI DIP fit on ``device`` (default: the card). Returns the
    per-iteration metric traces, the snapshot stacks and the final smoothed
    PSNR as ``final_psnr``. ``snapshot_fn(i, recon, epi, ale)`` fires at
    every snapshot, ``log_fn(i, metrics_row)`` at every ``show_every``
    boundary. ``rng`` draws the net input (default ``default_rng(seed)``);
    a runner passes the stream that drew the problem's noise
    (trainer.py:502-513). ``reparam`` is 'rt' (weight-space draws) or 'lrt'
    (local reparameterization, on the LRT double-conv kernel)."""
    if method.name != "mfvi":
        raise NotImplementedError(
            f"method {method.name!r} is not ported yet (ROADMAP Queue 1 "
            "item 10)")
    dev = resolve_device(device)
    if problem.device != dev:
        raise ValueError(f"problem lives on {problem.device}, fit asked for "
                         f"{dev}")
    dtype = resolve_compute_dtype(compute_dtype)
    num_iter = num_iter + 1
    h, w = problem.imsize
    mc = problem.mean_ch
    n_out = {"ct": 1, "den": 2}[problem.task]

    z_np = I.get_noise(problem.input_depth, (h, w),
                       rng=np.random.default_rng(seed) if rng is None else rng)
    z = torch.from_numpy(z_np).permute(0, 3, 1, 2).contiguous().to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    params = vi.flatten(init_params(problem, method, seed), device=dev)
    flat = params.flat
    m = torch.zeros_like(flat)
    v = torch.zeros_like(flat)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    hp = HyperParams.of(method, lr)

    out_avg = torch.zeros((1, n_out, h, w), device=dev)
    ring_epi = torch.zeros((MC_RING, mc * h * w), device=dev)
    ring_ale = torch.zeros((MC_RING, mc * h * w), device=dev)
    rows_dev = torch.full((num_iter, 8), float("nan"), device=dev)

    n_snaps = num_iter // show_every + 1
    rows = np.full((num_iter, 8), np.nan)
    recons = np.zeros((n_snaps, mc, h, w), np.float32)
    unc_epi = np.zeros((n_snaps, mc, h, w), np.float32)
    unc_ale = np.zeros((n_snaps, mc, h, w), np.float32)

    t0 = time.perf_counter()
    t_first = None
    first_iters = min(show_every, num_iter)
    for it in range(num_iter):
        x = z
        if REG_NOISE_STD:
            x = z + REG_NOISE_STD * torch.randn(z.shape, generator=gen,
                                                device=dev)
        p = flat.detach().requires_grad_(True)
        if reparam == "lrt":
            leaves = params.with_flat(p).leaves()
        else:
            leaves = vi.sample_mfvi_tree(
                params.with_flat(p), gen,
                out_dtype=None if dtype == torch.float32 else dtype)
        if dtype != torch.float32:
            leaves = {k: t.to(dtype) for k, t in leaves.items()}
            x = x.to(dtype)
        out = problem.net(leaves, x, gen, reparam=reparam).float()
        loss = problem.data_loss(out)
        loss.backward()
        with torch.no_grad():
            kl = vi.kl_mfvi(params.with_flat(flat), 0.0, hp.prior_sigma)
            ok = torch.isfinite(loss + hp.temp * kl)
            new = flat_adamw_update(
                flat, p.grad, m, v, count, lr=hp.lr, n_var=params.n_var,
                kl_temp=hp.temp, kl_prior_sigma=hp.prior_sigma, use_kl=True)
            flat.copy_(torch.where(ok, new[0], flat))
            m = torch.where(ok, new[1], m)
            v = torch.where(ok, new[2], v)
            count = torch.where(ok, new[3], count)

            out_t = problem.transform(out)
            out_avg = (out_t if it == 0 else
                       out_avg * EXP_WEIGHT + out_t * (1.0 - EXP_WEIGHT))
            slot = it % MC_RING
            ring_epi[slot] = torch.clamp(out_t[0, :mc], 0, 1).reshape(-1)
            if problem.has_ale:
                ale = torch.clamp(out_t[0, mc:], 0, 1)
                ring_ale[slot] = ale.expand(mc, h, w).reshape(-1)
            if it % metrics_every == 0:
                rows_dev[it] = problem.metrics(out_t, out_avg)

            if it % show_every == 0 and collect_snapshots:
                k = it // show_every
                recons[k] = torch.clamp(out_avg[0, :mc], 0, 1).cpu().numpy()
                unc_epi[k] = (ring_epi.var(dim=0, unbiased=True)
                              .reshape(mc, h, w).cpu().numpy())
                if problem.has_ale:
                    unc_ale[k] = (ring_ale.mean(dim=0).reshape(mc, h, w)
                                  .cpu().numpy())
                if snapshot_fn is not None:
                    snapshot_fn(it, recons[k], unc_epi[k], unc_ale[k])

        if (it + 1) % show_every == 0 or it + 1 == num_iter:
            start = it + 1 - ((it % show_every) + 1)
            rows[start:it + 1] = rows_dev[start:it + 1].cpu().numpy()
            if log_fn is not None:
                log_fn(it, rows[it])
            if t_first is None:
                _sync(dev)
                t_first = time.perf_counter()

    _sync(dev)
    total_s = time.perf_counter() - t0
    steady_iters = num_iter - first_iters
    steady_s = time.perf_counter() - t_first
    psnrs = rows[:, 2:5]
    valid = np.where(np.isfinite(psnrs[:, 2]))[0]
    final = float(psnrs[valid[-1], 2]) if len(valid) else float("nan")
    return FitResult(
        mse_corrupted=rows[:, 0], mse_gt=rows[:, 1], psnrs=psnrs,
        ssims=rows[:, 5:8], recons=recons, uncerts_epi=unc_epi,
        uncerts_ale=unc_ale,
        params={k: t.detach().cpu().numpy()
                for k, t in params.with_flat(flat).leaves().items()},
        net_input=z_np,
        iters_per_sec=(steady_iters / steady_s
                       if steady_iters > 0 and steady_s > 0 else 0.0),
        compile_seconds=t_first - t0, final_psnr=final, executed=num_iter,
        wall_seconds=total_s)
