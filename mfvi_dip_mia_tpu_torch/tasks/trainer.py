"""The DIP trainer (counterpart of mfvi_dip_mia_tpu/tasks/trainer.py) for
the four methods: plain DIP ('dip'), mean-field VI ('mfvi'), MC dropout
('mcd') and SGLD ('sgld').

Semantics kept from the JAX step (each with its reference line there):
  * ``num_iter + 1`` total iterations
  * input jitter: z + 0.1 * N(0, 1), fresh every iteration
  * mfvi: one whole-tree RT draw per step (bayes/vi.py::sample_mfvi_tree);
    under ``reparam='lrt'`` none: the net samples each site in activation
    space from the fit's generator (trainer.py:198, :251-254). Prior sigma
    = sqrt(temp) * sigma; the KL value under no_grad, its gradient fused
    into the flat AdamW (optim/fused_adamw.py)
  * dip / mcd / sgld: the torch-default init, no draw and no KL; mcd's
    forward draws its dropout masks from the fit's generator at
    ``dropout_p`` (trainer.py:253)
  * sgld: before the forward, noise N(0, 1) * param_noise_sigma * lr on
    every conv kernel, at the constant base lr (trainer.py:215-220); the
    gradient and the AdamW step are taken at the noised parameters. The
    step's lr decays as lr * gamma^min(it, n_stop) with the 1e-8 floor
    (``optim/sgld.py::DecayedLR``), except on ct, which keeps the constant
    lr (the reference quirk of trainer.py:275-287)
  * AdamW's weight decay is the Method's (trainer.py:275; the runners zero
    it for dip, mfvi and ct)
  * NaN guard: a non-finite loss skips the parameter AND optimizer update;
    under sgld the parameters keep their noise either way (trainer.py:299)
  * EMA out_avg = 0.99 * out_avg + 0.01 * out_t, seeded with the first
    iterate (a select on the device's iteration index, trainer.py:303)
  * a 25-slot flat MC ring (unbiased variance at snapshots), PSNR/SSIM
    triples every ``metrics_every``, snapshots every ``show_every``
  * ``compute_dtype`` f32/bf16: the sampled weights (under LRT the mu / rho
    leaves, before any softplus, as cast_tree does) and the input are cast
    once; the master parameters, the KL and the loss stay f32

The step is static, as JAX's scanned step is (``make_step``): it reads the
problem's fixed device tensors (the target, the inpainting mask, the
operator's matrices) and updates a state of fixed tensors in place, the
iteration index lives on the device, the ring slot and the metric row are
index copies. On the card ``fit``
captures it once as a CUDA graph per variant (the step, and the step with
its metric row) and every iteration is a replay: the counterpart of JAX's
compiled chunk (trainer.py:386-424). ``eager=True`` runs the same step
function eagerly instead, as the CPU always does. The host reads the metric
rows once per ``chunk_iters`` iterations and the snapshot maps after each
``show_every`` boundary, never inside a step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..bayes import vi
from ..ops import kernels
from ..optim import sgld
from ..optim.fused_adamw import flat_adamw_update
from ..utils import images as I
from ..utils.device import resolve_device
from ..utils.graphs import capture, capture_stream
from .problems import METHODS, Problem, reinit_conv_weights_normal

MC_RING = 25
EXP_WEIGHT = 0.99
REG_NOISE_STD = 0.1


@dataclasses.dataclass(frozen=True)
class Method:
    """Inference-mode hyperparameters (the two BO axes per method)."""
    name: str                      # 'dip' | 'mfvi' | 'mcd' | 'sgld'
    temp: float = 0.0              # mfvi
    sigma: float = 0.0             # mfvi prior scale multiplier
    dropout_p: float = 0.3         # mcd
    weight_decay: float = 0.0      # AdamW's decoupled weight decay
    gamma: float = 0.9999          # sgld lr decay
    param_noise_sigma: float = 2.0 # sgld (trainer.py:86)

    @property
    def prior_sigma(self) -> float:
        # the POTOBIM coupling: prior sigma = sqrt(temp) * sigma
        return float(np.sqrt(self.temp) * self.sigma)


class HyperParams(NamedTuple):
    """The fit's numeric hyperparameters. The JAX trainer traces them so
    that one compiled graph serves every BO candidate; the port captures its
    graph once per fit, so here they are plain floats, constants of it."""
    lr: float
    temp: float
    prior_sigma: float
    weight_decay: float
    gamma: float
    dropout_p: float
    param_noise_sigma: float

    @staticmethod
    def of(method: Method, lr: float) -> "HyperParams":
        return HyperParams(float(lr), float(method.temp), method.prior_sigma,
                           float(method.weight_decay), float(method.gamma),
                           float(method.dropout_p),
                           float(method.param_noise_sigma))


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
    iters_per_sec: float           # after the first chunk
    compile_seconds: float         # first chunk's wall: kernel build,
                                   # warm-up and capture included
    final_psnr: float              # psnrs[-1, 2]: the BO objective
    executed: int = 0
    wall_seconds: float = 0.0
    replays: int = 0               # iterations run as a CUDA graph replay
    warmup_steps: int = 0          # eager steps on a copy before capture


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
    then sr mcd's N(0, init_normal_std) conv re-init, then for mfvi the MFVI
    re-initialization, all from one seeded generator (trainer.py:428-450)."""
    gen = torch.Generator().manual_seed(seed)
    params = problem.net.init_params(gen)
    if problem.init_normal_std is not None:
        params = reinit_conv_weights_normal(params, gen,
                                            problem.init_normal_std)
    return vi.to_mfvi(params, gen) if method.name == "mfvi" else params


@dataclasses.dataclass
class StepState:
    """Everything a step reads and writes besides the problem: tensors whose
    storage stays where it is, since every step updates them in place."""
    flat: torch.Tensor        # the [mu | rho | det] parameters (all det
                              # outside mfvi)
    m: torch.Tensor           # AdamW's moments
    v: torch.Tensor
    count: torch.Tensor       # AdamW's step count, int32 ()
    out_avg: torch.Tensor     # (1, n_out, H, W) EMA of the transformed output
    ring_epi: torch.Tensor    # (MC_RING, mean_ch * H * W)
    ring_ale: torch.Tensor
    rows: torch.Tensor        # (iterations, 8) metric rows, NaN where unset
    it: torch.Tensor          # (1,) int64: the iteration the next step runs

    def tensors(self) -> list:
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    def clone(self) -> "StepState":
        return StepState(*(t.clone() for t in self.tensors()))


class Prepared(NamedTuple):
    step: Callable                 # step(state, with_metrics) -> None
    state: StepState               # the state at iteration 0
    params: vi.FlatParams          # the leaf layout of state.flat
    net_input: np.ndarray          # the fixed DIP input (1, H, W, D)
    generator: torch.Generator     # the fit's random stream


def make_step(problem: Problem, params: vi.FlatParams, z: torch.Tensor,
              gen: torch.Generator, hp: HyperParams, dtype: torch.dtype,
              reparam: str, method_name: str) -> Callable:
    """The fit's step: ``step(state, with_metrics)`` runs one iteration of
    ``method_name`` on ``state`` in place (the one at ``state.it``) and
    writes its metric row when ``with_metrics``. It reads nothing back to
    the host, so the same calls can be captured as a CUDA graph: whatever
    it needs besides the state (sgld's kernel positions and decay
    constants) is made here, before any capture."""
    if method_name not in METHODS:
        raise ValueError(f"unknown method {method_name!r}")
    h, w = problem.imsize
    mc = problem.mean_ch
    low = None if dtype == torch.float32 else dtype
    noise_std = REG_NOISE_STD
    is_mfvi = method_name == "mfvi"
    is_sgld = method_name == "sgld"
    dropout_p = hp.dropout_p if method_name == "mcd" else None
    noise_at = sgld.kernel_index(params) if is_sgld else None
    # ct sgld keeps the constant lr (trainer.py:275-287)
    decay = (sgld.DecayedLR(hp.lr, hp.gamma, z.device)
             if is_sgld and problem.task != "ct" else None)

    def step(s: StepState, with_metrics: bool) -> None:
        x = z
        if noise_std:
            x = z + noise_std * torch.randn(z.shape, generator=gen,
                                            device=z.device)
        if is_sgld:
            # noise at the constant base lr, before the forward; it stays in
            # the parameters whatever the NaN guard decides
            sgld.add_param_noise(s.flat, noise_at, gen, hp.param_noise_sigma,
                                 hp.lr)
        p = s.flat.detach().requires_grad_(True)
        if not is_mfvi or reparam == "lrt":
            leaves = params.with_flat(p).leaves()
        else:
            leaves = vi.sample_mfvi_tree(params.with_flat(p), gen,
                                         out_dtype=low)
        if low is not None:
            leaves = {k: t.to(dtype) for k, t in leaves.items()}
            x = x.to(dtype)
        out = problem.net(leaves, x, gen, reparam=reparam,
                          dropout_p=dropout_p).float()
        loss = problem.data_loss(out)
        loss.backward()
        with torch.no_grad():
            if is_mfvi:
                kl = vi.kl_mfvi(params.with_flat(s.flat), 0.0,
                                hp.prior_sigma)
                ok = torch.isfinite(loss + hp.temp * kl)
            else:
                ok = torch.isfinite(loss)
            new = flat_adamw_update(
                s.flat, p.grad, s.m, s.v, s.count,
                lr=hp.lr if decay is None else decay.at(s.it),
                n_var=params.n_var, weight_decay=hp.weight_decay,
                kl_temp=hp.temp, kl_prior_sigma=hp.prior_sigma,
                use_kl=is_mfvi)
            for old, upd in zip((s.flat, s.m, s.v, s.count), new):
                old.copy_(torch.where(ok, upd, old))

            out_t = problem.transform(out)
            s.out_avg.copy_(torch.where(
                s.it == 0, out_t,
                s.out_avg * EXP_WEIGHT + out_t * (1.0 - EXP_WEIGHT)))
            slot = s.it.remainder(MC_RING)
            s.ring_epi.index_copy_(
                0, slot, torch.clamp(out_t[0, :mc], 0, 1).reshape(1, -1))
            if problem.has_ale:
                ale = torch.clamp(out_t[0, mc:], 0, 1)
                s.ring_ale.index_copy_(
                    0, slot, ale.expand(mc, h, w).reshape(1, -1))
            if with_metrics:
                s.rows.index_copy_(
                    0, s.it, problem.metrics(out_t, s.out_avg)[None])
            s.it.add_(1)

    return step


def prepare_fit(problem: Problem, method: Method, *, iterations: int,
                lr: float, seed: int = 42,
                rng: np.random.Generator | None = None, device=None,
                compute_dtype="f32", reparam: str = "rt") -> Prepared:
    """The initialization ``fit`` performs for ``iterations`` iterations in
    all: the state at iteration 0 on ``device`` and its step function.
    ``rng`` draws the net input (default ``default_rng(seed)``)."""
    dev = resolve_device(device)
    if problem.device != dev:
        raise ValueError(f"problem lives on {problem.device}, fit asked for "
                         f"{dev}")
    dtype = resolve_compute_dtype(compute_dtype)
    h, w = problem.imsize
    mc = problem.mean_ch
    n_out = {"ct": 1, "den": 2, "sr": 2, "inp": 4}[problem.task]

    z_np = I.get_noise(problem.input_depth, (h, w),
                       rng=np.random.default_rng(seed) if rng is None else rng)
    z = torch.from_numpy(z_np).permute(0, 3, 1, 2).contiguous().to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = vi.flatten(init_params(problem, method, seed), device=dev)
    flat = params.flat
    state = StepState(
        flat=flat, m=torch.zeros_like(flat), v=torch.zeros_like(flat),
        count=torch.zeros((), dtype=torch.int32, device=dev),
        out_avg=torch.zeros((1, n_out, h, w), device=dev),
        ring_epi=torch.zeros((MC_RING, mc * h * w), device=dev),
        ring_ale=torch.zeros((MC_RING, mc * h * w), device=dev),
        rows=torch.full((iterations, 8), float("nan"), device=dev),
        it=torch.zeros(1, dtype=torch.int64, device=dev))
    step = make_step(problem, params, z, gen, HyperParams.of(method, lr),
                     dtype, reparam, method.name)
    return Prepared(step, state, params, z_np, gen)


def capture_step(step: Callable, state: StepState,
                 gen: torch.Generator) -> dict:
    """``step``'s two variants captured as CUDA graphs on ``state``:
    {with_metrics: (graph, the kernel launches one replay makes)}.

    Both variants first run once eagerly on a copy of the state, on the
    capture's side stream: that builds the kernels, sets their attributes,
    and fills every lazy cache (the dw tickets, the pad tables, the Radon
    plans, the interpolation and blur matrices) before capture, so a capture
    records kernels only and puts nothing of its pool into a cache. ``gen``
    is reset to where it was, so the fit's random stream starts where the
    eager step's would. Raises if a capture fails."""
    dev = state.flat.device
    side = capture_stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    start = gen.get_state()
    with torch.cuda.stream(side):
        scratch = state.clone()
        for with_metrics in (False, True):
            step(scratch, with_metrics)
    torch.cuda.current_stream(dev).wait_stream(side)
    del scratch
    gen.set_state(start)
    return {with_metrics: capture_variant(step, state, gen, side,
                                          with_metrics)
            for with_metrics in (False, True)}


def capture_variant(step: Callable, state: StepState, gen: torch.Generator,
                    stream: torch.cuda.Stream, with_metrics: bool) -> tuple:
    """One variant of ``step`` captured on ``stream``: (graph, the kernel
    launches one replay makes). ``gen`` is registered with the graph, so
    each replay draws the next numbers of the fit's stream, as the eager
    step would."""
    graph, launches, _ = capture(lambda: step(state, with_metrics), gen,
                                 stream)
    return graph, launches


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
        reparam: str = "rt", chunk_iters: Optional[int] = None,
        eager: bool = False) -> FitResult:
    """Run one DIP fit of ``method`` on ``device`` (default: the card).
    Returns the per-iteration metric traces, the snapshot stacks and the
    final smoothed PSNR as ``final_psnr``. ``snapshot_fn(i, recon, epi,
    ale)`` fires at every snapshot, ``log_fn(i, metrics_row)`` once per
    chunk of ``chunk_iters`` iterations (default ``show_every``; snapshots
    need the two equal), at the chunk's last iteration. ``rng`` draws the
    net input (default ``default_rng(seed)``); a runner passes the stream
    that drew the problem's noise (trainer.py:502-513). ``reparam`` is 'rt'
    (weight-space draws) or 'lrt' (local reparameterization, on the LRT
    double-conv kernel).

    On the card every iteration is a replay of the step's CUDA graph
    (``capture_step``); ``eager=True`` runs the step eagerly instead, with
    the same bits. The graphs and their memory are released on return."""
    num_iter = num_iter + 1
    chunk = chunk_iters or show_every
    if collect_snapshots and chunk != show_every:
        raise ValueError(
            "chunk_iters must equal show_every when snapshots are collected; "
            "pass collect_snapshots=False (or plot=False, save=False via the "
            "runners) to use longer chunks")
    prep = prepare_fit(problem, method, iterations=num_iter, lr=lr,
                       seed=seed, rng=rng, device=device,
                       compute_dtype=compute_dtype, reparam=reparam)
    state, dev = prep.state, prep.state.flat.device
    h, w = problem.imsize
    mc = problem.mean_ch

    n_snaps = num_iter // show_every + 1
    rows = np.full((num_iter, 8), np.nan)
    recons = np.zeros((n_snaps, mc, h, w), np.float32)
    unc_epi = np.zeros((n_snaps, mc, h, w), np.float32)
    unc_ale = np.zeros((n_snaps, mc, h, w), np.float32)
    # dip's uncertainty maps stay zero (trainer.py:725)
    maps = method.name != "dip"

    t0 = time.perf_counter()
    graphs = (capture_step(prep.step, state, prep.generator)
              if dev.type == "cuda" and not eager else None)
    warmup_steps = 0 if graphs is None else len(graphs)   # one per variant
    t_first = None
    replays = 0
    for start in range(0, num_iter, chunk):
        end = min(start + chunk, num_iter)
        snaps = []
        for it in range(start, end):
            with_metrics = it % metrics_every == 0
            if graphs is None:
                prep.step(state, with_metrics)
            else:
                graph, launches = graphs[with_metrics]
                graph.replay()
                kernels.add_counts(launches)
                replays += 1
            if collect_snapshots and it % show_every == 0:
                # the maps right after this iteration, read with the chunk
                snaps.append((it, torch.clamp(state.out_avg[0, :mc], 0, 1),
                              state.ring_epi.var(dim=0, unbiased=True)
                              if maps else None,
                              state.ring_ale.mean(dim=0)
                              if maps and problem.has_ale else None))
        rows[start:end] = state.rows[start:end].cpu().numpy()
        for it, recon, epi, ale in snaps:
            k = it // show_every
            recons[k] = recon.cpu().numpy()
            if epi is not None:
                unc_epi[k] = epi.reshape(mc, h, w).cpu().numpy()
            if ale is not None:
                unc_ale[k] = ale.reshape(mc, h, w).cpu().numpy()
            if snapshot_fn is not None:
                snapshot_fn(it, recons[k], unc_epi[k], unc_ale[k])
        if log_fn is not None:
            log_fn(end - 1, rows[end - 1])
        if t_first is None:
            _sync(dev)
            t_first = time.perf_counter()

    _sync(dev)
    graphs = None                  # frees the graphs and their memory pools
    total_s = time.perf_counter() - t0
    first_iters = min(chunk, num_iter)
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
                for k, t in prep.params.with_flat(state.flat).leaves().items()},
        net_input=prep.net_input,
        iters_per_sec=(steady_iters / steady_s
                       if steady_iters > 0 and steady_s > 0 else 0.0),
        compile_seconds=t_first - t0, final_psnr=final, executed=num_iter,
        wall_seconds=total_s, replays=replays, warmup_steps=warmup_steps)
