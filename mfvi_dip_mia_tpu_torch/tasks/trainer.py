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
    into the flat AdamW (optim/fused_adamw.py). A scale-mixture
    ``Method.prior`` (a 'pi' key) takes the MC KL instead
    (vi.py::kl_mfvi_mc, one mixture draw per step from the fit's
    generator): loss + temp * KL goes through autograd and the AdamW adds
    no analytic KL gradient (trainer.py:257-268, :288-294)
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
  * NaN guard: a non-finite loss (+ temp * KL under mfvi) skips the
    parameter AND optimizer update;
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
``show_every`` boundary, never inside a step. Between chunks ``fit`` may
write a checkpoint (every StepState tensor, the generator's state, the host
rows and snapshots) and resume from one before it captures, and an opt-in
early stop decides on the rows the host has read (trainer.py:557-579).
``fit_interleaved`` runs K fits of one problem on one card, each its own
graphs replayed chunk by chunk in turn, each giving the bits of
its sequential ``fit``; ``capture_steps`` captures several fits' steps
back to back as one graph per variant (parallel/sharding.py's blocks).
A fit records spans (utils/profiling.py::TRACER, on by default) of its
preparation, capture and chunks. With tracing on, each chunk's span
carries the device time of its replays and, from the step's ``Marks``, of
one replay's regions (``STEP_REGIONS``): a third graph, the step with its
metric row and the marks, replays a chunk's last metric iteration, so the
two graphs that replay the rest record no mark.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..bayes import vi
from ..nn.sp import RowSplit
from ..ops import kernels
from ..optim import sgld
from ..optim.fused_adamw import flat_adamw_update
from ..utils import images as I
from ..utils import compile_guard
from ..utils.device import resolve_device
from ..utils.graphs import capture, capture_stream
from ..utils.profiling import TRACER, Marks
from .problems import METHODS, Problem, reinit_conv_weights_normal

MC_RING = 25
EXP_WEIGHT = 0.99
REG_NOISE_STD = 0.1
N_OUT = {"ct": 1, "den": 2, "sr": 2, "inp": 4}   # the net's output channels
# the step's regions, in order, between the six boundaries its Marks time
STEP_REGIONS = ("draw", "forward", "backward", "update", "tail")
MARKED = "marked"   # capture_step's key of the step with its metric row and
                    # marks
_MARKING = threading.local()   # .on: the step records its marks


@contextlib.contextmanager
def _marking():
    """The steps this thread runs or captures in the block record their
    marks."""
    _MARKING.on = True
    try:
        yield
    finally:
        _MARKING.on = False


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
    # an optional scale-mixture prior in the reference's dict schema
    # ({'mu': [..], 'sigma': [..], 'pi': [..]}): with 'pi' the MFVI KL is
    # the MC estimate against it; None (or no 'pi') keeps the scalar prior
    prior: dict | None = None

    @property
    def prior_sigma(self) -> float:
        # the POTOBIM coupling: prior sigma = sqrt(temp) * sigma
        return float(np.sqrt(self.temp) * self.sigma)


class HyperParams(NamedTuple):
    """The fit's numeric hyperparameters. The JAX trainer traces them so
    that one compiled graph serves every BO candidate; the port captures its
    graph once per fit, so here they are plain floats, constants of it. The
    mixture prior's components are tuples, empty for the scalar prior; its
    scales carry the +1e-6 stabilizer (trainer.py:111-132)."""
    lr: float
    temp: float
    prior_sigma: float
    weight_decay: float
    gamma: float
    dropout_p: float
    param_noise_sigma: float
    prior_loc: tuple = ()
    prior_scale: tuple = ()
    prior_pi: tuple = ()

    @staticmethod
    def of(method: Method, lr: float) -> "HyperParams":
        mix = ((), (), ())
        if method.prior is not None and "pi" in method.prior:
            mix = (tuple(float(v) for v in method.prior["mu"]),
                   tuple(float(v) + vi.PRIOR_SIGMA_STABILIZER
                         for v in method.prior["sigma"]),
                   tuple(float(v) for v in method.prior["pi"]))
        return HyperParams(float(lr), float(method.temp), method.prior_sigma,
                           float(method.weight_decay), float(method.gamma),
                           float(method.dropout_p),
                           float(method.param_noise_sigma), *mix)


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
    split: Optional[RowSplit] = None   # the net's row split, if any
    marks: Optional[Marks] = None  # the step's region boundaries (tracing on)


def make_step(problem: Problem, params: vi.FlatParams, z: torch.Tensor,
              gen: torch.Generator, hp: HyperParams, dtype: torch.dtype,
              reparam: str, method_name: str,
              split: Optional[RowSplit] = None) -> tuple:
    """The fit's step and its marks: ``step(state, with_metrics)`` runs one
    iteration of ``method_name`` on ``state`` in place (the one at
    ``state.it``) and writes its metric row when ``with_metrics``. It reads
    nothing back to the host, so the same calls can be captured as a CUDA
    graph: whatever it needs besides the state (sgld's kernel positions and
    decay constants, the marks' events) is made here, before any capture.
    ``split`` runs the net row-split (nn/skip.py's ``split``); its input
    jitter is drawn whole and its output gathered, so everything else is
    the unsplit step's.

    With tracing on (utils/profiling.py::TRACER) the step has six
    boundaries of ``marks`` (a ``Marks`` over ``STEP_REGIONS``): draw (the
    jitter, sgld's noise, the RT draw, the casts), forward (the net, the
    data loss, the MC KL), backward, update (the KL, the guard's test, the
    flat AdamW, the guard's copies) and tail (the transform, the EMA, the
    rings, the metric row, the iteration index). It records them only when
    run or captured inside ``_marking()``: on the card each is an event on
    the stream, which a capture records into the graph (``MARKED``). With
    tracing off ``marks`` is None and the step records nothing."""
    if method_name not in METHODS:
        raise ValueError(f"unknown method {method_name!r}")
    h, w = problem.imsize
    mc = problem.mean_ch
    low = None if dtype == torch.float32 else dtype
    noise_std = REG_NOISE_STD
    is_mfvi = method_name == "mfvi"
    is_sgld = method_name == "sgld"
    # the scale-mixture prior's tensors, made before any capture
    mix = (vi.Mixture.of(hp.prior_loc, hp.prior_scale, hp.prior_pi, z.device)
           if is_mfvi and hp.prior_pi else None)
    dropout_p = hp.dropout_p if method_name == "mcd" else None
    noise_at = sgld.kernel_index(params) if is_sgld else None
    # ct sgld keeps the constant lr (trainer.py:275-287)
    decay = (sgld.DecayedLR(hp.lr, hp.gamma, z.device)
             if is_sgld and problem.task != "ct" else None)
    net_kw = {} if split is None else {"split": split}
    marks = Marks(STEP_REGIONS, z.device) if TRACER.enabled else None

    def mark(k: int) -> None:
        if marks is not None and getattr(_MARKING, "on", False):
            marks.mark(k)

    def step(s: StepState, with_metrics: bool) -> None:
        mark(0)
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
        mark(1)
        out = problem.net(leaves, x, gen, reparam=reparam,
                          dropout_p=dropout_p, **net_kw).float()
        loss = problem.data_loss(out)
        if mix is not None:
            # the MC KL's gradient through autograd, none from the AdamW
            loss = loss + hp.temp * vi.kl_mfvi_mc(params.with_flat(p), gen,
                                                  mix)
        mark(2)
        loss.backward()
        mark(3)
        with torch.no_grad():
            if is_mfvi and mix is None:
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
                use_kl=is_mfvi and mix is None)
            for old, upd in zip((s.flat, s.m, s.v, s.count), new):
                old.copy_(torch.where(ok, upd, old))
            mark(4)

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
        mark(5)

    return step, marks


def prepare_fit(problem: Problem, method: Method, *, iterations: int,
                lr: float, seed: int = 42,
                rng: np.random.Generator | None = None, device=None,
                compute_dtype="f32", reparam: str = "rt",
                shardings=None) -> Prepared:
    """The initialization ``fit`` performs for ``iterations`` iterations in
    all: the state at iteration 0 on ``device`` and its step function.
    ``rng`` draws the net input (default ``default_rng(seed)``).
    ``shardings``: a placement (parallel/sharding.py::sp_shardings), or a
    callable that makes one from the state at iteration 0; its ``split``
    runs the step's net row-split, its first shard on ``device``, where the
    state stays whole."""
    dev = resolve_device(device)
    if problem.device != dev:
        raise ValueError(f"problem lives on {problem.device}, fit asked for "
                         f"{dev}")
    dtype = resolve_compute_dtype(compute_dtype)
    h, w = problem.imsize
    mc = problem.mean_ch
    n_out = N_OUT[problem.task]

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
    split = None
    if shardings is not None:
        placed = shardings(state) if callable(shardings) else shardings
        split = placed["split"]
        if split.first != flat.device:
            raise ValueError(f"the state lives on {flat.device}, the split's "
                             f"first shard on {split.first}")
    step, marks = make_step(problem, params, z, gen,
                            HyperParams.of(method, lr), dtype, reparam,
                            method.name, split)
    return Prepared(step, state, params, z_np, gen, split, marks)


def capture_step(step: Callable, state: StepState,
                 gen: torch.Generator) -> dict:
    """``step``'s two variants captured as CUDA graphs on ``state``:
    {with_metrics: (graph, the kernel launches one replay makes)}, and with
    tracing on a third, ``MARKED`` (``capture_steps`` of one fit)."""
    return capture_steps([(step, state, gen)], marked=TRACER.enabled)


def capture_steps(fits: list, marked: bool = False) -> dict:
    """The steps of ``fits`` (a list of (step, state, generator) on one
    card) captured back to back as one CUDA graph per variant, so that one
    replay advances every fit by one iteration: {with_metrics: (graph, the
    kernel launches one replay makes)}. ``marked`` adds the variant
    ``MARKED``: the step with its metric row, recording its marks
    (``make_step``), which a replay of it times; the launches are the
    metric variant's.

    Each fit's two variants first run once eagerly on a copy of its state,
    on the capture's side stream: that builds the kernels, sets their
    attributes, and fills every lazy cache (the dw tickets, the pad tables,
    the Radon plans, the interpolation and blur matrices) before capture,
    so a capture records kernels only and puts nothing of its pool into a
    cache. The copy's iteration index starts at 0, so a resumed state warms
    up in bounds too. Each fit's generator is reset to where it was (a warm
    up draws from its own fit's generator only), so each fit's random
    stream starts where its eager step's would. Raises if a capture
    fails.

    The warm-up and the captures hold the compile lock
    (utils/compile_guard.py): fits on other threads capture one at a time,
    and replay meanwhile. The side stream is the thread's own
    (utils/graphs.py::capture_stream): inside ``own_stream`` the current
    stream itself, where the graphs then replay. The wait for the lock,
    the warm-up (until its work is done) and each variant's capture are
    the spans ``lock_wait``, ``warmup`` and ``graph`` (utils/profiling.py),
    children of the caller's innermost span."""
    dev = fits[0][1].flat.device
    side = capture_stream(dev)
    with compile_guard.held():
        with TRACER.span("warmup"), \
                (_marking() if marked else contextlib.nullcontext()):
            # the marks' events are made in their first record, here
            side.wait_stream(torch.cuda.current_stream(dev))
            starts = [gen.get_state() for _, _, gen in fits]
            with torch.cuda.stream(side):
                for step, state, _ in fits:
                    scratch = state.clone()
                    # a fit resumed at its last chunk would write a row past
                    # the end
                    scratch.it.zero_()
                    for with_metrics in (False, True):
                        step(scratch, with_metrics)
            torch.cuda.current_stream(dev).wait_stream(side)
            # the capture's start waits for the whole card anyway
            side.synchronize()
        del scratch
        for (_, _, gen), start in zip(fits, starts):
            gen.set_state(start)
        graphs = {with_metrics: capture_variant(fits, side, with_metrics)
                  for with_metrics in (False, True)}
        if marked:
            with _marking():
                graphs[MARKED] = capture_variant(fits, side, True)
        return graphs


def capture_variant(fits: list, stream: torch.cuda.Stream,
                    with_metrics: bool) -> tuple:
    """One variant of the steps of ``fits`` captured on ``stream``, one
    after another, as a ``graph`` span: (graph, the kernel launches one
    replay makes). Every fit's generator is registered with the graph, so
    each replay draws the next numbers of each fit's stream, as the eager
    steps would. The caller holds the compile lock (``capture_steps``)."""
    def steps():
        for step, state, _ in fits:
            step(state, with_metrics)

    with TRACER.span("graph", with_metrics=with_metrics,
                     marked=getattr(_MARKING, "on", False)):
        graph, launches, _ = capture(steps, [gen for _, _, gen in fits],
                                     stream)
    return graph, launches


def save_fit_checkpoint(path: str, state: StepState,
                        generator: torch.Generator, chunk: int,
                        host: dict) -> None:
    """A mid-fit checkpoint (trainer.py:480-488) as one npz: every StepState
    tensor by name ('state_<field>'), the fit generator's state, ``chunk``
    (the chunk the fit resumes at) and the host's metric rows and snapshot
    stacks ('host_<name>'). Written through a temporary file and renamed,
    so a fit cut during a save leaves the previous checkpoint whole."""
    payload = {f"state_{f.name}": getattr(state, f.name).cpu().numpy()
               for f in dataclasses.fields(state)}
    payload.update({f"host_{k}": v for k, v in host.items()})
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, chunk=chunk, generator=generator.get_state().numpy(),
             **payload)
    os.replace(tmp, path)


def load_fit_checkpoint(path: str, state: StepState,
                        generator: torch.Generator) -> tuple:
    """Load a ``save_fit_checkpoint`` file into ``state`` (in place, on its
    tensors' device) and ``generator``; returns (chunk, {name: host
    array})."""
    with np.load(path) as z:
        for f in dataclasses.fields(state):
            getattr(state, f.name).copy_(
                torch.from_numpy(z[f"state_{f.name}"]))
        generator.set_state(torch.from_numpy(z["generator"]))
        host = {k[len("host_"):]: z[k] for k in z.files
                if k.startswith("host_")}
        return int(z["chunk"]), host


class _EarlyStop:
    """Host-side early stopping on the smoothed-recon PSNR (the BO
    objective), a copy of trainer.py:557-579. Opt-in: a fit stops once the
    best smoothed PSNR has not improved by ``min_delta`` dB within
    ``patience`` iterations, decided once per chunk on the rows the host
    has read."""

    def __init__(self, spec: dict):
        self.patience = int(spec.get("patience", 5000))
        self.min_delta = float(spec.get("min_delta", 0.05))
        self.best = -np.inf
        self.best_iter = 0

    def should_stop(self, psnr_sm_rows: np.ndarray, start: int) -> bool:
        col = np.asarray(psnr_sm_rows)
        finite = np.isfinite(col)
        if finite.any():
            i = int(np.nanargmax(np.where(finite, col, -np.inf)))
            if col[i] > self.best + self.min_delta:
                self.best = float(col[i])
                self.best_iter = start + i
                return False
        return (start + len(col) - 1 - self.best_iter) >= self.patience


def _sync(device: torch.device) -> None:
    """Wait for the fit's own work: its stream, not the whole card, where
    other threads' fits run and may be capturing."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _advance(prep: Prepared, graphs: Optional[dict], with_metrics: bool,
             marked: bool = False) -> int:
    """One iteration of ``prep``'s fit: a replay of its graph of the
    variant (``MARKED`` where ``marked``; its kernel launches counted), or
    the eager step, recording its marks where ``marked``. Returns the
    replays made."""
    if graphs is None:
        if marked:
            with _marking():
                prep.step(prep.state, with_metrics)
        else:
            prep.step(prep.state, with_metrics)
        return 0
    graph, launches = graphs[MARKED if marked else with_metrics]
    graph.replay()
    kernels.add_counts(launches)
    return 1


def _run_chunk(prep: Prepared, graphs: Optional[dict], start: int, end: int,
               metrics_every: int, span, chunk_marks: Optional[Marks],
               on_step: Optional[Callable] = None) -> int:
    """Iterations ``start`` to ``end`` - 1 of ``prep``'s fit, their
    ``replays`` into its ``chunk`` span. With tracing on, ``chunk_marks``
    on the fit's stream before the first step and after the last, and the
    chunk's last metric iteration (the span's ``marked``, None where the
    chunk has none or the fit no ``MARKED`` graph) records the step's
    marks. ``on_step(it)`` runs after each. Returns the replays made."""
    marked = None
    if chunk_marks is not None:
        last = end - 1 - (end - 1) % metrics_every
        if last >= start and (graphs is None or MARKED in graphs):
            marked = last
        span.attrs["marked"] = marked
        chunk_marks.mark(0)
    replays = 0
    for it in range(start, end):
        replays += _advance(prep, graphs, it % metrics_every == 0,
                            it == marked)
        if on_step is not None:
            on_step(it)
    if chunk_marks is not None:
        chunk_marks.mark(1)
    span.attrs["replays"] = replays
    return replays


def _read_rows(prep: Prepared, rows: np.ndarray, start: int, end: int,
               span, chunk_marks: Optional[Marks]) -> None:
    """The chunk's metric rows into ``rows``, which waits for its work;
    with tracing on, the chunk's device ms between its marks
    (``device_ms``) and the ``marked`` iteration's by ``STEP_REGIONS``
    (``regions_ms``), on the marks' ``clock`` ('device': the card's events;
    'host': host times, on the CPU), into ``span``."""
    rows[start:end] = prep.state.rows[start:end].cpu().numpy()
    if chunk_marks is not None:
        span.attrs.update(clock=chunk_marks.clock,
                          device_ms=chunk_marks.read()["chunk"])
        if span.attrs["marked"] is not None:
            span.attrs["regions_ms"] = prep.marks.read()


def _chunk_marks(prep: Prepared, device: torch.device) -> Optional[Marks]:
    return Marks(("chunk",), device) if prep.marks is not None else None


def _clocks(starts: list, first_ends: list, ends: list,
            steady_iters: int) -> dict:
    """FitResult's clocks from span times (ns): ``compile_seconds`` from the
    earliest of ``starts`` (the captures' starts, else the first chunks')
    to the latest first chunk's end, ``wall_seconds`` to the latest last
    chunk's end, and ``iters_per_sec``: ``steady_iters`` (those after the
    first chunk) over the time between the two ends."""
    t0, first, end = min(starts), max(first_ends), max(ends)
    steady_s = (end - first) / 1e9
    return dict(iters_per_sec=(steady_iters / steady_s
                               if steady_iters > 0 and steady_s > 0 else 0.0),
                compile_seconds=(first - t0) / 1e9,
                wall_seconds=(end - t0) / 1e9)


def _fit_attrs(method: Method, compute_dtype, seed: int) -> dict:
    """A ``fit`` span's attributes before its preparation, which adds the
    problem's task and device."""
    return dict(method=method.name, temp=method.temp, sigma=method.sigma,
                compute_dtype=str(compute_dtype), seed=seed)


def fit(problem: Problem, method: Method, *, num_iter: int, lr: float,
        seed: int = 42, show_every: int = 100,
        snapshot_fn: Optional[Callable] = None, device=None,
        metrics_every: int = 1, compute_dtype="f32",
        collect_snapshots: bool = True,
        rng: np.random.Generator | None = None,
        log_fn: Optional[Callable] = None,
        reparam: str = "rt", chunk_iters: Optional[int] = None,
        eager: bool = False, checkpoint_path: Optional[str] = None,
        checkpoint_every_chunks: int = 100, resume: bool = False,
        early_stop: Optional[dict] = None, shardings=None) -> FitResult:
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

    ``checkpoint_path`` writes a checkpoint after chunk s + 1 whenever
    s + 1 < the chunk count and (s + 1) % ``checkpoint_every_chunks`` == 0
    (trainer.py:736-742); ``resume=True`` starts from that file when it
    exists, and gives the uninterrupted fit's bits. ``early_stop=
    {'patience': iters, 'min_delta': dB}`` ends the fit once the smoothed
    PSNR plateaus (``_EarlyStop``): the rows after the last chunk run are
    NaN, ``executed`` counts the iterations run and ``final_psnr`` is the
    last finite one.

    ``shardings`` (trainer.py:640-651): a placement, or a callable that
    makes one from the prepared state, as parallel/sharding.py::
    sp_shardings does for ``fit_sp``: the step's net then runs row-split
    over the placement's ``split`` (nn/sp.py); the state, and so the
    checkpoints, stay whole on ``device``.

    On the card every iteration is a replay of the step's CUDA graph
    (``capture_step``); ``eager=True`` runs the step eagerly instead, with
    the same bits. A split over several cards runs eagerly, since a graph
    belongs to one device. The graphs and their memory are released on
    return, and when a callback raises.

    The fit is a ``fit`` span (utils/profiling.py::TRACER; attributes
    task, method, temp, sigma, compute_dtype, device, seed, and the
    ``executed`` iterations and ``replays`` so far) with the children
    ``prepare``, ``capture`` (with ``capture_steps``' spans) and one
    ``chunk`` per chunk (its ``first`` and ``last`` iteration and the
    attributes of ``_run_chunk`` and ``_read_rows``), which ends before
    ``snapshot_fn`` and ``log_fn`` run. ``iters_per_sec``,
    ``compile_seconds`` and ``wall_seconds`` are read from these spans."""
    num_iter = num_iter + 1
    chunk = chunk_iters or show_every
    if collect_snapshots and chunk != show_every:
        raise ValueError(
            "chunk_iters must equal show_every when snapshots are collected; "
            "pass collect_snapshots=False (or plot=False, save=False via the "
            "runners) to use longer chunks")
    with TRACER.span("fit", **_fit_attrs(method, compute_dtype,
                                         seed)) as fit_span:
        with TRACER.span("prepare"):
            prep = prepare_fit(problem, method, iterations=num_iter, lr=lr,
                               seed=seed, rng=rng, device=device,
                               compute_dtype=compute_dtype, reparam=reparam,
                               shardings=shardings)
        state, dev = prep.state, prep.state.flat.device
        fit_span.attrs.update(task=problem.task, device=str(dev))
        h, w = problem.imsize
        mc = problem.mean_ch

        n_snaps = num_iter // show_every + 1
        rows = np.full((num_iter, 8), np.nan)
        recons = np.zeros((n_snaps, mc, h, w), np.float32)
        unc_epi = np.zeros((n_snaps, mc, h, w), np.float32)
        unc_ale = np.zeros((n_snaps, mc, h, w), np.float32)
        # dip's uncertainty maps stay zero (trainer.py:725)
        maps = method.name != "dip"
        host = {"rows": rows, "recons": recons, "unc_epi": unc_epi,
                "unc_ale": unc_ale}
        n_chunks = -(-num_iter // chunk)
        start_chunk = 0
        if resume and checkpoint_path and os.path.isfile(checkpoint_path):
            # before the capture: it resets the generator to where it finds
            # it
            start_chunk, saved = load_fit_checkpoint(checkpoint_path, state,
                                                     prep.generator)
            for name, dst in host.items():
                dst[...] = saved[name]

        graphs, started = None, []
        try:
            if (dev.type == "cuda" and not eager
                    and not (prep.split is not None
                             and prep.split.spans_devices)):
                with TRACER.span("capture") as capture_span:
                    graphs = capture_step(prep.step, state, prep.generator)
                started.append(capture_span.start_ns)
            warmup_steps = 0 if graphs is None else 2  # per variant
            chunk_marks = _chunk_marks(prep, dev)
            stop = _EarlyStop(early_stop) if early_stop else None
            executed = num_iter
            replays = 0
            chunks, snaps = [], []

            def snapshot(it):
                # the maps right after this iteration, read with the chunk
                if it % show_every == 0:
                    snaps.append((
                        it, torch.clamp(state.out_avg[0, :mc], 0, 1),
                        state.ring_epi.var(dim=0, unbiased=True)
                        if maps else None,
                        state.ring_ale.mean(dim=0)
                        if maps and problem.has_ale else None))

            for s in range(start_chunk, n_chunks):
                start = s * chunk
                end = min(start + chunk, num_iter)
                snaps.clear()
                with TRACER.span("chunk", first=start, last=end - 1) as span:
                    replays += _run_chunk(
                        prep, graphs, start, end, metrics_every, span,
                        chunk_marks, snapshot if collect_snapshots else None)
                    _read_rows(prep, rows, start, end, span, chunk_marks)
                    for it, recon, epi, ale in snaps:
                        k = it // show_every
                        recons[k] = recon.cpu().numpy()
                        if epi is not None:
                            unc_epi[k] = epi.reshape(mc, h, w).cpu().numpy()
                        if ale is not None:
                            unc_ale[k] = ale.reshape(mc, h, w).cpu().numpy()
                chunks.append(span)
                fit_span.attrs.update(executed=end, replays=replays)
                if snapshot_fn is not None:
                    for it, *_ in snaps:
                        k = it // show_every
                        snapshot_fn(it, recons[k], unc_epi[k], unc_ale[k])
                if log_fn is not None:
                    log_fn(end - 1, rows[end - 1])
                if (checkpoint_path and s + 1 < n_chunks
                        and (s + 1) % checkpoint_every_chunks == 0):
                    save_fit_checkpoint(checkpoint_path, state,
                                        prep.generator, s + 1, host)
                if stop is not None and stop.should_stop(rows[start:end, 4],
                                                         start):
                    executed = end
                    rows[end:] = np.nan
                    break
        finally:
            _sync(dev)
            graphs = None          # frees the graphs and their memory pools

    clocks = _clocks(started + [chunks[0].start_ns], [chunks[0].end_ns],
                     [chunks[-1].end_ns],
                     sum(c.attrs["last"] + 1 - c.attrs["first"]
                         for c in chunks[1:]))
    psnrs = rows[:, 2:5]
    valid = np.where(np.isfinite(psnrs[:, 2]))[0]
    final = float(psnrs[valid[-1], 2]) if len(valid) else float("nan")
    return FitResult(
        mse_corrupted=rows[:, 0], mse_gt=rows[:, 1], psnrs=psnrs,
        ssims=rows[:, 5:8], recons=recons, uncerts_epi=unc_epi,
        uncerts_ale=unc_ale,
        params={k: t.detach().cpu().numpy()
                for k, t in prep.params.with_flat(state.flat).leaves().items()},
        net_input=prep.net_input, final_psnr=final, executed=executed,
        replays=replays, warmup_steps=warmup_steps, **clocks)


def fit_interleaved(problem: Problem, methods, *, num_iter: int, lr: float,
                    seed: int = 42, rngs=None, show_every: int = 100,
                    metrics_every: int = 1,
                    chunk_iters: Optional[int] = None, reparam: str = "rt",
                    device=None, compute_dtype="f32", eager: bool = False,
                    early_stop: Optional[dict] = None,
                    log_fn: Optional[Callable] = None) -> list:
    """K fits of the same problem, one per ``methods`` entry (all of one
    method name), time-multiplexed on one device (default: the card):
    trainer.py:771-904. Each fit is ``fit``'s with the same ``seed``: its
    own state, its own generator seeded ``seed``, and its net input drawn
    from ``rngs[j]`` (default ``default_rng(seed)``), so each gives the bits
    of its sequential ``fit``. The fits share the problem's device tensors.

    On the card each fit's step is captured as its own pair of CUDA graphs
    (``capture_step``; K private memory pools); each chunk of
    ``chunk_iters`` iterations (default ``show_every``) replays fit 0's
    chunk, then fit 1's, and so on, on the current stream, and the host
    reads fit j's metric rows while the later fits' replays run.
    ``eager=True``, and the CPU, run each step eagerly instead. Per fit: an
    optional early stop (``fit``'s ``early_stop``) ends its replays; no
    snapshot stacks (zero-sized) and no checkpoint. ``log_fn(j, i, row)``
    runs for fit j once its chunk's rows are read (``i`` the chunk's last
    iteration, ``row`` its metric row); an exception from it ends every
    fit at that chunk boundary and propagates. ``iters_per_sec`` is each
    fit's iterations after the first chunk over the wall time of the
    chunks after the first, as JAX reckons it. The graphs and their memory
    are released on return. Returns one FitResult per method.

    Each fit is a ``fit`` span (``fit``'s, with the fit's ``index``), a
    child of the caller's innermost span, with ``fit``'s children, each
    carrying the ``index``; a fit's ``chunk`` span runs from its first
    replay to its rows' read."""
    if len({m.name for m in methods}) != 1:
        raise ValueError("interleaved fits must share a method")
    num_iter = num_iter + 1
    chunk = chunk_iters or show_every
    k_fits = len(methods)
    h, w = problem.imsize
    mc = problem.mean_ch
    outer = TRACER.current()
    with contextlib.ExitStack() as fit_spans:
        spans = [fit_spans.enter_context(TRACER.span(
                     "fit", parent=outer, index=j,
                     **_fit_attrs(m, compute_dtype, seed)))
                 for j, m in enumerate(methods)]
        preps = []
        for j, m in enumerate(methods):
            with TRACER.span("prepare", parent=spans[j], index=j):
                preps.append(prepare_fit(
                    problem, m, iterations=num_iter, lr=lr, seed=seed,
                    rng=(rngs[j] if rngs is not None
                         else np.random.default_rng(seed)),
                    device=device, compute_dtype=compute_dtype,
                    reparam=reparam))
            spans[j].attrs.update(task=problem.task,
                                  device=str(preps[j].state.flat.device))
        dev = preps[0].state.flat.device
        rows = [np.full((num_iter, 8), np.nan) for _ in range(k_fits)]
        stops = [_EarlyStop(early_stop) if early_stop else None
                 for _ in range(k_fits)]
        executed = [num_iter] * k_fits
        active = [True] * k_fits
        replays = [0] * k_fits
        n_chunks = -(-num_iter // chunk)

        graphs, started = [None] * k_fits, []
        try:
            if dev.type == "cuda" and not eager:
                for j, p in enumerate(preps):
                    with TRACER.span("capture", parent=spans[j],
                                     index=j) as capture_span:
                        graphs[j] = capture_step(p.step, p.state, p.generator)
                    started.append(capture_span.start_ns)
            warmup_steps = 0 if graphs[0] is None else 2  # per variant and fit
            chunk_marks = [_chunk_marks(p, dev) for p in preps]
            chunks = [[] for _ in range(k_fits)]
            for s in range(n_chunks):
                start = s * chunk
                end = min(start + chunk, num_iter)
                running = [j for j in range(k_fits) if active[j]]
                opened = {}
                for j in running:
                    opened[j] = TRACER.start("chunk", parent=spans[j],
                                             index=j, first=start,
                                             last=end - 1)
                    replays[j] += _run_chunk(preps[j], graphs[j], start, end,
                                             metrics_every, opened[j],
                                             chunk_marks[j])
                    spans[j].attrs.update(executed=end, replays=replays[j])
                for j in running:
                    # blocks until fit j's chunk is done; the later fits' run
                    # on
                    _read_rows(preps[j], rows[j], start, end, opened[j],
                               chunk_marks[j])
                    chunks[j].append(TRACER.finish(opened[j]))
                    if (stops[j] is not None
                            and stops[j].should_stop(rows[j][start:end, 4],
                                                     start)):
                        active[j] = False
                        executed[j] = end
                    if log_fn is not None:
                        log_fn(j, end - 1, rows[j][end - 1])
                if not any(active):
                    break
        finally:
            _sync(dev)
            graphs = None          # frees the graphs and their memory pools

    starts = started + [c[0].start_ns for c in chunks]
    first_ends = [c[0].end_ns for c in chunks]
    ends = [c[-1].end_ns for c in chunks]
    first_iters = min(chunk, num_iter)
    empty = np.zeros((0, mc, h, w), np.float32)
    results = []
    for j, prep in enumerate(preps):
        psnrs = rows[j][:, 2:5]
        valid = np.where(np.isfinite(psnrs[:, 2]))[0]
        results.append(FitResult(
            mse_corrupted=rows[j][:, 0], mse_gt=rows[j][:, 1], psnrs=psnrs,
            ssims=rows[j][:, 5:8], recons=empty, uncerts_epi=empty,
            uncerts_ale=empty,
            params={k: t.detach().cpu().numpy() for k, t in
                    prep.params.with_flat(prep.state.flat).leaves().items()},
            net_input=prep.net_input,
            final_psnr=(float(psnrs[valid[-1], 2]) if len(valid)
                        else float("nan")),
            executed=executed[j], replays=replays[j],
            warmup_steps=warmup_steps,
            **_clocks(starts, first_ends, ends, executed[j] - first_iters)))
    return results
