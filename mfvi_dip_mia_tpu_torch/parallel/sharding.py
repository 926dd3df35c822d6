"""Candidate-parallel sweeps on a device mesh (counterpart of
mfvi_dip_mia_tpu/parallel/sharding.py).

The JAX package shards a sweep over a mesh of TPU chips with one SPMD
program: the ``cand`` axis splits the BO candidates, the ``mc`` axis the
Monte-Carlo samples of the ELBO-averaging step. Here a mesh is an array of
torch devices with axis names, and the one program becomes CUDA graphs:

  * ``run_sweep_spmd`` / ``build_spmd_chunk`` — C candidate fits split
    into contiguous blocks, one per mesh entry of the ``cand`` axis (as
    ``P("cand")`` splits a (C, ...) stack). Each block's steps are captured
    back to back as one CUDA graph per variant (trainer.py::capture_steps),
    so one replay advances every candidate of the block by one iteration:
    the counterpart of ``lax.map`` in one slice. Every candidate runs the
    trainer's own step on its own state and generator, so its rows are the
    bits of its sequential ``fit``. The candidates' weights are never
    batched into one grouped conv (sharding.py:298). Blocks on different
    cards replay on each card's current stream in turn.
  * ``build_sharded_sweep_step`` — the cand x mc ELBO step that averages S
    stochastic forwards per candidate; on one device the ``mc`` axis runs
    its samples one after another and the mean of the losses, gradients
    and outputs takes the place of JAX's ``pmean``.

  * ``fit_sp`` / ``sp_shardings`` — one fit split by image rows over the
    mesh's ``sp`` axis. GSPMD's partitioning is spelled out in nn/sp.py:
    every activation of the skip net is cut into row blocks, each conv site
    gathers its halo rows from its neighbours, every BatchNorm sums its
    moments over the shards, and the net's output is gathered onto the
    first device, where the loss, the optimizer and the state stay whole.
    On a mesh that names one card several times the split step is one CUDA
    graph, as ``fit``'s; over several cards it runs eagerly.

The sharded step is not ported on a mesh that spans several devices
(ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..bayes import vi
from ..nn.sp import RowSplit
from ..ops import kernels
from ..optim.fused_adamw import flat_adamw_update
from ..tasks import trainer as T
from ..tasks.problems import problem_on
from ..tasks.trainer import (EXP_WEIGHT, N_OUT, HyperParams, Method,
                             StepState, capture_steps, init_params,
                             prepare_fit)
from ..utils.device import local_cards, resolve_device


class Mesh(NamedTuple):
    """A device mesh: ``devices`` (an object array of torch devices in the
    mesh's shape) and one name per axis."""
    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def along(self, name: str) -> list:
        """The devices of axis ``name``, at the first entry of every other
        axis (a ``P(name)`` split replicates over the others)."""
        d = np.moveaxis(self.devices, self.axis_names.index(name), 0)
        return list(d.reshape(d.shape[0], -1)[:, 0])


def make_mesh(n_devices: int | None = None, shape=None,
              names=("cand", "mc"), devices=None) -> Mesh:
    """A mesh of the first ``n_devices`` of ``devices`` (default: every
    card of this process; raises without one), factored as JAX's
    (sharding.py:46-65): a 2-axis mesh candidate-major, a 1-axis mesh all
    devices. ``devices`` may name one device several times (each entry is
    then a slice of it), as the CPU tests do."""
    devs = (local_cards() if devices is None
            else [resolve_device(d) for d in devices])
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"a mesh of {n} devices asked for, {len(devs)} "
                         "given")
    if shape is None:
        if len(names) == 1:
            shape = (n,)
        elif len(names) == 2:
            c = 1
            for d in range(int(np.sqrt(n)), 0, -1):
                if n % d == 0:
                    c = n // d
                    break
            shape = (c, n // c)
        else:
            raise ValueError("provide shape for meshes with >2 axes")
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr.reshape(shape), tuple(names))


def sp_shardings(mesh: Mesh, problem, state) -> dict:
    """The placement of a fit split over ``mesh``'s ``sp`` axis
    (sharding.py:174-229), as the port uses it: ``split``, the net's
    ``RowSplit`` over the axis's devices in mesh order, and ``state``, the
    first of them for every StepState tensor.

    JAX hands GSPMD a per-leaf tree that also splits the EMA, the MC rings,
    the snapshots, the net input, the ground truth and the den / inp target
    by rows, and replicates the parameters and optimizer state; XLA then
    partitions the whole step. Here only the net runs split: its input is
    cut into the shards' rows inside the forward, and its output is
    gathered in row order onto the first device, where the loss (with the
    Radon operator or the x1/4 resize, as JAX keeps the sinogram and the
    low-resolution target replicated), the KL, AdamW, the NaN guard, the
    EMA, the rings and the metric row run as in the unsplit step, on
    tensors that are not split. The parameters have one copy on the first
    device; each shard reads them through ``.to``, and autograd adds the
    shards' gradients, the counterpart of GSPMD's parameter psum. Raises
    ValueError unless each shard's rows are a multiple of 2^n_scales of the
    problem's net, or if the problem lives elsewhere than the first
    device."""
    split = RowSplit.of(mesh.along("sp"), problem.imsize[0],
                        problem.net.n_scales)
    if state.flat.device != split.first:
        raise ValueError(f"the fit's state lives on {state.flat.device}, the "
                         f"mesh's first 'sp' device is {split.first}")
    return {"split": split,
            "state": {f: split.first for f in StepState.__dataclass_fields__}}


def fit_sp(problem, method, *, mesh: Mesh, num_iter: int, lr: float,
           **fit_kwargs):
    """One fit split by rows over ``mesh``'s ``sp`` axis
    (sharding.py:232-249): ``trainer.fit`` on the axis's first device with
    ``shardings`` the callable that gives ``sp_shardings`` the fit's own
    prepared state. The problem moves to that device if it lives elsewhere
    (``problem_on``). The same fit as the unsplit one, up to the order of
    its sums (tests/test_torch_sp_fit.py)."""
    first = RowSplit.of(mesh.along("sp"), problem.imsize[0],
                        problem.net.n_scales).first
    problem = problem_on(problem, first)
    return T.fit(problem, method, num_iter=num_iter, lr=lr, device=first,
                 shardings=lambda state: sp_shardings(mesh, problem, state),
                 **fit_kwargs)


class SweepState(NamedTuple):
    """The training state of C candidates, one row each."""
    params: vi.FlatParams      # its flat buffer (C, n)
    opt_state: tuple           # AdamW's (count (C,) int32, m, v (C, n))
    out_avg: torch.Tensor      # (C, 1, n_out, H, W)


def init_sweep_state(problem, method_name: str, n_candidates: int,
                     seed: int = 0) -> SweepState:
    """The (C, ...) state on the problem's device: candidate i's parameters
    are ``init_params`` at seed ``seed + i`` (sharding.py:379-400)."""
    rows = [vi.flatten(init_params(problem, Method(method_name), seed + i),
                       device=problem.device)
            for i in range(n_candidates)]
    flat = torch.stack([r.flat for r in rows])
    h, w = problem.imsize
    return SweepState(
        rows[0].with_flat(flat),
        (torch.zeros(n_candidates, dtype=torch.int32, device=flat.device),
         torch.zeros_like(flat), torch.zeros_like(flat)),
        torch.zeros((n_candidates, 1, N_OUT[problem.task], h, w),
                    device=flat.device))


def stack_hyperparams(methods, lr: float) -> HyperParams:
    """One HyperParams whose every field holds the C candidates' values."""
    return HyperParams(*zip(*(HyperParams.of(m, lr) for m in methods)))


def build_sharded_sweep_step(problem, method_name: str, n_samples: int,
                             mesh: Mesh, reparam: str = "rt"):
    """One training step of C candidates x S MC samples
    (sharding.py:75-171): ``step(state, hp_stack, generators, z, it) ->
    (state, losses)``, the state updated in place. ``generators`` is C
    lists of S torch generators; C must be the mesh's ``cand`` size and S a
    multiple of its ``mc`` size. The S samples split into one block per
    ``mc`` entry; a block's input jitter comes from its first generator
    (the JAX step's ``keys_local[0]``), each sample's RT weights and
    dropout masks from its own. Per candidate the block losses (+ temp x
    KL under mfvi) and outputs are averaged over the blocks, the gradient
    is that mean's, then AdamW at the candidate's lr and weight decay
    (JAX's ``_build_optimizer(Method(name), 1e-3)`` with both injected: its
    analytic KL term has temperature 0, so the flat AdamW without it), the
    NaN guard and the EMA. ``n_samples`` is taken as JAX's is, and unused.
    Returns (step, {"device", "cand", "mc"}). Every mesh entry must be the
    problem's device: a mesh over several devices is not ported (ROADMAP
    Queue 1 item 10)."""
    if set(mesh.devices.reshape(-1)) != {problem.device}:
        raise NotImplementedError(
            "build_sharded_sweep_step runs on one device (every mesh entry "
            f"{problem.device}); a mesh over several devices is not ported "
            "(ROADMAP Queue 1 item 10)")
    n_cand = mesh.shape["cand"]
    n_mc = mesh.shape.get("mc", 1)
    is_mfvi = method_name == "mfvi"
    noise_std = T.REG_NOISE_STD

    def per_candidate(params: vi.FlatParams, hp: HyperParams, gens, z):
        p = params.flat.detach().requires_grad_(True)
        at = params.with_flat(p)
        s_local = len(gens) // n_mc
        block_losses, block_outs = [], []
        for b in range(n_mc):
            mine = gens[b * s_local:(b + 1) * s_local]
            x = z
            if noise_std:
                x = z + noise_std * torch.randn(z.shape, generator=mine[0],
                                                device=z.device)
            losses, outs = [], []
            for gen in mine:
                leaves = (vi.sample_mfvi_tree(at, gen)
                          if is_mfvi and reparam != "lrt" else at.leaves())
                out = problem.net(leaves, x, gen, reparam=reparam,
                                  dropout_p=(hp.dropout_p
                                             if method_name == "mcd"
                                             else None)).float()
                losses.append(problem.data_loss(out))
                outs.append(out)
            loss = torch.stack(losses).mean()
            if is_mfvi:
                loss = loss + hp.temp * vi.kl_mfvi(at, 0.0, hp.prior_sigma)
            block_losses.append(loss)
            block_outs.append(torch.stack(outs).mean(dim=0))
        loss = torch.stack(block_losses).mean()
        loss.backward()
        return loss.detach(), p.grad, torch.stack(block_outs).mean(dim=0)

    def step(state: SweepState, hp_stack: HyperParams, generators, z, it):
        if len(generators) != n_cand or len(generators[0]) % n_mc:
            raise ValueError(f"{len(generators)} x {len(generators[0])} "
                             f"generators for a {n_cand} x {n_mc} mesh")
        count, m, v = state.opt_state
        losses = []
        for c in range(n_cand):
            hp = HyperParams(*(f[c] for f in hp_stack))
            flat = state.params.flat[c]
            loss, grad, out_mean = per_candidate(
                state.params.with_flat(flat), hp, generators[c], z)
            with torch.no_grad():
                new = flat_adamw_update(flat, grad, m[c], v[c], count[c],
                                        lr=hp.lr, n_var=state.params.n_var,
                                        weight_decay=hp.weight_decay)
                ok = torch.isfinite(loss)
                for old, upd in zip((flat, m[c], v[c], count[c]), new):
                    old.copy_(torch.where(ok, upd, old))
                out_t = problem.transform(out_mean)
                avg = state.out_avg[c]
                avg.copy_(out_t if it == 0
                          else avg * EXP_WEIGHT + out_t * (1.0 - EXP_WEIGHT))
            losses.append(loss)
        return state, torch.stack(losses)

    return step, {"device": problem.device, "cand": n_cand, "mc": n_mc}


def _blocks(n_cand: int, mesh: Mesh) -> list:
    """[(device, candidate indices)]: contiguous blocks of the C candidates,
    one per entry of the mesh's ``cand`` axis, as ``P("cand")`` splits a
    (C, ...) stack (C must divide evenly, as there)."""
    devices = mesh.along("cand")
    if n_cand % len(devices):
        raise ValueError(f"{n_cand} candidates do not split evenly over a "
                         f"'cand' axis of {len(devices)}")
    per = n_cand // len(devices)
    return [(d, list(range(i * per, (i + 1) * per)))
            for i, d in enumerate(devices)]


def build_spmd_chunk(preps: list, mesh: Mesh, *, metrics_every: int = 1):
    """The candidates' fits (``prepare_fit`` results, candidate i on its
    block's device) advanced together (sharding.py:252-333): returns
    ``run(start, end)``, which runs iterations [start, end) of every
    candidate. On a card each block's steps are one CUDA graph per variant
    (``capture_steps``) and an iteration is one replay per block, its
    launches counted once per replay; on the CPU the block's steps run
    eagerly, one after another. The graphs live as long as ``run``."""
    blocks = []
    for dev, idx in _blocks(len(preps), mesh):
        fits = [(preps[i].step, preps[i].state, preps[i].generator)
                for i in idx]
        blocks.append((dev, capture_steps(fits) if dev.type == "cuda"
                       else None, fits))

    def run(start: int, end: int) -> None:
        for it in range(start, end):
            with_metrics = it % metrics_every == 0
            for dev, graphs, fits in blocks:
                if graphs is None:
                    for step, state, _ in fits:
                        step(state, with_metrics)
                    continue
                graph, launches = graphs[with_metrics]
                with torch.cuda.device(dev):
                    graph.replay()
                kernels.add_counts(launches)

    return run


def run_sweep_spmd(problem, methods, *, lr: float, num_iter: int,
                   seed: int = 42, show_every: int = 100,
                   metrics_every: int = 1, chunk_iters=None,
                   mesh: Mesh | None = None, reparam: str = "rt",
                   compute_dtype=None, layout: str = "nhwc"):
    """Run len(methods) candidate fits (one method name) as one program
    over ``mesh``'s ``cand`` axis (sharding.py:336-376; default: a 1-axis
    mesh of min(cards, C) cards). Candidate i's state is ``prepare_fit(...,
    seed=seed)`` with ``default_rng(seed)`` on its block's device; the
    host reads every candidate's rows once per ``chunk_iters`` iterations
    (default ``show_every``). ``layout`` is taken and changes nothing.
    Returns (final smoothed PSNRs, psnrs (C, N, 3)), NaN for a diverged
    candidate; each candidate's rows are the bits of its sequential
    ``fit``."""
    if len({m.name for m in methods}) != 1:
        raise ValueError("the candidates of one program must share a method")
    n_cand = len(methods)
    num_iter = num_iter + 1
    if mesh is None:
        cards = local_cards()
        mesh = make_mesh(min(len(cards), n_cand), names=("cand",),
                         devices=cards)
    placed = {}
    preps = []
    for (dev, idx) in _blocks(n_cand, mesh):
        if dev not in placed:
            placed[dev] = problem_on(problem, dev)
        preps += [prepare_fit(placed[dev], methods[i], iterations=num_iter,
                              lr=lr, seed=seed,
                              rng=np.random.default_rng(seed), device=dev,
                              compute_dtype=compute_dtype or "f32",
                              reparam=reparam)
                  for i in idx]
    run = build_spmd_chunk(preps, mesh, metrics_every=metrics_every)

    chunk = chunk_iters or show_every
    psnrs = np.full((n_cand, num_iter, 3), np.nan)
    for start in range(0, num_iter, chunk):
        end = min(start + chunk, num_iter)
        run(start, end)
        for c, prep in enumerate(preps):
            psnrs[c, start:end] = prep.state.rows[start:end, 2:5].cpu().numpy()
    del run                    # frees the graphs and their memory pools

    finals = []
    for c in range(n_cand):
        valid = np.where(np.isfinite(psnrs[c, :, 2]))[0]
        finals.append(float(psnrs[c, valid[-1], 2]) if len(valid)
                      else float("nan"))
    return finals, psnrs
