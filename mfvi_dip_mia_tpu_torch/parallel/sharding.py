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
  * ``build_sharded_sweep_step`` / ``sweep_placement`` — the cand x mc
    ELBO step that averages S stochastic forwards per candidate, placed as
    JAX's shard_map places it: each (cand, mc) entry of the mesh holds a
    replica of its candidate's state and runs its block of samples on its
    own device; the blocks' losses, gradients and output means are copied
    to the candidate's lead entry, averaged there (JAX's ``pmean``) and
    copied back, and every entry updates its own replica. On a mesh that
    names one card several times the step is one CUDA graph, which runs
    every copy that as many cards would; over several cards it runs
    eagerly, and no run has yet made its copies between distinct cards.

  * ``fit_sp`` / ``sp_shardings`` — one fit split by image rows over the
    mesh's ``sp`` axis. GSPMD's partitioning is spelled out in nn/sp.py:
    every activation of the skip net is cut into row blocks, each conv site
    gathers its halo rows from its neighbours, every BatchNorm sums its
    moments over the shards, and the net's output is gathered onto the
    first device, where the loss, the optimizer and the state stay whole.
    On a mesh that names one card several times the split step is one CUDA
    graph, as ``fit``'s; over several cards it runs eagerly.

Across distinct cards none of these has run yet (ROADMAP Queue 1 item 10).
"""

from __future__ import annotations

import contextlib
import math
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
from ..utils import compile_guard
from ..utils.device import local_cards, resolve_device
from ..utils.graphs import capture, capture_stream


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


def sweep_placement(mesh: Mesh) -> list:
    """Where the cand x mc step puts each candidate (sharding.py:146-156):
    ``[(lead, [its mc entries' devices])]``, one pair per entry of the
    mesh's ``cand`` axis, the entries in ``mc`` order and ``lead`` the
    first of them. Candidate c's state and hyperparameters sit on every
    device of its list, as ``P("cand")`` replicates a (C, ...) stack over
    ``mc``; sample key (c, s) of a (C, S) stack on entry s // (S / n_mc),
    as ``P("cand", "mc")`` splits it. A pure function of the mesh: its
    entries are read as they stand (a mesh of ``torch.device("cuda", i)``
    objects is planned without a card). A mesh without an ``mc`` axis has
    one entry a candidate."""
    if "cand" not in mesh.axis_names or not set(mesh.axis_names) <= {
            "cand", "mc"}:
        raise ValueError(f"a cand x mc step needs a 'cand' axis and at most "
                         f"an 'mc' one, not {mesh.axis_names}")
    d = np.moveaxis(mesh.devices, mesh.axis_names.index("cand"), 0)
    d = d.reshape(d.shape[0], -1)
    return [(row[0], list(row)) for row in d]


def _indexed(device: torch.device) -> torch.device:
    """``device`` as one spelling: a card with its ordinal (a bare "cuda"
    is the current card), the CPU without one."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu") if device.type == "cpu" else device


def _on(device: torch.device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


class Replica(NamedTuple):
    """One mesh entry's copy of its candidate's training state."""
    flat: torch.Tensor         # (n,) the [mu | rho | det] parameters
    m: torch.Tensor            # AdamW's moments
    v: torch.Tensor
    count: torch.Tensor        # () int32
    out_avg: torch.Tensor      # (1, n_out, H, W) the EMA

    def clone(self) -> "Replica":
        return Replica(*(t.clone() for t in self))


class ShardedSweepStep:
    """The cand x mc step that ``build_sharded_sweep_step`` returns:
    ``step(state, hp_stack, generators, z, it) -> (state, losses)``.

    Entry (c, b) of the mesh holds a ``Replica`` of candidate c, made once
    on the entry's device from ``state``'s row c on the first call, and
    runs block b of the candidate's samples there: the input jitter from
    the block's first generator (the JAX step's ``keys_local[0]``), each
    sample's RT weights and dropout masks from its own generator, the
    block's loss (mean over its samples, + temp x KL under mfvi) and its
    gradient, and the mean of its outputs. Each entry packs (loss,
    gradient, output mean) into one vector, which is copied into row b of
    an (n_mc, ...) buffer on the candidate's lead entry; the lead takes
    the mean over the rows (JAX's one ``pmean`` over ``mc``,
    sharding.py:123-125) and copies it to every other entry of the
    candidate. Then each entry runs, on its own replica, AdamW at the
    candidate's lr and weight decay, the NaN guard and the EMA (seeded at
    iteration 0: a ``torch.where`` on the iteration, held on each device),
    as each JAX slice does; the replicas stay bit-equal. After the step
    the mc-0 replicas are written back into ``state``.

    Every copy between two entries goes through ``_to_entry``: a
    ``copy_`` into a buffer made with the replicas, also when both entries
    name one device, so a mesh that names one card four times runs every
    copy that four cards would: 2 C (n_mc - 1) a step (``copies``
    counts what ran, as the kernels' launch counters do: a graph's once
    per replay, its eager warm-up's as a step run). No run has yet made these
    copies between distinct cards (ROADMAP Queue 1 item 10).

    When every entry names one card (and not ``eager``), the first call
    warms the step up eagerly on a copy of the replicas (on the thread's
    capture stream, holding the compile lock; the generators then reset)
    and captures it as one CUDA graph with every generator registered,
    the counterpart of JAX's ``@jax.jit``; every call replays it. The
    graph holds the first call's state, generators, ``z`` and
    hyperparameters: another of these in a later call raises ValueError.
    ``eager=True`` runs the same step without a graph and gives the same
    bits. Over several devices the step runs eagerly, as ``fit_sp`` does.
    Nothing is read back to the host inside a step."""

    def __init__(self, problem, method_name: str, mesh: Mesh, reparam: str,
                 eager: bool):
        self.placement = [(_indexed(lead), [_indexed(d) for d in devs])
                          for lead, devs in sweep_placement(mesh)]
        self.n_cand = len(self.placement)
        self.n_mc = len(self.placement[0][1])
        self.device = problem.device
        self.method_name = method_name
        self.reparam = reparam
        self.noise_std = T.REG_NOISE_STD
        entries = {d for _, devs in self.placement for d in devs}
        self.problems = {d: problem_on(problem, d) for d in entries}
        self.card = self.placement[0][0]
        self.graphed = (not eager and len(entries) == 1
                        and self.card.type == "cuda")
        layout = vi.flatten(init_params(problem, Method(method_name), 0))
        self.layout = layout.with_flat(None)
        self.n = n = layout.flat.numel()
        h, w = problem.imsize
        self.out_shape = (1, N_OUT[problem.task], h, w)
        width = 1 + n + math.prod(self.out_shape)
        # the lead's (n_mc, width) rows, and each other entry's send and
        # receive vectors
        self.gather = [torch.empty((self.n_mc, width), device=lead)
                       for lead, _ in self.placement]
        self.send = [[torch.empty(width, device=d) for d in devs[1:]]
                     for _, devs in self.placement]
        self.recv = [[torch.empty(width, device=d) for d in devs[1:]]
                     for _, devs in self.placement]
        self.its = {d: torch.zeros(1, dtype=torch.int64, device=d)
                    for d in entries}
        self.replicas = None       # [c][b] Replica, made on the first call
        self.bound = None          # (state, generators, z, hp_stack)
        self.graph = None          # (graph, launches, copies, means)
        self.copies = 0            # entry copies that ran
        self.steps_run = 0         # calls, plus the graph's warm-up
        self.replays = 0

    def _to_entry(self, src: torch.Tensor, dst: torch.Tensor) -> None:
        """The one copy between two mesh entries (a peer copy between two
        cards)."""
        dst.copy_(src)
        self.copies += 1

    def _check(self, state: SweepState, hp_stack, generators, z) -> None:
        if len(generators) != self.n_cand or len(generators[0]) % self.n_mc:
            raise ValueError(f"{len(generators)} x {len(generators[0])} "
                             f"generators for a {self.n_cand} x {self.n_mc} "
                             "mesh")
        s_local = len(generators[0]) // self.n_mc
        for (_, devs), gens in zip(self.placement, generators):
            for s, gen in enumerate(gens):
                entry = devs[s // s_local]
                if _indexed(gen.device) != entry:
                    raise ValueError(f"sample {s}'s generator lives on "
                                     f"{gen.device}, its mesh entry on "
                                     f"{entry}")
        if self.bound is None:
            return
        if state.params.flat is not self.bound[0].params.flat:
            raise ValueError("the step's replicas were made from another "
                             "state: call it with the state of its first "
                             "call")
        if self.graph is not None and (
                [list(g) for g in generators] != self.bound[1]
                or z is not self.bound[2] or tuple(hp_stack) != self.bound[3]):
            raise ValueError("the step's CUDA graph was captured with other "
                             "generators, z or hyperparameters")

    def _bind(self, state: SweepState, hp_stack, generators, z) -> None:
        if self.graphed and _indexed(z.device) != self.card:
            raise ValueError(f"z lives on {z.device}; the graph runs on "
                             f"{self.card}")
        count, m, v = state.opt_state
        self.replicas = [[Replica(*(t[c].to(d, copy=True) for t in (
            state.params.flat, m, v, count, state.out_avg))) for d in devs]
            for c, (_, devs) in enumerate(self.placement)]
        self.bound = (state, [list(g) for g in generators], z,
                      tuple(hp_stack))

    def _run(self, replicas, hp_stack, generators, zs) -> list:
        """One step's device work on ``replicas``: each candidate's (loss,
        gradient, output mean) averaged over its mc entries, on its lead."""
        n_mc, n = self.n_mc, self.n
        s_local = len(generators[0]) // n_mc
        is_mfvi = self.method_name == "mfvi"
        means = []
        for c, (_, devs) in enumerate(self.placement):
            hp = HyperParams(*(f[c] for f in hp_stack))
            for b, dev in enumerate(devs):
                mine = generators[c][b * s_local:(b + 1) * s_local]
                pack = self.gather[c][0] if b == 0 else self.send[c][b - 1]
                with _on(dev):
                    self._block(replicas[c][b], hp, mine, zs[dev],
                                self.problems[dev], is_mfvi, pack)
                if b:
                    self._to_entry(pack, self.gather[c][b])
            with _on(devs[0]):
                mean = self.gather[c].mean(dim=0)
            for b in range(1, n_mc):
                self._to_entry(mean, self.recv[c][b - 1])
            for b, dev in enumerate(devs):
                red = mean if b == 0 else self.recv[c][b - 1]
                with _on(dev), torch.no_grad():
                    self._update(replicas[c][b], hp, red, n,
                                 self.problems[dev], self.its[dev])
            means.append(mean)
        return means

    def _block(self, rep: Replica, hp: HyperParams, gens, z, problem,
               is_mfvi: bool, pack: torch.Tensor) -> None:
        """One entry's block of samples: (loss, gradient, output mean)
        into ``pack``."""
        p = rep.flat.detach().requires_grad_(True)
        at = self.layout.with_flat(p)
        x = z
        if self.noise_std:
            x = z + self.noise_std * torch.randn(z.shape, generator=gens[0],
                                                 device=z.device)
        losses, outs = [], []
        for gen in gens:
            leaves = (vi.sample_mfvi_tree(at, gen)
                      if is_mfvi and self.reparam != "lrt" else at.leaves())
            out = problem.net(leaves, x, gen, reparam=self.reparam,
                              dropout_p=(hp.dropout_p
                                         if self.method_name == "mcd"
                                         else None)).float()
            losses.append(problem.data_loss(out))
            outs.append(out)
        loss = torch.stack(losses).mean()
        if is_mfvi:
            loss = loss + hp.temp * vi.kl_mfvi(at, 0.0, hp.prior_sigma)
        loss.backward()
        with torch.no_grad():
            torch.cat([loss.detach().reshape(1), p.grad,
                       torch.stack(outs).mean(dim=0).reshape(-1)], out=pack)

    def _update(self, rep: Replica, hp: HyperParams, red: torch.Tensor,
                n: int, problem, it: torch.Tensor) -> None:
        """AdamW, the NaN guard and the EMA of one replica from the mean
        (loss, gradient, output mean) ``red``."""
        loss, grad = red[0], red[1:1 + n]
        new = flat_adamw_update(rep.flat, grad, rep.m, rep.v, rep.count,
                                lr=hp.lr, n_var=self.layout.n_var,
                                weight_decay=hp.weight_decay)
        ok = torch.isfinite(loss)
        for old, upd in zip(rep[:4], new):
            old.copy_(torch.where(ok, upd, old))
        out_t = problem.transform(red[1 + n:].view(self.out_shape))
        rep.out_avg.copy_(torch.where(
            it == 0, out_t,
            rep.out_avg * EXP_WEIGHT + out_t * (1.0 - EXP_WEIGHT)))

    def _capture(self, hp_stack, generators, zs) -> None:
        """Warm the step up on a copy of the replicas, reset the generators,
        and capture it (trainer.py::capture_steps' order)."""
        gens = [g for row in generators for g in row]
        side = capture_stream(self.card)
        with compile_guard.LOCK:
            side.wait_stream(torch.cuda.current_stream(self.card))
            starts = [g.get_state() for g in gens]
            with torch.cuda.stream(side):
                scratch = [[r.clone() for r in row] for row in self.replicas]
                self._run(scratch, hp_stack, generators, zs)
            torch.cuda.current_stream(self.card).wait_stream(side)
            del scratch
            for g, start in zip(gens, starts):
                g.set_state(start)
            self.steps_run += 1
            copies = self.copies
            graph, launches, means = capture(
                lambda: self._run(self.replicas, hp_stack, generators, zs),
                gens, side)
            per_replay, self.copies = self.copies - copies, copies
        self.graph = (graph, launches, per_replay, means)

    def __call__(self, state: SweepState, hp_stack: HyperParams, generators,
                 z: torch.Tensor, it: int):
        self._check(state, hp_stack, generators, z)
        if self.bound is None:
            self._bind(state, hp_stack, generators, z)
        for t in self.its.values():
            t.fill_(it)
        zs = {d: z.to(d) for d in self.its}
        self.steps_run += 1
        if not self.graphed:
            means = self._run(self.replicas, hp_stack, generators, zs)
        else:
            if self.graph is None:
                self._capture(hp_stack, generators, zs)
            graph, launches, copies, means = self.graph
            with _on(self.card):
                graph.replay()
            kernels.add_counts(launches)
            self.copies += copies
            self.replays += 1
        count, m, v = state.opt_state
        with torch.no_grad():
            for c, row in enumerate(self.replicas):
                lead = row[0]
                for dst, src in ((state.params.flat[c], lead.flat),
                                 (m[c], lead.m), (v[c], lead.v),
                                 (count[c], lead.count),
                                 (state.out_avg[c], lead.out_avg)):
                    dst.copy_(src)
            losses = torch.stack([mean[0].to(self.device) for mean in means])
        return state, losses


def build_sharded_sweep_step(problem, method_name: str, n_samples: int,
                             mesh: Mesh, reparam: str = "rt", *,
                             eager: bool = False):
    """One training step of C candidates x S MC samples over ``mesh``
    (sharding.py:75-171): ``step(state, hp_stack, generators, z, it) ->
    (state, losses)``, ``state`` (``init_sweep_state``'s, on the problem's
    device) updated in place, ``losses`` (C,) there. ``generators`` is C
    lists of S torch generators, sample s's on the device of its mesh entry
    (``sweep_placement``; else ValueError naming both); C must be the
    mesh's ``cand`` size and S a multiple of its ``mc`` size. Per
    candidate the mc entries' block losses (+ temp x KL under mfvi),
    gradients and output means are averaged, then AdamW at the candidate's
    lr and weight decay (JAX's ``_build_optimizer(Method(name), 1e-3)``
    with both injected: its analytic KL term has temperature 0, so the
    flat AdamW without it), the NaN guard and the EMA; ``ShardedSweepStep``
    says how the entries run and copy, and when the step is a CUDA graph.
    The problem moves to each entry's device once (``problem_on``).
    ``n_samples`` is taken as JAX's is, and unused. Returns (step,
    {"device", "cand", "mc"})."""
    step = ShardedSweepStep(problem, method_name, mesh, reparam, eager)
    return step, {"device": problem.device, "cand": step.n_cand,
                  "mc": step.n_mc}


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
