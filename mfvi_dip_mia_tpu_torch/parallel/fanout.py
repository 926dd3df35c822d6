"""Candidate -> device fanout of the BO loop, on one process (counterpart of
mfvi_dip_mia_tpu/parallel/fanout.py).

As JAX's, the fanout starts one *thread* per candidate or candidate group,
round-robined over the devices, and joins them; each thread writes its
score into its candidate's slot. ``run_candidates`` routes as JAX's does
(fanout.py:172-298):

  * with more candidates than devices (``interleave="auto"``; ``True``
    forces it, ``False`` forbids it), and for every method but dip, the
    candidates are grouped round-robin, candidate i onto ``devices[i %
    n]``, and each group runs on a thread of its own as one interleaved
    multi-fit (tasks/runners.py::run_group_interleaved: no MC summary,
    each score bit-identical to the candidate's ``run_task``);
  * ``use_spmd=True`` runs every candidate as one program over a device
    mesh (``run_candidates_spmd``, parallel/sharding.py::run_sweep_spmd),
    in the calling thread;
  * ``sp_split`` takes JAX's routing: with k >= 2 devices for each
    candidate, candidate i's fit is split by rows over its own ``sp``
    sub-mesh ``devices[i*k:(i+1)*k]`` (``_run_candidates_sp``,
    parallel/sharding.py::fit_sp), a thread per candidate; with fewer the
    candidates fall through to the other routes;
  * otherwise candidate i runs through ``run_task`` on ``devices[i % n]``,
    a thread per candidate.

A given ``runner`` ignores ``use_spmd``, ``sp_split`` and ``interleave`` and
runs a thread per candidate, as in JAX. Threads on one card overlap: each
runs its fits on a stream of its own (utils/graphs.py::own_stream), and
their warm-ups and captures go one at a time under the compile lock
(utils/compile_guard.py), the counterpart of JAX's serialized compiles,
while the others replay. Everything that fits share across threads is
safe under them: the launch counters (a capture takes back the launches
on its own stream, ops/kernels), the ``device_cache`` tables (filled once),
the dw ticket buffers (one per stream, never freed under a graph), and
each fit syncs its own stream only (tasks/trainer.py::_sync). A fit's
arithmetic does not depend on what else runs: a candidate's score and rows
are the bits of its run alone. Candidates spread over processes through
parallel/multihost.py.

A crashed or NaN candidate contributes nothing: it is logged, dropped with
its score (the pairs are filtered together), and the other threads go on;
a caller that passes ``failures`` gets a record of each drop, so that a
crash can be told from a diverged fit.
"""

from __future__ import annotations

import threading
import traceback
from typing import Sequence

import numpy as np

TASK_ALIASES = {
    "denoising": "den", "den": "den",
    "inpainting": "inp", "inp": "inp",
    "super-resolution": "sr", "sr": "sr",
    "ct": "ct",
}

_METHOD_AXES = {
    "mfvi": ("temp", "sigma"),
    "mcd": ("dropout_p", "weight_decay"),
    "sgld": ("gamma", "weight_decay"),
    "dip": (),
}


def candidate_kwargs(bayes: str, candidate) -> dict:
    axes = _METHOD_AXES[bayes]
    return {name: float(candidate[i]) for i, name in enumerate(axes)}


def _kept(candidates, scores, keep_nan: bool):
    """(candidates, scores) as tuples and floats, NaN pairs dropped unless
    ``keep_nan``."""
    pairs = [(tuple(np.asarray(c, np.float64)), float(y))
             for c, y in zip(candidates, scores)]
    if not keep_nan:
        pairs = [(c, y) for c, y in pairs if np.isfinite(y)]
    return [c for c, _ in pairs], [y for _, y in pairs]


def run_candidates_spmd(task: str, bayes: str, candidates: Sequence,
                        run_params: dict, keep_nan: bool = False):
    """Every candidate as one program over a device mesh
    (parallel/sharding.py::run_sweep_spmd; fanout.py:48-95). The mesh is
    ``run_params["mesh"]`` or the default one of the cards, and the problem
    is built on its first ``cand`` device with ``build_problem``'s own
    noise stream, as JAX's is. Returns (kept_candidates, kept_scores) with
    NaN candidates dropped and printed (``keep_nan``: every one)."""
    from ..tasks.problems import build_problem
    from ..tasks.runners import method_for
    from .sharding import run_sweep_spmd

    task = TASK_ALIASES[task]
    rp = dict(run_params)
    rp.pop("bo_results_path", None)
    img = rp.pop("img", 0)
    lr = rp.pop("lr", 3e-4)
    num_iter = rp.pop("num_iter", 5000)
    seed = rp.pop("seed", 42)
    build_kw = {k: rp.pop(k) for k in ("p_sigma", "input_depth") if k in rp}
    sweep_kw = {k: rp.pop(k) for k in ("show_every", "metrics_every",
                                       "chunk_iters", "compute_dtype",
                                       "layout", "reparam", "mesh")
                if k in rp}

    methods = [method_for(task, bayes, candidate_kwargs(bayes, c))
               for c in candidates]
    mesh = sweep_kw.get("mesh")
    problem = build_problem(task, bayes, img, device=(
        None if mesh is None else mesh.along("cand")[0]), **build_kw)
    finals, _ = run_sweep_spmd(problem, methods, lr=lr, num_iter=num_iter,
                               seed=seed, **sweep_kw)
    if not keep_nan:
        for cand, y in zip(candidates, finals):
            if not np.isfinite(y):
                print(f"[fanout/spmd] candidate {cand} diverged (NaN); "
                      "dropped", flush=True)
    return _kept(candidates, finals, keep_nan)


def _run_candidates_sp(task: str, bayes: str, candidates: Sequence,
                       run_params: dict, devices, n_sp: int) -> tuple:
    """Each candidate's fit split by rows over its own ``n_sp``-device
    ``sp`` sub-mesh, ``devices[i*n_sp:(i+1)*n_sp]`` (fanout.py:98-170;
    parallel/sharding.py::fit_sp), a thread per candidate, each fit on its
    own stream of its first device. The problem is built once on the first
    device with ``build_problem``'s own noise stream, as JAX's is, and each
    fit takes ``run_params``' seed, without snapshots. Raises ValueError up front when the image height does
    not split into ``n_sp`` shards the net can halve to its deepest scale;
    otherwise a failing candidate is logged and scores NaN. Returns
    (scores, tracebacks: None where the fit returned)."""
    from ..nn.sp import RowSplit
    from ..tasks.problems import build_problem
    from ..tasks.runners import method_for
    from ..utils.graphs import own_stream
    from .sharding import fit_sp, make_mesh

    rp = dict(run_params)
    rp.pop("bo_results_path", None)
    img = rp.pop("img", 0)
    lr = rp.pop("lr", 3e-4)
    num_iter = rp.pop("num_iter", 5000)
    seed = rp.pop("seed", 42)
    build_kw = {k: rp.pop(k) for k in ("p_sigma", "input_depth") if k in rp}
    fit_kw = {k: rp.pop(k) for k in ("show_every", "metrics_every",
                                     "chunk_iters", "compute_dtype")
              if k in rp}
    problem = build_problem(task, bayes, img, device=devices[0], **build_kw)
    RowSplit.check(problem.imsize[0], n_sp, problem.net.n_scales)

    results = [float("nan")] * len(candidates)
    errors = [None] * len(candidates)

    def work(i, cand, group):
        try:
            method = method_for(task, bayes, candidate_kwargs(bayes, cand))
            mesh = make_mesh(n_sp, names=("sp",), devices=group)
            with own_stream(group[0]):
                res = fit_sp(problem, method, mesh=mesh, num_iter=num_iter,
                             lr=lr, seed=seed, collect_snapshots=False,
                             **fit_kw)
            results[i] = float(res.final_psnr)
        except Exception:
            errors[i] = traceback.format_exc()
            print(f"[fanout/sp] candidate {cand} failed on {group}:\n"
                  f"{errors[i]}", flush=True)

    _run_threads(work, [(i, cand, devices[i * n_sp:(i + 1) * n_sp])
                        for i, cand in enumerate(candidates)])
    return results, errors


def _run_threads(target, jobs) -> None:
    """``target(*job)`` on a thread of its own for every job, all started,
    then all joined (fanout.py:152-159, :255-264, :279-287)."""
    threads = [threading.Thread(target=target, args=job, daemon=True)
               for job in jobs]
    for t in threads:
        t.start()
    for t in threads:
        t.join()


def run_candidates(task: str, bayes: str, candidates: Sequence,
                   run_params: dict, devices=None, runner=None,
                   keep_nan: bool = False, use_spmd: bool = False,
                   sp_split: int | bool = False,
                   interleave: str | bool = "auto",
                   failures: list | None = None):
    """Evaluate every candidate concurrently, a thread per candidate or
    group; returns (kept_candidates, kept_scores) in candidate order with
    NaN / crashed candidates dropped (``keep_nan=True``: a score for every
    candidate, NaN where it failed).

    ``devices``: names or ordinals as ``utils/device.py::resolve_device``
    takes them ("tpu:0" and "cuda:0" alike), or None for every card of this
    process. ``runner(idx, device, candidate) -> score`` overrides
    ``run_task`` (tests). ``use_spmd``, ``sp_split`` and ``interleave``
    route as the module docstring says. ``failures``, when given, receives
    one dict per failed candidate: ``index``, ``candidate``, ``crashed``
    (an exception, not a NaN score) and ``error`` (the traceback, or
    None)."""
    from ..tasks.runners import run_group_interleaved, run_task
    from ..utils.device import local_cards, resolve_device

    task = TASK_ALIASES[task]
    results = [float("nan")] * len(candidates)
    errors = [None] * len(candidates)

    if use_spmd and runner is None:
        _, results = run_candidates_spmd(task, bayes, candidates, run_params,
                                         keep_nan=True)
        return _record(candidates, results, errors, keep_nan, failures)

    devices = ([resolve_device(d) for d in devices] if devices
               else local_cards())
    if sp_split and runner is None:
        n_sp = (len(devices) // max(1, len(candidates))
                if isinstance(sp_split, bool) else int(sp_split))
        if n_sp >= 2 and n_sp * len(candidates) <= len(devices):
            results, errors = _run_candidates_sp(task, bayes, candidates,
                                                 run_params, devices, n_sp)
            return _record(candidates, results, errors, keep_nan, failures)
        # fewer than two devices a candidate: the standard dispatch

    if (runner is None and bayes != "dip"
            and (interleave is True
                 or (interleave == "auto"
                     and len(candidates) > len(devices)))):
        def work_group(dev, idxs):
            try:
                scores = run_group_interleaved(
                    task, bayes, [candidates[i] for i in idxs], device=dev,
                    **run_params)
                for i, y in zip(idxs, scores):
                    results[i] = float(y)
            except Exception:
                error = traceback.format_exc()
                print(f"[fanout] interleaved group {idxs} failed on {dev}:\n"
                      f"{error}", flush=True)
                for i in idxs:
                    errors[i] = error

        groups = [(dev, list(range(d, len(candidates), len(devices))))
                  for d, dev in enumerate(devices)]
        _run_threads(work_group, [g for g in groups if g[1]])
        return _record(candidates, results, errors, keep_nan, failures)

    if runner is None:
        def runner(idx, dev, cand):
            return run_task(task, bayes, index=idx, device=dev,
                            **candidate_kwargs(bayes, cand), **run_params)

    def work(i, cand, dev):
        try:
            results[i] = float(runner(i, dev, cand))
        except Exception:
            errors[i] = traceback.format_exc()
            print(f"[fanout] candidate {cand} failed on {dev}:\n{errors[i]}",
                  flush=True)

    _run_threads(work, [(i, cand, devices[i % len(devices)])
                        for i, cand in enumerate(candidates)])
    return _record(candidates, results, errors, keep_nan, failures)


def _record(candidates, results, errors, keep_nan, failures):
    """Record each failed candidate in ``failures`` (when given), then
    ``_kept``."""
    if failures is not None:
        for i, (cand, y, error) in enumerate(zip(candidates, results,
                                                 errors)):
            if not np.isfinite(y):
                failures.append(dict(index=i, candidate=tuple(cand),
                                     crashed=error is not None, error=error))
    return _kept(candidates, results, keep_nan)
