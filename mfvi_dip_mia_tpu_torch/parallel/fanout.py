"""Candidate -> device fanout of the BO loop, on one process (counterpart of
mfvi_dip_mia_tpu/parallel/fanout.py's thread-per-candidate mode).

Candidate i runs on ``devices[i % len(devices)]``, one after another in
candidate order, in the calling thread. The JAX package starts a thread per
candidate; here concurrent fits would share the port's process-wide state:
the kernel launch counters that every capture reads and takes back
(ops/kernels: ``counts`` / ``take_counts_since``), the ``device_cache``
tables, the capture stream of each card (utils/graphs.py::capture_stream),
and PyTorch's global capture-error mode. The target is one H100, where the
fits would queue on the card anyway.

A crashed or NaN candidate contributes nothing: it is logged, dropped with
its score (the pairs are filtered together), and the sweep goes on; a
caller that passes ``failures`` gets a record of each drop, so that a crash
can be told from a diverged fit.
"""

from __future__ import annotations

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


def run_candidates(task: str, bayes: str, candidates: Sequence,
                   run_params: dict, devices=None, runner=None,
                   keep_nan: bool = False, use_spmd: bool = False,
                   sp_split: int | bool = False,
                   interleave: str | bool = "auto",
                   failures: list | None = None):
    """Evaluate every candidate; returns (kept_candidates, kept_scores) with
    NaN / crashed candidates dropped (``keep_nan=True``: a score for every
    candidate, NaN where it failed).

    ``devices``: names or ordinals as ``utils/device.py::resolve_device``
    takes them ("tpu:0" and "cuda:0" alike), or None for the card.
    ``runner(idx, device, candidate) -> score`` overrides ``run_task``
    (tests). ``failures``, when given, receives one dict per failed
    candidate: ``index``, ``candidate``, ``crashed`` (an exception, not a
    NaN score) and ``error`` (the traceback, or None).

    The JAX package's SPMD sweep (``use_spmd``), spatial split (``sp_split``)
    and interleaved groups (``interleave=True``) are not ported (ROADMAP
    Queue 1 item 9); "auto" runs the candidates one after another."""
    if use_spmd or sp_split or interleave is True:
        raise NotImplementedError(
            "use_spmd, sp_split and interleave=True are not ported: the "
            "port's fanout runs candidates one after another on one process "
            "(ROADMAP Queue 1 item 9)")
    from ..tasks.runners import run_task
    from ..utils.device import resolve_device

    task = TASK_ALIASES[task]
    devices = [resolve_device(d) for d in (devices or [None])]

    if runner is None:
        def runner(idx, dev, cand):
            return run_task(task, bayes, index=idx, device=dev,
                            **candidate_kwargs(bayes, cand), **run_params)

    results = []
    for i, cand in enumerate(candidates):
        dev = devices[i % len(devices)]
        try:
            y = float(runner(i, dev, cand))
            error = None
        except Exception:
            error = traceback.format_exc()
            print(f"[fanout] candidate {cand} failed on {dev}:\n{error}",
                  flush=True)
            y = float("nan")
        if not np.isfinite(y) and failures is not None:
            failures.append(dict(index=i, candidate=tuple(cand),
                                 crashed=error is not None, error=error))
        results.append(y)

    if keep_nan:
        return ([tuple(np.asarray(c, np.float64)) for c in candidates],
                results)
    kept_c, kept_y = [], []
    for cand, y in zip(candidates, results):
        if np.isfinite(y):
            kept_c.append(tuple(np.asarray(cand, np.float64)))
            kept_y.append(y)
    return kept_c, kept_y
