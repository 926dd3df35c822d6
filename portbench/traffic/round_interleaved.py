"""Traffic 'round_interleaved': a BO round's candidates as the program's
fanout runs them, one call of ``parallel/fanout.py::run_candidates`` with
``interleave="auto"`` on the configuration's ``devices``, plots and saves
off, every fit seeded ``--seed``, as the BO loop calls it for a round.
With more candidates than devices the fanout splits the round into one
group a device (candidates d, d + n, ... on device d of n) and runs each
group on a thread of its own through ``tasks/runners.py::
run_group_interleaved``: each candidate's problem from its own
``default_rng(seed)``, then ``fit_interleaved``: all prepared, then all
captured, then each chunk replays the group's fit 0's chunk, fit 1's, and
so on. The window ends every fit at a chunk boundary.

The harness wraps ``run_group_interleaved`` for the call, to hand the probe
each group's candidates on the group's thread and to pass the window's
``log_fn``, and ``fit_interleaved``, to time each candidate from the call
into the trainer (``t_call``; the problems' build before it is
``problem_s``, as traffic ``fit`` times them).

Workload parameters: ``temp`` and ``sigma``, lists of values; the
candidates are their product in that order, as the BO loop makes its first
round (bo/loop.py, ``itertools.product`` of the axes' candidates).
Configuration key: ``devices``, the names the fanout resolves
(``utils/device.py::resolve_device``); the CPU tests run each on the CPU."""

from __future__ import annotations

import importlib
import itertools
import threading
import time
import traceback

from portbench import fits, harness


def candidates(cell) -> list:
    p = cell.workload["params"]
    return [(float(t), float(s))
            for t, s in itertools.product(p["temp"], p["sigma"])]


def run(run, port) -> None:
    cfg, cands = run.config, run.candidates
    if cfg.get("radon_mode", "auto") != "auto":
        raise ValueError("run_group_interleaved builds its problems with "
                         "the default Radon mode")
    runners = port["tasks.runners"]
    fanout = importlib.import_module(f"{harness.PORT}.parallel.fanout")
    group_fn, fit_fn = runners.run_group_interleaved, runners.fit_interleaved
    points = [(c.temp, c.sigma) for c in cands]
    by_point = {id(p): c for p, c in zip(points, cands)}
    logs = {c.index: run.window.log_fn(c) for c in cands}
    local = threading.local()

    def group_probed(task, method, group, device=None, **kwargs):
        mine = [by_point[id(p)] for p in group]
        local.mine, local.t = mine, time.perf_counter()
        try:
            with fits.assigned(mine):
                return group_fn(task, method, group, device=device,
                                log_fn=lambda j, i, row:
                                logs[mine[j].index](i, row), **kwargs)
        except fits.WindowClosed:
            return [float("nan")] * len(mine)
        except Exception:
            error = traceback.format_exc()
            for c in mine:
                c.error = error
            raise

    def fit_probed(*args, **kwargs):
        t = time.perf_counter()
        for c in local.mine:
            c.t_call = t
        run.setup.setdefault("problem_s", []).append(t - local.t)
        return fit_fn(*args, **kwargs)

    devices = (list(cfg["devices"]) if run.device != "cpu"
               else ["cpu"] * len(cfg["devices"]))
    if len(points) <= len(devices):
        raise ValueError("with no more candidates than devices the fanout "
                         "runs each fit alone, not in a group")
    run_params = dict(img=int(cfg["img"]), num_iter=int(cfg["num_iter"]),
                      lr=float(cfg["lr"]), p_sigma=float(cfg["p_sigma"]),
                      input_depth=int(cfg["input_depth"]), seed=run.seed,
                      show_every=int(cfg["show_every"]),
                      metrics_every=int(cfg["metrics_every"]),
                      chunk_iters=int(cfg["chunk_iters"]),
                      compute_dtype=cfg["compute_dtype"], plot=False,
                      save=False)
    runners.run_group_interleaved = group_probed
    runners.fit_interleaved = fit_probed
    try:
        fanout.run_candidates(cfg["task"], cfg["method"], points, run_params,
                              devices=devices, keep_nan=True,
                              interleave="auto")
    finally:
        runners.run_group_interleaved = group_fn
        runners.fit_interleaved = fit_fn
    failed = next((c.error for c in cands if c.error), None)
    if failed is not None:
        raise RuntimeError(f"an interleaved group failed:\n{failed}")
