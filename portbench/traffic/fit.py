"""Traffic 'fit': one BO candidate, the program's ``tasks/trainer.py::fit``
at the configuration's budget on the main thread's current stream, as
``run_task`` calls it with plots and saves off (one numpy stream draws the
den noise, then the net input). The window ends it at a chunk boundary.

Workload parameters: none; (temp, sigma) are the configuration's."""

from __future__ import annotations

import time
import traceback

import numpy as np

from portbench import fits


def candidates(cell) -> list:
    cfg = cell.config
    return [(float(cfg["temp"]), float(cfg["sigma"]))]


def fit_candidate(run, port, cand, device) -> float:
    """Build ``cand``'s problem and run its fit until the window closes;
    returns the last smoothed PSNR it reported (NaN if none). Used by the
    traffic kinds that run one fit a thread."""
    cfg, seed = run.config, run.seed
    problems = port["tasks.problems"]
    trainer = port["tasks.trainer"]
    runners = port["tasks.runners"]
    last = [float("nan")]
    log = run.window.log_fn(cand)

    def log_fn(i, row):
        last[0] = float(row[4])
        log(i, row)

    try:
        t = time.perf_counter()
        rng = np.random.default_rng(seed)
        problem = problems.build_problem(
            cfg["task"], cfg["method"], int(cfg["img"]),
            p_sigma=float(cfg["p_sigma"]),
            input_depth=int(cfg["input_depth"]), device=device,
            radon_mode=cfg.get("radon_mode", "auto"), rng=rng)
        method = runners.method_for(cfg["task"], cfg["method"],
                                    {"temp": cand.temp, "sigma": cand.sigma})
        cand.t_call = time.perf_counter()
        run.setup.setdefault("problem_s", []).append(cand.t_call - t)
        try:
            with fits.assigned([cand]):
                trainer.fit(problem, method, num_iter=int(cfg["num_iter"]),
                            lr=float(cfg["lr"]), seed=seed,
                            show_every=int(cfg["show_every"]),
                            device=device,
                            metrics_every=int(cfg["metrics_every"]),
                            compute_dtype=cfg["compute_dtype"],
                            collect_snapshots=False, rng=rng, log_fn=log_fn,
                            chunk_iters=int(cfg["chunk_iters"]))
        except fits.WindowClosed:
            pass
    except Exception:
        cand.error = traceback.format_exc()
        raise
    return last[0]


def run(run, port) -> None:
    fit_candidate(run, port, run.candidates[0], run.device)
