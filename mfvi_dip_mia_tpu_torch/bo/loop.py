"""The Bayesian-optimization outer loop with round checkpoints and resume
(counterpart of mfvi_dip_mia_tpu/bo/loop.py).

Per round: run the candidates (parallel/fanout.py: interleaved groups on
each card when there are more candidates than cards, else one after
another) -> drop NaN -> accumulate (X, Y) -> fit the exact GP on the host
CPU -> EI grid + peak search + L-BFGS-B refinement -> next candidates ->
save ``{round}_fig_data.npz`` (the reference's BO-state artifact) and
optionally the 4 diagnostic figures.

In a ``torch.distributed`` group of more than one process (cli.py's
``--dist-*`` flags) every process runs this same loop, the candidates are
split across the processes (parallel/multihost.py), and only rank 0 prints
and writes artifacts.

``resume=True`` reloads the observed (X, Y) and the next candidates from the
highest-numbered ``*_fig_data.npz`` in ``bo_results_path`` and continues;
in a group every process must resolve the same round.
"""

from __future__ import annotations

import glob
import itertools
import json
import os
import re
import warnings
from pathlib import Path

import numpy as np

from ..parallel import fanout
from ..parallel.fanout import TASK_ALIASES
from ..parallel.multihost import (check_resume_consistency,
                                  run_candidates_multihost)
from .acquisition import find_candidates
from .gp import train_gp
from .normalize import normalize_X, unnormalize_X


def _fanout_and_rank():
    """(fanout function, whether this process prints and writes
    artifacts), as JAX's loop.py:31-42: in a process group of more than one
    the multi-process fanout and rank 0; otherwise ``fanout.run_candidates``
    (looked up at call time, so tests can monkeypatch it) and True."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and (
            dist.get_world_size() > 1):
        return run_candidates_multihost, dist.get_rank() == 0
    return fanout.run_candidates, True


def _grid(p1_logbounds, p2_logbounds, n=100):
    x1 = np.logspace(p1_logbounds[0], p1_logbounds[1], n)
    x2 = np.logspace(p2_logbounds[0], p2_logbounds[1], n)
    xx1, xx2 = np.meshgrid(x1, x2, indexing="ij")  # torch.meshgrid default
    grid = np.stack([xx1.reshape(-1), xx2.reshape(-1)], axis=1)
    return xx1, xx2, grid


def _load_resume_state(bo_out_path):
    files = glob.glob(os.path.join(bo_out_path, "*_fig_data.npz"))
    rounds = [(int(m.group(1)), f) for f in files
              if (m := re.match(r"(\d+)_fig_data", os.path.basename(f)))]
    if not rounds:
        return None
    k, path = max(rounds)
    z = np.load(path)
    return {
        "round": k + 1,
        "X": [tuple(row) for row in z["observed_X"]],
        "Y": list(z["observed_Y"]),
        "candidates": [tuple(row) for row in z["candidates"]],
    }


def _require_matplotlib(wanted: bool) -> None:
    """With plots asked for, fail before the first fit when matplotlib is
    missing: each candidate's runner would otherwise fail, be dropped as
    NaN, and the sweep end on "all candidates failed"."""
    if wanted:
        try:
            import matplotlib  # noqa: F401
        except ImportError as e:
            raise RuntimeError(
                "plots are asked for (plot=True or run_params['plot']) but "
                "matplotlib is not importable; turn plotting off (--no-plot "
                "and \"plot\": false in the config)") from e


def evaluate_candidates(task, bayes, bo_params, run_params, runner=None):
    """Single-round fixed-candidate evaluation (the reference's
    eval_result.py). Returns (candidates, psnrs) and prints the table."""
    run_params = dict(run_params)
    run_params.pop("bo_results_path", None)
    devices = run_params.pop("devices", None)
    _require_matplotlib(runner is None and run_params.get("plot", True))
    names = list(bo_params.keys())
    candidates = list(itertools.product(
        *[v["candidates"] for v in bo_params.values()]))
    fanout_fn, is_main = _fanout_and_rank()
    kept_c, kept_y = fanout_fn(task, bayes, candidates, run_params, devices,
                               runner=runner)
    if is_main:
        print()
        print(f"{names[0]}      {names[1] if len(names) > 1 else ''}"
              "       psnr")
        for c, y in zip(kept_c, kept_y):
            print("  ".join(f"{v:.6f}" for v in c) + f"  {y:.6f}")
    return kept_c, kept_y


def bo(task: str, bayes: str, bo_params: dict, run_params: dict,
       n_rounds: int = 20, acq_fn: str = "ei", plot: bool = True,
       resume: bool = False, runner=None, gp_iters: int = 2000,
       use_spmd: bool = False, sp_split: int | bool = False,
       screen_iters: int | None = None):
    """Run the BO sweep. Returns (X, Y): the candidates observed in every
    round and their scores (at the screened budget under ``screen_iters``).

    ``screen_iters`` (opt-in): every round's fits run at this reduced
    budget, and the GP is fit on those screened scores. After the rounds the
    best candidate is confirmed by ONE fit at the full
    ``run_params["num_iter"]`` budget. That confirmed row is written to
    ``screen_confirm.json`` (screen_iters, full_iters, best_candidate,
    screened_psnr, confirmed_psnr) and is neither returned nor appended to
    (X, Y), which stay at one budget. A resumed sweep skips the confirm
    only when ``screen_confirm.json`` records the same best candidate and
    budgets; the JAX loop skips whenever the file exists.

    ``use_spmd=True`` runs each round's candidates as one program over a
    device mesh (parallel/sharding.py::run_sweep_spmd); ``sp_split`` routes
    as ``fanout.run_candidates`` says (each candidate's fit split by rows
    over its own sub-mesh of ``run_params["devices"]``).

    In a process group of more than one (parallel/multihost.py) the
    candidates are split across the processes and only rank 0 prints and
    writes ``bo_results_path``'s files; a resumed sweep checks that every
    process resolved the same round."""
    task = TASK_ALIASES[task]
    run_params = dict(run_params)
    bo_out_path = run_params.pop("bo_results_path")
    devices = run_params.pop("devices", None)
    # run_task plots unless run_params say otherwise
    _require_matplotlib(plot or (runner is None
                                 and run_params.get("plot", True)))
    Path(bo_out_path).mkdir(parents=True, exist_ok=True)
    full_iters = run_params.get("num_iter", 5000)
    if screen_iters is not None:
        if screen_iters >= full_iters:
            raise ValueError(f"screen_iters={screen_iters} must be < "
                             f"num_iter={full_iters}")
        if screen_iters < 0.4 * full_iters:
            # the ranking-stability evidence of the JAX package's sweeps
            # starts at 40 % of the full budget
            warnings.warn(
                f"screen_iters={screen_iters} is below the measured "
                f"ranking-stability floor of 0.4*num_iter="
                f"{int(0.4 * full_iters)} (bo_results/mfvi_ct_timed/"
                "rank_vs_budget.json); screened observations may reorder "
                "vs the full budget", stacklevel=2)
        run_params["num_iter"] = int(screen_iters)

    (p1_logbounds, p2_logbounds) = [v["logbounds"] for v in bo_params.values()]
    xx1, xx2, grid_unnorm = _grid(p1_logbounds, p2_logbounds)
    grid_norm = normalize_X(grid_unnorm, p1_logbounds, p2_logbounds)

    candidates = list(itertools.product(
        *[v["candidates"] for v in bo_params.values()]))
    X, Y = [], []
    start_round = 0
    fanout_fn, is_main = _fanout_and_rank()

    if resume:
        state = _load_resume_state(bo_out_path)
        if state is not None:
            X, Y = state["X"], state["Y"]
            candidates = state["candidates"]
            start_round = state["round"]
            if is_main:
                print(f"[bo] resuming from round {start_round} "
                      f"({len(X)} observations)")
        check_resume_consistency(start_round)

    names = list(bo_params.keys())
    for runs_num in range(start_round, n_rounds):
        kept_c, kept_y = fanout_fn(
            task, bayes, candidates, run_params, devices, runner=runner,
            use_spmd=use_spmd, sp_split=sp_split)
        if is_main:
            print()
            print(f"{names[0]}      {names[1]}       psnr")
            for c, y in zip(kept_c, kept_y):
                print(f"{c[0]:.6f}  {c[1]:.6f}  {y:.6f}")

        X += kept_c
        Y += kept_y
        if not X:
            raise RuntimeError("all candidates failed in round "
                               f"{runs_num}; nothing to fit")

        x_train = normalize_X(np.asarray(X, np.float64), p1_logbounds,
                              p2_logbounds)
        y_train = np.asarray(Y, np.float64)
        gp = train_gp(x_train, y_train, iter_max=gp_iters)

        cand_norm, exp_imp, acq = find_candidates(gp, grid_norm, x_train,
                                                  acq_fn)
        candidates = [tuple(row) for row in
                      unnormalize_X(cand_norm, p1_logbounds, p2_logbounds)]

        if not is_main:            # rank 0 writes the round's artifacts
            continue
        pred_mean, pred_var = (a.detach().numpy()
                               for a in gp.predict(grid_norm))
        # gpytorch confidence_region width
        confidence = 4.0 * np.sqrt(pred_var)
        np.savez(
            os.path.join(bo_out_path, f"{runs_num}_fig_data.npz"),
            XX_lr=xx1, XX_wd=xx2,
            pred=pred_mean.reshape(100, 100),
            observed_X=np.asarray(X), observed_Y=np.asarray(Y),
            expected_improvement=np.asarray(exp_imp),
            confidence=confidence.reshape(100, 100),
            acq=acq.reshape(100, 100),
            candidates=np.asarray(candidates),
        )
        if plot:
            _round_figures(bo_out_path, runs_num, xx1, xx2,
                           pred_mean.reshape(100, 100),
                           confidence.reshape(100, 100),
                           acq.reshape(100, 100), np.asarray(X),
                           np.asarray(candidates), exp_imp)
        print(f"[bo] round {runs_num} done: best psnr so far "
              f"{max(Y):.3f}; gp {gp.hyperparams}")

    if screen_iters is not None and X:
        _screen_confirm(task, bayes, X, Y, run_params, devices, runner,
                        int(screen_iters), int(full_iters),
                        os.path.join(bo_out_path, "screen_confirm.json"),
                        fanout_fn, is_main)
    return X, Y


def _screen_confirm(task, bayes, X, Y, run_params, devices, runner,
                    screen_iters: int, full_iters: int, path: str,
                    fanout_fn, is_main: bool) -> None:
    """Confirm the screened winner with one fit at the full budget and
    record it in ``path``, unless ``path`` already records this winner at
    these budgets. Every process of a group takes part in the confirming
    fanout; ``is_main`` prints and writes."""
    best_idx = int(np.argmax(Y))
    best_cand = [float(v) for v in X[best_idx]]
    key = dict(screen_iters=screen_iters, full_iters=full_iters,
               best_candidate=best_cand)
    if os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
        if all(rec.get(k) == v for k, v in key.items()):
            if is_main:
                print(f"[bo] screen confirm of {best_cand} already recorded "
                      f"at {path}; skipping re-confirm")
            return
    confirm_rp = dict(run_params, num_iter=full_iters)
    kept_c, kept_y = fanout_fn(task, bayes, [X[best_idx]], confirm_rp,
                               devices, runner=runner)
    if kept_c and is_main:
        with open(path, "w") as f:
            json.dump(dict(key, screened_psnr=float(Y[best_idx]),
                           confirmed_psnr=float(kept_y[0])), f, indent=2)
        print(f"[bo] screen winner {best_cand} confirmed at {full_iters} "
              f"iters: {kept_y[0]:.3f} (screened {Y[best_idx]:.3f})")


def _round_figures(out, k, xx1, xx2, pred, conf, acq, observed, candidates,
                   exp_imp):
    """The reference's 4 per-round diagnostic figures."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import cm

    def contour(data, points, title, fname, label):
        fig, ax = plt.subplots()
        ln = ax.contourf(xx1, xx2, data)
        if len(points):
            ax.plot(points[:, 0], points[:, 1], "g.", label=label)
        ax.set_title(title)
        fig.colorbar(ln, ax=ax)
        ax.set_xlabel("beta")
        ax.set_ylabel("tau")
        ax.loglog()
        fig.tight_layout()
        fig.savefig(os.path.join(out, fname), bbox_inches="tight")
        plt.close(fig)

    contour(pred, observed, f"{k} mean acc", f"{k}_fig1.pdf", "observed")
    contour(conf, observed, f"{k} uncertainty", f"{k}_fig2.pdf", "observed")
    contour(acq, candidates, f"{k} acq_fun", f"{k}_fig3.pdf", "candidates")

    fig4, ax4 = plt.subplots(subplot_kw={"projection": "3d"})
    ax4.plot_surface(np.log10(xx1), np.log10(xx2), acq, cmap=cm.jet,
                     linewidth=0, antialiased=False)
    if len(candidates):
        ax4.plot(np.log10(candidates[:, 0]), np.log10(candidates[:, 1]),
                 exp_imp, "gx")
    ax4.set_title(f"{k} acq_fun")
    fig4.tight_layout()
    fig4.savefig(os.path.join(out, f"{k}_fig4.pdf"), bbox_inches="tight")
    plt.close(fig4)
