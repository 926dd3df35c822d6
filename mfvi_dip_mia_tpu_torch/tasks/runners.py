"""The 16 ``run_{task}_{method}`` entry points (counterpart of
mfvi_dip_mia_tpu/tasks/runners.py), each a thin closure over ``run_task``,
and ``run_group_interleaved``, which fits several same-method BO candidates
on one device at once (``fit_interleaved``).

A run creates ``save_path/<timestamp>/`` with ``locals.txt``, fits, takes a
25-sample MC posterior summary from the final parameters (every method but
dip, runners.py:179), optionally plots, writes ``save.npz`` in the
reference's per-task key schema, and returns the final
smoothed-reconstruction PSNR (the BO objective). All 16 (task, method)
pairs run; ``early_stop`` goes to ``fit`` (runners.py:162). On the card a
run works on its thread's own stream (utils/graphs.py::own_stream), so runs
on several threads (parallel/fanout.py) overlap on one card.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from ..bayes import vi
from ..bayes.uncertainty import mc_predict, uncert_regression_gal
from ..ops.metrics import psnr, ssim
from ..utils.config import dump_locals
from ..utils.device import resolve_device
from ..utils.graphs import own_stream
from .problems import METHODS, build_problem
from .trainer import Method, fit, fit_interleaved

MC_SAMPLES = 25


def method_for(task: str, method_name: str, overrides: dict) -> Method:
    """The Method a ``run_task`` call with these kwargs uses, with the
    reference's weight-decay quirks (ct and dip/mfvi zero it)."""
    kw = dict(temp=4e-6, sigma=0.01, dropout_p=0.3, weight_decay=3e-4,
              gamma=0.9999)
    kw.update(overrides)
    if task == "ct" or method_name in ("dip", "mfvi"):
        kw["weight_decay"] = 0.0
    return Method(name=method_name, **kw)


def _npz_payload(task, problem, res, method_name):
    """save.npz with the reference's per-task key schema."""
    d = {
        "mse_gt": {method_name: res.mse_gt},
        "recons": {method_name: res.recons},
        "uncerts": {method_name: res.uncerts_epi},
        "uncerts_ale": {method_name: res.uncerts_ale},
        "psnrs": {method_name: res.psnrs},
        "ssims": {method_name: res.ssims},
    }
    if task == "den":
        d.update(img_gt=problem.gt_np, img_noisy=problem.target_np,
                 mse_noisy={method_name: res.mse_corrupted})
    elif task == "ct":
        d.update(img_gt=problem.gt_np[None], img_radon=problem.target_np[None],
                 mse_noisy={method_name: res.mse_corrupted})
    elif task == "sr":
        d.update(img_hr=problem.gt_np, img_lr=np.squeeze(problem.target_np),
                 mse_noisy={method_name: res.mse_corrupted})
    elif task == "inp":
        d.update(img_inpainting=problem.gt_np, img_mask=problem.target_np,
                 mse_corrupted={method_name: res.mse_corrupted})
    return d


def mc_summary(problem, params: dict, net_input: np.ndarray, seed: int,
               n_samples: int = MC_SAMPLES, reparam: str = "rt",
               dropout_p=None) -> dict:
    """The posterior-predictive summary of a fit: ``n_samples`` stochastic
    forwards of the final parameters (RT draws, or LRT activation noise with
    ``reparam='lrt'``, or dropout masks at ``dropout_p`` on an mcd net; a
    deterministic net without dropout gives equal samples) from a generator
    seeded ``seed`` (the runner passes seed + 77, as JAX's PRNGKey(seed +
    77)), transformed and decomposed.
    Returns the mean reconstruction clipped to [0, 1] and its PSNR / SSIM,
    and the aleatoric / epistemic maps, each (C, H, W): the problem's
    ``mean_ch`` mean channels (3 for inp), the rest its neg-logvar."""
    dev = problem.device
    flat = vi.flatten({k: torch.from_numpy(v) for k, v in params.items()},
                      device=dev)
    x = torch.from_numpy(net_input).permute(0, 3, 1, 2).contiguous().to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def apply_fn(leaves, x, generator, **kw):
        return problem.net(leaves, x, generator, dropout_p=dropout_p, **kw)

    outs = mc_predict(apply_fn, flat, x, gen, n_samples, reparam=reparam)
    outs = problem.transform(outs[:, 0])[:, None]
    mean, ale, epi = uncert_regression_gal(outs, problem.mean_ch)
    mean_c = torch.clamp(mean, 0, 1)
    return dict(mc_mean_recon=mean_c[0].cpu().numpy(),
                mc_mean_psnr=float(psnr(problem.gt, mean_c)),
                mc_mean_ssim=float(ssim(problem.gt, mean_c)),
                mc_ale=ale[0].cpu().numpy(), mc_epi=epi[0].cpu().numpy())


def run_task(task: str, method_name: str, *, img: int = 0,
             num_iter: int = 5000, lr: float = 3e-4, temp: float = 4e-6,
             sigma: float = 0.01, dropout_p: float = 0.3,
             weight_decay: float = 3e-4, gamma: float = 0.9999,
             p_sigma: float = 0.1, input_depth: int = 16, device=None,
             index: int = 0, seed: int = 42, show_every: int = 100,
             plot: bool = True, save: bool = True, save_path: str = "./logs",
             log_every_chunk: bool = False, metrics_every: int = 1,
             chunk_iters=None, early_stop=None, compute_dtype=None,
             layout: str = "nhwc", **kwargs) -> float:
    """Generic runner; the 16 named wrappers below pin (task, method).

    ``device`` defaults to the card (utils/device.py::resolve_device; an int,
    "cuda:1" or "tpu:3" names a CUDA ordinal modulo the card count) and
    raises without one; ``device="cpu"`` runs the plain path.
    ``chunk_iters`` goes to ``fit``: the iterations (graph replays on the
    card) between host reads of the metric rows, default ``show_every``;
    another length needs ``plot=False, save=False``. ``layout``, the JAX
    trainer's NHWC / channels-first knob, is taken so that
    ``configs/*.json`` run_params pass unchanged, and changes nothing: the
    port is NCHW. ``compute_dtype`` is 'f32' (default) or 'bf16'.
    ``early_stop={'patience': iters, 'min_delta': dB}`` stops the fit once
    its smoothed PSNR plateaus (trainer.py::fit)."""
    from ..utils import viz

    # reference quirks: ct and dip/mfvi runners zero weight_decay
    if task == "ct" or method_name in ("dip", "mfvi"):
        weight_decay = 0.0
    dev = resolve_device(device)

    timestamp = str(time.time())
    out_dir = None
    if plot or save:
        out_dir = Path(save_path) / timestamp
        out_dir.mkdir(parents=True, exist_ok=False)
        dump_locals(str(out_dir / "locals.txt"), dict(
            task=task, bayes=method_name, img=img, num_iter=num_iter, lr=lr,
            temp=temp, sigma=sigma, dropout_p=dropout_p,
            weight_decay=weight_decay, gamma=gamma, p_sigma=p_sigma,
            input_depth=input_depth, device=str(device), seed=seed,
            show_every=show_every, **kwargs))

    with own_stream(dev):
        # one stream draws the noisy image, then the net input
        rng = np.random.default_rng(seed)
        problem = build_problem(task, method_name, img, p_sigma=p_sigma,
                                input_depth=input_depth, dropout_p=dropout_p,
                                device=dev, rng=rng)
        method = Method(name=method_name, temp=temp, sigma=sigma,
                        dropout_p=dropout_p, weight_decay=weight_decay,
                        gamma=gamma)
        if plot:
            imgs = [problem.gt_np] + ([problem.target_np] if task == "den"
                                      else [])
            viz.plot_image_grid_png(imgs, str(out_dir / "input.png"))

        def log_fn(i, row):
            print(f"[{task}_{method_name} idx={index}] iter {i}: "
                  f"mse={row[0]:.4f} psnr_sm={row[4]:.3f}", flush=True)

        def snapshot_fn(i, recon, epi, ale):
            viz.save_image_png(recon, str(out_dir / "out_avg.png"))
            if method_name != "dip":
                viz.save_normalized_png(epi, str(out_dir / "out_var.png"))
                if problem.has_ale:
                    viz.save_normalized_png(ale,
                                            str(out_dir / "out_ale.png"))

        res = fit(problem, method, num_iter=num_iter, lr=lr, seed=seed,
                  show_every=show_every, rng=rng, device=dev,
                  metrics_every=metrics_every, compute_dtype=compute_dtype,
                  collect_snapshots=(plot or save), chunk_iters=chunk_iters,
                  early_stop=early_stop,
                  log_fn=log_fn if log_every_chunk else None,
                  snapshot_fn=snapshot_fn if plot else None)

        if plot:
            viz.plot_loss(res.mse_corrupted, res.mse_gt, res.psnrs, num_iter,
                          str(out_dir / f"loss_{method_name}.png"),
                          f"MSE {method_name.upper()}")
            with open(out_dir / "locals.txt", "a") as f:
                viz.plot_results({method_name: res.mse_corrupted},
                                 {method_name: res.mse_gt},
                                 {method_name: res.psnrs},
                                 {method_name: res.ssims}, str(out_dir),
                                 file=f)
        summary = {}
        if method_name != "dip":
            summary = mc_summary(
                problem, res.params, res.net_input, seed + 77,
                dropout_p=dropout_p if method_name == "mcd" else None)

    if save:
        np.savez(str(out_dir / "save.npz"),
                 **_npz_payload(task, problem, res, method_name), **summary)
    return res.final_psnr


def run_group_interleaved(task: str, method_name: str, candidates,
                          device=None, *, img: int = 0, num_iter: int = 5000,
                          lr: float = 3e-4, p_sigma: float = 0.1,
                          input_depth: int = 16, seed: int = 42,
                          show_every: int = 100, metrics_every: int = 1,
                          chunk_iters=None, early_stop=None,
                          compute_dtype=None, plot: bool = False,
                          save: bool = False, save_path: str = "./logs",
                          **kwargs) -> list:
    """Several same-method BO candidates on one device (default: the card)
    through ``fit_interleaved`` (runners.py:213-289). Each candidate's
    problem is built from its own ``default_rng(seed)``, so each fit's net
    input stream is the one ``run_task`` would hand it, and each score is
    the bit-identical final smoothed PSNR of that candidate's ``run_task``
    (NaN where a fit diverged). No MC summary runs. With ``plot`` / ``save``
    each candidate gets a ``{time}_{i}`` directory with ``locals.txt``
    (``interleaved=True``), ``save.npz`` without the MC summary's keys
    (``save``) and the loss plot (``plot``). Other keywords of the config's
    run_params (``layout``, ``index``, ...) are taken and change nothing."""
    from ..parallel.fanout import candidate_kwargs
    from ..utils import viz

    dev = resolve_device(device)
    with own_stream(dev):
        methods, rngs = [], []
        for cand in candidates:
            rng = np.random.default_rng(seed)
            overrides = candidate_kwargs(method_name, cand)
            problem = build_problem(task, method_name, img, p_sigma=p_sigma,
                                    input_depth=input_depth,
                                    dropout_p=overrides.get("dropout_p", 0.3),
                                    device=dev, rng=rng)
            methods.append(method_for(task, method_name, overrides))
            rngs.append(rng)
        results = fit_interleaved(
            problem, methods, num_iter=num_iter, lr=lr, seed=seed, rngs=rngs,
            show_every=show_every, metrics_every=metrics_every,
            chunk_iters=chunk_iters, device=dev, early_stop=early_stop,
            compute_dtype=compute_dtype)

    if plot or save:
        for i, (cand, res) in enumerate(zip(candidates, results)):
            # suffixed: two groups of one sweep can share a clock tick
            out_dir = Path(save_path) / f"{time.time()}_{i}"
            out_dir.mkdir(parents=True, exist_ok=False)
            dump_locals(str(out_dir / "locals.txt"), dict(
                task=task, bayes=method_name, img=img, num_iter=num_iter,
                lr=lr, seed=seed, device=str(dev), interleaved=True,
                **candidate_kwargs(method_name, cand)))
            if save:
                np.savez(str(out_dir / "save.npz"),
                         **_npz_payload(task, problem, res, method_name))
            if plot:
                viz.plot_loss(res.mse_corrupted, res.mse_gt, res.psnrs,
                              num_iter,
                              str(out_dir / f"loss_{method_name}.png"),
                              f"MSE {method_name.upper()}")
    return [res.final_psnr for res in results]


def _make_runner(task, method):
    def runner(img: int = 0, device=None, index: int = 0, **kwargs) -> float:
        return run_task(task, method, img=img, device=device, index=index,
                        **kwargs)
    runner.__name__ = f"run_{task}_{method}"
    runner.__doc__ = (f"{task} task with {method} inference "
                      f"(parity: reference run_{task}_{method})")
    return runner


_TASKS = ("ct", "den", "sr", "inp")

for _t in _TASKS:
    for _m in METHODS:
        globals()[f"run_{_t}_{_m}"] = _make_runner(_t, _m)

ALL_RUNNERS = {f"run_{t}_{m}": globals()[f"run_{t}_{m}"]
               for t in _TASKS for m in METHODS}
