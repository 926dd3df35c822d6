"""Scripted evaluation of run artifacts (counterpart of
mfvi_dip_mia_tpu/tasks/evaluation.py): the reference's eval_{task}.ipynb
notebooks as code.

Given one or more ``save.npz`` files (the runners' output, of this package
or of the JAX package: one key schema), produce:
  * PSNR / SSIM summary tables: "converged" = the mean over the final 100
    iterations of the smoothed-recon metric, "early-stop" = its maximum
  * the UCE calibration of the combined aleatoric + epistemic uncertainty
    against the squared error
  * the classical baselines' PSNR / SSIM on the run's own data (wavelet,
    TV and bilateral denoising, bicubic upscaling, FBP)
  * error / uncertainty map PNGs and calibration diagrams (``with_maps``;
    they need matplotlib and PIL, and raise without them)

The metrics and baselines run on ``device``, by default the card
(utils/device.py::resolve_device: it raises without one); the summary
tables are host numpy.

CLI:  python -m mfvi_dip_mia_tpu_torch.tasks.evaluation run1/save.npz
      [run2/save.npz ...] [--task den] [--out report_dir] [--device cpu]
      [--no-maps]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..utils.device import resolve_device

_GT_KEYS = ("img_gt", "img_hr", "img_inpainting")


def _gt(z) -> np.ndarray:
    gt = np.asarray(z[[k for k in _GT_KEYS if k in z][0]], np.float32)
    return gt[0] if gt.ndim == 4 else gt     # ct saves (1, C, H, W)


def summarize_run(npz_path: str, tail: int = 100) -> dict:
    """Per-method converged / early-stop PSNR and SSIM from a save.npz."""
    with np.load(npz_path, allow_pickle=True) as z:
        psnrs, ssims = z["psnrs"].item(), z["ssims"].item()
    out = {}
    for name in psnrs:
        p = np.asarray(psnrs[name])
        s = np.asarray(ssims[name])
        valid = np.isfinite(p[:, 2])
        p_v, s_v = p[valid], s[valid]
        out[name] = {
            "psnr_converged": float(np.mean(p_v[-tail:, 2])),
            "psnr_early_stop": float(np.max(p_v[:, 2])),
            "psnr_early_stop_iter": int(np.nanargmax(
                np.where(np.isfinite(p[:, 2]), p[:, 2], -np.inf))),
            "ssim_converged": float(np.mean(s_v[-tail:, 2])),
            "ssim_early_stop": float(np.max(s_v[:, 2])),
        }
    return out


def calibration_from_run(npz_path: str, n_bins: int = 15,
                         device=None) -> dict:
    """The UCE of each method's final snapshot on ``device``: errors
    (recon - gt)^2, uncertainty aleatoric + epistemic; a method whose maps
    are all zero (dip) has no row."""
    from ..ops.metrics import uce

    dev = resolve_device(device)
    with np.load(npz_path, allow_pickle=True) as z:
        gt = _gt(z)
        recons = z["recons"].item()
        uncerts = z["uncerts"].item()
        uncerts_ale = z["uncerts_ale"].item()
    out = {}
    for name in recons:
        recon = np.asarray(recons[name])[-1]
        epi = np.asarray(uncerts[name])[-1] if name in uncerts else 0.0
        ale = (np.asarray(uncerts_ale[name])[-1]
               if name in uncerts_ale else 0.0)
        total_unc = np.asarray(epi + ale, np.float32)
        if not np.any(total_unc > 0):
            continue
        err = (recon - gt) ** 2
        val, err_b, unc_b, prop = uce(torch.from_numpy(err).to(dev),
                                      torch.from_numpy(total_unc).to(dev),
                                      n_bins=n_bins)
        out[name] = {
            "uce": float(val),
            "err_in_bin": err_b.cpu().numpy().tolist(),
            "uncert_in_bin": unc_b.cpu().numpy().tolist(),
            "prop_in_bin": prop.cpu().numpy().tolist(),
        }
    return out


def classical_baselines(task: str, gt: np.ndarray, corrupted,
                        device=None) -> dict:
    """PSNR / SSIM of the classical methods on the same data on ``device``
    (compare_*.ipynb): den the noisy (C, H, W) image, sr the low-resolution
    one, ct a ((1, C, T, W) sinogram, angles in degrees) pair."""
    from ..ops import classical as C
    from ..ops.metrics import psnr, ssim

    dev = resolve_device(device)
    ref = torch.from_numpy(np.asarray(gt, np.float32)).to(dev)[None]

    def score(rec: torch.Tensor) -> dict:
        rec = torch.clamp(rec, 0, 1)[None]
        return {"psnr": float(psnr(ref, rec)), "ssim": float(ssim(ref, rec))}

    out = {}
    if task == "den":
        out["wavelet"] = score(C.wavelet_denoise(corrupted, device=dev))
        out["tv_chambolle"] = score(C.tv_denoise_chambolle(corrupted,
                                                           device=dev))
        out["bilateral"] = score(C.bilateral_denoise(corrupted, device=dev))
    elif task == "sr":
        factor = gt.shape[-1] // corrupted.shape[-1]
        out["bicubic"] = score(C.bicubic_upscale(corrupted, factor,
                                                 device=dev))
    elif task == "ct":
        from ..ops.radon import fbp
        sino, theta = corrupted
        rec = fbp(torch.from_numpy(sino).to(dev), theta, gt.shape[-1])[0]
        out["fbp_shepp_logan"] = score(rec)
    return out


def _infer_task(z) -> str | None:
    for key, task in (("img_noisy", "den"), ("img_lr", "sr"),
                      ("img_radon", "ct"), ("img_mask", "inp")):
        if key in z:
            return task
    return None


def baselines_from_run(npz_path: str, task: str | None = None,
                       device=None) -> dict:
    """The classical rows for a run's own data, from the save.npz schema
    (eval_denoising.ipynb cell 21, compare_ct.ipynb cells 2-5).
    Inpainting has no classical baseline in the reference."""
    with np.load(npz_path, allow_pickle=True) as z:
        task = task or _infer_task(z)
        gt = _gt(z)
        corrupted = {"den": "img_noisy", "sr": "img_lr", "ct": "img_radon"}
        if task not in corrupted:
            return {}
        data = np.asarray(z[corrupted[task]], np.float32)
    if task == "sr" and data.ndim == 2:
        data = data[None]
    elif task == "ct":
        # the sinogram stays (1, C, T, W), the layout of the port's fbp;
        # the reference's angle grid (ref :545)
        t = data.shape[2]
        data = (data, np.arange(t, dtype=np.float32) * (180.0 / t))
    return classical_baselines(task, gt, data, device)


def write_report(npz_paths, out_dir: str, task: str | None = None,
                 with_maps: bool = True, device=None) -> dict:
    """Every run's summary, calibration, classical rows and (if saved) its
    25-sample posterior-mean metrics into ``out_dir/report.json``; with
    ``with_maps`` also each method's recon / error / uncertainty PNGs and
    calibration diagram. Returns the report."""
    from ..utils import viz

    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    report = {"runs": {}}
    for path in npz_paths:
        entry = {"summary": summarize_run(path),
                 "calibration": calibration_from_run(path, device=dev),
                 "classical": baselines_from_run(path, task, dev)}
        with np.load(path, allow_pickle=True) as z:
            if "mc_mean_psnr" in z:   # the 25-sample posterior-mean metrics
                entry["mc_mean"] = {"psnr": float(z["mc_mean_psnr"]),
                                    "ssim": float(z["mc_mean_ssim"])}
            gt, recons = _gt(z), z["recons"].item()
            uncerts = z["uncerts"].item()
        report["runs"][path] = entry

        if with_maps:
            tag = os.path.basename(os.path.dirname(path)) or "run"
            for name, recs in recons.items():
                recon = np.asarray(recs)[-1]
                viz.save_image_png(np.clip(recon, 0, 1),
                                   f"{out_dir}/{tag}_{name}_recon.png")
                viz.save_normalized_png(np.abs(recon - gt),
                                        f"{out_dir}/{tag}_{name}_error.png")
                unc = np.asarray(uncerts.get(name, [0]))[-1]
                if np.any(unc > 0):
                    viz.save_normalized_png(
                        unc, f"{out_dir}/{tag}_{name}_uncert.png")
                cal = entry["calibration"].get(name)
                if cal:
                    viz.plot_uncert(cal["err_in_bin"], cal["uncert_in_bin"],
                                    f"{out_dir}/{tag}_{name}_calibration.png")

    with open(os.path.join(out_dir, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    return report


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("npz", nargs="+", help="save.npz artifact paths")
    parser.add_argument("--out", default="./eval_report")
    parser.add_argument("--task", default=None)
    parser.add_argument("--device", default=None,
                        help="where the metrics and baselines run (default: "
                        "the card; 'cpu' for the plain path)")
    parser.add_argument("--no-maps", action="store_true",
                        help="write report.json only (no PNGs, no "
                        "matplotlib / PIL needed)")
    args = parser.parse_args(argv)
    report = write_report(args.npz, args.out, task=args.task,
                          with_maps=not args.no_maps, device=args.device)
    for path, entry in report["runs"].items():
        print(f"== {path}")
        for name, row in entry["summary"].items():
            print(f"  {name}: PSNR {row['psnr_converged']:.2f} "
                  f"(early-stop {row['psnr_early_stop']:.2f} "
                  f"@{row['psnr_early_stop_iter']}), "
                  f"SSIM {row['ssim_converged']:.4f}")
        for name, cal in entry["calibration"].items():
            print(f"  {name}: UCE {cal['uce']:.5f}")
        if entry.get("mc_mean"):
            print(f"  mc-mean(25): PSNR {entry['mc_mean']['psnr']:.2f} "
                  f"SSIM {entry['mc_mean']['ssim']:.4f}")
        for name, row in entry.get("classical", {}).items():
            print(f"  [classical] {name}: PSNR {row['psnr']:.2f} "
                  f"SSIM {row['ssim']:.4f}")
    return report


if __name__ == "__main__":
    main()
