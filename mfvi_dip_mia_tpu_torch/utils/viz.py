"""Host-side plots and image dumps of a run (counterpart of
mfvi_dip_mia_tpu/utils/viz.py): loss / PSNR / SSIM curves, the calibration
diagrams, the weight and SNR histograms and PNGs.

matplotlib (Agg) and PIL are imported inside the functions, so the port
imports where they are missing; a run with ``plot=True`` there raises
ImportError.
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_loss(mse_corrupted, mse_gt, psnrs, iteration, path,
              title="MSE", y_label="psnr_gt_sm"):
    plt = _plt()
    fig, ax0 = plt.subplots()
    ax0.plot(range(len(mse_corrupted[:iteration])), mse_corrupted[:iteration])
    ax0.plot(range(len(mse_gt[:iteration])), mse_gt[:iteration])
    ax0.set_title(title)
    ax0.set_xlabel("iteration")
    ax0.set_ylabel("mse")
    ax0.set_ylim(0, 0.03)
    ax0.grid(True)
    ax1 = ax0.twinx()
    ax1.plot(range(len(psnrs[:iteration])), psnrs[:iteration, 2], "g")
    ax1.set_ylabel(y_label)
    fig.tight_layout()
    fig.savefig(path)
    plt.close("all")


def plot_results(mse_corrupted, mse_gt, psnrs, ssims, out_dir, file=None):
    """Summary curves across methods ({name: array} dicts)."""
    plt = _plt()
    for name, curves, title, ylim in (
            ("mse_noisy", mse_corrupted, "MSE noisy", 0.03),
            ("mse_gt", mse_gt, "MSE GT", 0.01)):
        fig, ax = plt.subplots(1, 1)
        for key, loss in curves.items():
            ax.plot(range(len(loss)), loss, label=key)
        ax.set(title=title, xlabel="iteration", ylabel="mse loss",
               ylim=(0, ylim))
        ax.grid(True)
        ax.legend()
        plt.tight_layout()
        plt.savefig(f"{out_dir}/{name}.png")

    for name, data, labels in (
            ("psnrs", psnrs, ["psnr_noisy", "psnr_gt", "psnr_gt_sm"]),
            ("ssims", ssims, ["ssim_noisy", "ssim_gt", "ssim_gt_sm"])):
        fig, axs = plt.subplots(1, 3, constrained_layout=True)
        for key, arr in data.items():
            arr = np.asarray(arr)
            if file is not None:
                print(f"{key} {name[:-1].upper()}_max: {np.max(arr)}",
                      file=file)
            for i in range(arr.shape[1]):
                axs[i].plot(range(arr.shape[0]), arr[:, i], label=key)
                axs[i].set(title=labels[i], xlabel="iteration")
                axs[i].legend()
        plt.savefig(f"{out_dir}/{name}.png")
    plt.close("all")


def plot_uncert(errors_per_bin, uncert_per_bin, path):
    """Calibration diagram: error against uncertainty per bin, beside the
    diagonal (viz.py:145-155)."""
    plt = _plt()
    fig, ax = plt.subplots()
    ax.plot([0, max(float(np.nanmax(uncert_per_bin)), 1e-9)], "--",
            color="gray")
    ax.plot(np.asarray(uncert_per_bin), np.asarray(errors_per_bin), "o-")
    ax.set_xlabel("uncertainty")
    ax.set_ylabel("error")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def weight_hist(mus, sigmas, path, bins=100):
    """Histograms of the posterior means and standard deviations over all
    variational leaves (viz.py:108)."""
    plt = _plt()
    fig, axs = plt.subplots(1, 2, figsize=(10, 4))
    axs[0].hist(np.concatenate([np.ravel(m) for m in mus]), bins=bins)
    axs[0].set_title("W_mu")
    axs[1].hist(np.concatenate([np.ravel(s) for s in sigmas]), bins=bins)
    axs[1].set_title("W_sigma")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def snr_hist(mus, sigmas, path, bins=100):
    """Histogram of log10 |mu| / sigma over all weights (viz.py:120)."""
    plt = _plt()
    snrs = [np.abs(np.ravel(m)) / np.ravel(s) for m, s in zip(mus, sigmas)]
    fig, ax = plt.subplots()
    ax.hist(np.log10(np.concatenate(snrs) + 1e-12), bins=bins)
    ax.set_xlabel("log10 SNR")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def plot_conf(accs_per_bin, conf_per_bin, path):
    """Classification calibration diagram: accuracy against confidence per
    bin, beside the diagonal (viz.py:130)."""
    plt = _plt()
    fig, ax = plt.subplots()
    ax.plot([0, 1], [0, 1], "--", color="gray")
    ax.plot(np.asarray(conf_per_bin), np.asarray(accs_per_bin), "o-")
    ax.set_xlabel("confidence")
    ax.set_ylabel("accuracy")
    ax.set_xlim(0, 1)
    ax.set_ylim(0, 1)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def save_image_png(img_chw: np.ndarray, path: str):
    """float (C, H, W) in [0, 1] -> an 8-bit PNG."""
    from PIL import Image
    img = np.asarray(img_chw)
    ar = np.clip(img * 255, 0, 255).astype(np.uint8)
    ar = ar[0] if img.shape[0] == 1 else ar.transpose(1, 2, 0)
    Image.fromarray(ar).save(path, "PNG")


def save_normalized_png(img_chw: np.ndarray, path: str):
    m = img_chw.max()
    save_image_png(img_chw / m if m > 0 else img_chw, path)


def plot_image_grid_png(images_chw, path, pad_value=0.0):
    """A horizontal grid of (C, H, W) images, gray ones repeated to the
    widest channel count."""
    c = max(im.shape[0] for im in images_chw)
    imgs = [im if im.shape[0] == c else np.concatenate([im] * c, axis=0)
            for im in images_chw]
    h = max(im.shape[1] for im in imgs)
    w = max(im.shape[2] for im in imgs)
    padded = [np.pad(im, ((0, 0), (0, h - im.shape[1]), (0, w - im.shape[2])),
                     constant_values=pad_value) for im in imgs]
    save_image_png(np.concatenate(padded, axis=2), path)
