"""Task definitions: data -> operator -> loss / transform / metrics
(counterpart of mfvi_dip_mia_tpu/tasks/problems.py) for the ct and den
tasks under the four methods:

  task | method    | data loss                              | transform
  -----+-----------+----------------------------------------+--------------
  ct   | all       | mse(radon(out), radon(gt))             | none (1 ch)
  den  | dip       | mse(out[:1], noisy)                    | none
  den  | sgld      | mse(out[:1], noisy)                    | ch1 -> exp(-ch1)
  den  | mfvi, mcd | gaussian_nll(out[:1], out[1:], noisy)  | ch1 -> exp(-ch1)

Net (both tasks): 5-scale [16,32,64,128,128], skip 4, bilinear up,
reflection pad, n_out = 1 (ct) / 2 (den); mcd adds always-on dropout2d on
the down and up sites (problems.py:166-174). The sr and inp tasks are not
ported yet (ROADMAP Queue 1 item 5). Tensors are NCHW on the problem's
device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..nn.skip import SkipNet, build_skip_net
from ..ops import losses
from ..ops.metrics import psnr, ssim
from ..ops.radon import FastRadonTransform
from ..utils import images as I
from ..utils.device import resolve_device
from . import data as D

_CT_THETA = np.arange(0.0, 180.0, 4.0)
METHODS = ("dip", "mfvi", "mcd", "sgld")


@dataclasses.dataclass
class Problem:
    task: str                     # 'den' | 'ct'
    method: str                   # 'dip' | 'mfvi' | 'mcd' | 'sgld'
    net: SkipNet
    input_depth: int
    imsize: tuple                 # (H, W)
    mean_ch: int                  # 1 (gray)
    gt: torch.Tensor              # (1, C, H, W) ground truth
    target: torch.Tensor          # loss target (noisy image / sinogram)
    operator: Optional[Callable]  # forward operator applied to the output
    device: torch.device
    gt_np: np.ndarray             # (C, H, W) host copies for the artifacts
    target_np: np.ndarray
    has_ale: bool = False         # output carries a neg-logvar channel

    def data_loss(self, out: torch.Tensor) -> torch.Tensor:
        if self.task == "ct":
            return losses.mse_loss(self.operator(out), self.target)
        if self.method in ("dip", "sgld"):
            return losses.mse_loss(out[:, :1], self.target)
        return losses.gaussian_nll(out[:, :1], out[:, 1:], self.target)

    def transform(self, out: torch.Tensor) -> torch.Tensor:
        if self.task == "ct" or self.method == "dip":
            return out
        return torch.cat([out[:, :1], torch.exp(-out[:, 1:])], dim=1)

    def metrics(self, out_t: torch.Tensor,
                out_avg: torch.Tensor) -> torch.Tensor:
        """(mse_corrupted, mse_gt, psnr[3], ssim[3]) as an 8-vector; ``out_t``
        is the transformed output, ``out_avg`` its EMA."""
        mc = self.mean_ch
        o = torch.clamp(out_t[:, :mc], 0, 1)
        oa = torch.clamp(out_avg[:, :mc], 0, 1)
        if self.task == "ct":
            mse_c = losses.mse_loss(out_avg[:, :1], self.gt)
            p0 = psnr(self.gt, o)
            s0 = ssim(self.gt, o)
            return torch.stack([mse_c, mse_c, p0, p0, psnr(self.gt, oa),
                                s0, s0, ssim(self.gt, oa)])
        mse_c = losses.mse_loss(out_avg[:, :1], self.target)
        mse_g = losses.mse_loss(out_avg[:, :1], self.gt)
        return torch.stack([
            mse_c, mse_g, psnr(self.target, o), psnr(self.gt, o),
            psnr(self.gt, oa), ssim(self.target, o), ssim(self.gt, o),
            ssim(self.gt, oa)])


def _standard_net(n_channels, method, dropout_p, input_depth=16):
    kwargs = {}
    if method == "mcd":
        kwargs = dict(dropout_mode_down="2d", dropout_p_down=dropout_p,
                      dropout_mode_up="2d", dropout_p_up=dropout_p)
    return build_skip_net(
        input_depth, n_channels=n_channels, pad="reflection",
        skip_n33d=[16, 32, 64, 128, 128], skip_n33u=[16, 32, 64, 128, 128],
        skip_n11=4, num_scales=5, upsample_mode="bilinear", **kwargs)


def _chw(img_np: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(img_np))[None].to(device)


def build_problem(task: str, method: str, img: int, *, p_sigma: float = 0.1,
                  input_depth: int = 16, dropout_p: float = 0.3,
                  device=None, radon_mode: str = "auto",
                  rng: np.random.Generator | None = None) -> Problem:
    """Load data, corrupt it, build the operator and the net for (task,
    method) on ``device`` (default: the card). ``dropout_p`` is mcd's
    dropout rate. ``radon_mode`` picks the CT operator (ops/radon.py).
    ``rng`` draws the noise (default ``default_rng(42)``); a runner passes
    the stream it then hands to ``fit`` (problems.py:180)."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    if task in ("sr", "inp"):
        raise NotImplementedError(
            f"task {task!r} is not ported yet: the port covers ct and den "
            "(ROADMAP Queue 1 item 5)")
    if task not in ("ct", "den"):
        raise ValueError(f"unknown task {task!r}")
    dev = resolve_device(device)
    if rng is None:
        rng = np.random.default_rng(42)

    if task == "den":
        img_np, _ = D.get_image_denoising(img)
        noisy_np = I.add_gaussian_noise(img_np, p_sigma, rng)
        return Problem(task, method,
                       _standard_net(2, method, dropout_p, input_depth),
                       input_depth, tuple(img_np.shape[1:]), 1,
                       _chw(img_np, dev), _chw(noisy_np, dev), None, dev,
                       img_np, noisy_np, has_ale=method != "dip")

    img_np, _ = D.get_img_ct(img)
    gt = _chw(img_np, dev)
    radon = FastRadonTransform(gt.shape, _CT_THETA, mode=radon_mode,
                               device=dev)
    with torch.no_grad():
        target = radon(gt)
    return Problem(task, method,
                   _standard_net(1, method, dropout_p, input_depth),
                   input_depth, tuple(img_np.shape[1:]), 1, gt, target, radon,
                   dev, img_np, target[0].cpu().numpy())
