"""Task definitions: data -> operator -> loss / transform / metrics
(counterpart of mfvi_dip_mia_tpu/tasks/problems.py) for the slice's two
task/method pairs:

  task | method | data loss                              | post-loss transform
  -----+--------+----------------------------------------+--------------------
  ct   | mfvi   | mse(radon(out), radon(gt))             | none (1 channel)
  den  | mfvi   | gaussian_nll(out[:1], out[1:], noisy)  | ch1 -> exp(-ch1)

Net (both): 5-scale [16,32,64,128,128], skip 4, bilinear up, reflection pad,
n_out = 1 (ct) / 2 (den). Tensors are NCHW on the problem's device.
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


@dataclasses.dataclass
class Problem:
    task: str                     # 'den' | 'ct'
    method: str                   # 'mfvi'
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
        return losses.gaussian_nll(out[:, :1], out[:, 1:], self.target)

    def transform(self, out: torch.Tensor) -> torch.Tensor:
        if self.task == "ct":
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


def _standard_net(n_channels, input_depth=16):
    return build_skip_net(
        input_depth, n_channels=n_channels, pad="reflection",
        skip_n33d=[16, 32, 64, 128, 128], skip_n33u=[16, 32, 64, 128, 128],
        skip_n11=4, num_scales=5, upsample_mode="bilinear")


def _chw(img_np: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(img_np))[None].to(device)


def build_problem(task: str, method: str, img: int, *, p_sigma: float = 0.1,
                  input_depth: int = 16, device=None,
                  radon_mode: str = "auto",
                  rng: np.random.Generator | None = None) -> Problem:
    """Load data, corrupt it, build the operator and the net on ``device``
    (default: the card). ``radon_mode`` picks the CT operator
    (ops/radon.py). ``rng`` draws the noise (default ``default_rng(42)``);
    a runner passes the stream it then hands to ``fit`` (problems.py:180)."""
    if method != "mfvi" or task not in ("ct", "den"):
        raise NotImplementedError(
            f"task {task!r} / method {method!r} is not ported yet: the port "
            "covers ct/mfvi and den/mfvi (ROADMAP Queue 1 items 4-5)")
    dev = resolve_device(device)
    if rng is None:
        rng = np.random.default_rng(42)

    if task == "den":
        img_np, _ = D.get_image_denoising(img)
        noisy_np = I.add_gaussian_noise(img_np, p_sigma, rng)
        return Problem(task, method, _standard_net(2, input_depth),
                       input_depth, tuple(img_np.shape[1:]), 1,
                       _chw(img_np, dev), _chw(noisy_np, dev), None, dev,
                       img_np, noisy_np, has_ale=True)

    img_np, _ = D.get_img_ct(img)
    gt = _chw(img_np, dev)
    radon = FastRadonTransform(gt.shape, _CT_THETA, mode=radon_mode,
                               device=dev)
    with torch.no_grad():
        target = radon(gt)
    return Problem(task, method, _standard_net(1, input_depth), input_depth,
                   tuple(img_np.shape[1:]), 1, gt, target, radon, dev, img_np,
                   target[0].cpu().numpy())
