"""Task definitions: data -> operator -> loss / transform / metrics
(counterpart of mfvi_dip_mia_tpu/tasks/problems.py) for the four tasks
under the four methods:

  task | method      | data loss                               | transform
  -----+-------------+-----------------------------------------+----------
  ct   | all         | mse(radon(out), radon(gt))              | none
  den  | dip         | mse(out[:1], noisy)                     | none
  den  | sgld        | mse(out[:1], noisy)                     | 1: exp(-)
  den  | mfvi, mcd   | gaussian_nll(out[:1], out[1:], noisy)   | 1: exp(-)
  sr   | dip         | mse(down(out)[:1], lr)                  | none
  sr   | mfvi, mcd,  | gaussian_nll on down(out)               | 1: exp(-)
       | sgld        |                                         |
  inp  | dip         | mse(sigmoid(out[:3]) m, gt m)           | :3 sigmoid
  inp  | mfvi, mcd,  | nll_masked(sigmoid(out[:3]), out[3:],   | :3 sigmoid,
       | sgld        |            gt, m)                       | 3: exp(-)

down is the sr operator, a x1/4 resize of the whole output: bilinear for
dip, nearest for the others (problems.py:194-207); m is the rounded
inpainting mask (1 = known pixel).

Nets: ct / den / sr: 5-scale [16,32,64,128,128], skip 4, bilinear up,
reflection pad, n_out = 1 (ct) / 2 (den, sr); mcd adds always-on dropout2d
on the down and up sites (problems.py:166-174), and sr mcd re-draws every
conv kernel from N(0, 0.1) (``reinit_conv_weights_normal``). inp dip / mfvi
/ sgld: 6-scale [16,32,64,128,128,128], no skips, k5 down / k3 up, nearest
up, no 1x1 up, n_out = 4 (3 mean + 1 neg-logvar), no sigmoid in the net;
inp mcd: the 5-scale net with skip 0 and dropout, n_out = 4. Tensors are
NCHW on the problem's device.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from ..nn import layers as L
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
    task: str                     # 'den' | 'sr' | 'inp' | 'ct'
    method: str                   # 'dip' | 'mfvi' | 'mcd' | 'sgld'
    net: SkipNet
    input_depth: int
    imsize: tuple                 # (H, W)
    mean_ch: int                  # 1 (gray) or 3 (rgb)
    gt: torch.Tensor              # (1, C, H, W) ground truth
    target: torch.Tensor          # loss target (noisy / lr image / sinogram
                                  # / gt)
    operator: Optional[Callable]  # forward operator applied to the output
    device: torch.device
    gt_np: np.ndarray             # (C, H, W) host copies for the artifacts
    target_np: np.ndarray         # (inp: the mask)
    has_ale: bool = False         # output carries a neg-logvar channel
    mask: Optional[torch.Tensor] = None   # inp: (1, 3, H, W), 1 = known
    sr_factor: int = 4
    init_normal_std: Optional[float] = None   # sr mcd's N(0, std) re-init

    def data_loss(self, out: torch.Tensor) -> torch.Tensor:
        t, m = self.task, self.method
        if t == "ct":
            return losses.mse_loss(self.operator(out), self.target)
        if t == "den":
            if m in ("dip", "sgld"):
                return losses.mse_loss(out[:, :1], self.target)
            return losses.gaussian_nll(out[:, :1], out[:, 1:], self.target)
        if t == "sr":
            out_lr = self.operator(out)
            if m == "dip":
                return losses.mse_loss(out_lr[:, :1], self.target)
            return losses.gaussian_nll(out_lr[:, :1], out_lr[:, 1:],
                                       self.target)
        # inp: every method sigmoids the mean channels before the loss,
        # never the neg-logvar channel (problems.py:93-104)
        pred = torch.sigmoid(out[:, :3])
        if m == "dip":
            return losses.mse_loss(pred * self.mask, self.target * self.mask)
        return losses.gaussian_nll_masked(pred, out[:, 3:], self.target,
                                          self.mask)

    def transform(self, out: torch.Tensor) -> torch.Tensor:
        t, m = self.task, self.method
        if t == "ct" or (t in ("den", "sr") and m == "dip"):
            return out
        if t in ("den", "sr"):
            return torch.cat([out[:, :1], torch.exp(-out[:, 1:])], dim=1)
        ale = out[:, 3:] if m == "dip" else torch.exp(-out[:, 3:])
        return torch.cat([torch.sigmoid(out[:, :3]), ale], dim=1)

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
        if self.task == "inp":
            mse_c = losses.mse_loss(out_avg[:, :3], self.gt)
            gm, om, oam = self.gt * self.mask, o * self.mask, oa * self.mask
            return torch.stack([
                mse_c, mse_c, psnr(self.gt, o), psnr(gm, om), psnr(gm, oam),
                ssim(self.gt, o), ssim(gm, om), ssim(gm, oam)])
        if self.task == "sr":
            # the corrupted-side metrics on the low-resolution image
            seen = torch.clamp(self.operator(out_t)[:, :1], 0, 1)
            mse_c = losses.mse_loss(self.operator(out_avg)[:, :1],
                                    self.target)
        else:
            seen = o
            mse_c = losses.mse_loss(out_avg[:, :1], self.target)
        mse_g = losses.mse_loss(out_avg[:, :1], self.gt)
        return torch.stack([
            mse_c, mse_g, psnr(self.target, seen), psnr(self.gt, o),
            psnr(self.gt, oa), ssim(self.target, seen), ssim(self.gt, o),
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
                  sr_factor: int = 4, device=None, radon_mode: str = "auto",
                  rng: np.random.Generator | None = None) -> Problem:
    """Load data, corrupt it, build the operator and the net for (task,
    method) on ``device`` (default: the card). ``dropout_p`` is mcd's
    dropout rate, ``sr_factor`` the sr task's downscale. ``radon_mode``
    picks the CT operator (ops/radon.py). ``rng`` draws the den noise
    (default ``default_rng(42)``); a runner passes the stream it then hands
    to ``fit`` (problems.py:180)."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    if task not in ("ct", "den", "sr", "inp"):
        raise ValueError(f"unknown task {task!r}")
    dev = resolve_device(device)
    if rng is None:
        rng = np.random.default_rng(42)
    has_ale = method != "dip"

    if task == "den":
        img_np, _ = D.get_image_denoising(img)
        noisy_np = I.add_gaussian_noise(img_np, p_sigma, rng)
        return Problem(task, method,
                       _standard_net(2, method, dropout_p, input_depth),
                       input_depth, tuple(img_np.shape[1:]), 1,
                       _chw(img_np, dev), _chw(noisy_np, dev), None, dev,
                       img_np, noisy_np, has_ale=has_ale)

    if task == "sr":
        img_np, _ = D.get_img_superresolution(img)
        gt = _chw(img_np, dev)
        resize = L.resize_bilinear if method == "dip" else L.resize_nearest
        operator = functools.partial(resize, scale=1.0 / sr_factor)
        with torch.no_grad():
            target = operator(gt)
        return Problem(task, method,
                       _standard_net(2, method, dropout_p, input_depth),
                       input_depth, tuple(img_np.shape[1:]), 1, gt, target,
                       operator, dev, img_np, target[0].cpu().numpy(),
                       has_ale=has_ale, sr_factor=sr_factor,
                       init_normal_std=0.1 if method == "mcd" else None)

    if task == "inp":
        img_np, mask_np, _ = D.get_img_inpainting(img)
        gt = _chw(img_np, dev)
        if method == "mcd":
            net = build_skip_net(
                input_depth, n_channels=4, pad="reflection",
                skip_n33d=[16, 32, 64, 128, 128],
                skip_n33u=[16, 32, 64, 128, 128], skip_n11=0, num_scales=5,
                upsample_mode="bilinear",
                dropout_mode_down="2d", dropout_p_down=dropout_p,
                dropout_mode_up="2d", dropout_p_up=dropout_p)
        else:
            net = SkipNet(
                num_input_channels=input_depth, num_output_channels=4,
                num_channels_down=[16, 32, 64, 128, 128, 128],
                num_channels_up=[16, 32, 64, 128, 128, 128],
                num_channels_skip=[0] * 6, filter_size_down=5,
                filter_size_up=3, filter_skip_size=1, need1x1_up=False,
                upsample_mode="nearest", pad="reflection", need_sigmoid=False)
        return Problem(task, method, net, input_depth,
                       tuple(img_np.shape[1:]), 3, gt, gt, None, dev, img_np,
                       mask_np, has_ale=has_ale,
                       mask=torch.round(_chw(mask_np, dev)))

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


def problem_on(problem: Problem, device) -> Problem:
    """``problem`` with its device tensors on ``device`` (itself when it
    lives there already); the CT operator's state is built anew there."""
    dev = resolve_device(device)
    if dev == problem.device:
        return problem
    operator = problem.operator
    if isinstance(operator, FastRadonTransform):
        operator = FastRadonTransform(problem.gt.shape, operator.theta_deg,
                                      mode=operator.mode, device=dev)
    return dataclasses.replace(
        problem, gt=problem.gt.to(dev), target=problem.target.to(dev),
        mask=None if problem.mask is None else problem.mask.to(dev),
        operator=operator, device=dev)


def reinit_conv_weights_normal(params: dict, generator: torch.Generator,
                               std: float = 0.1) -> dict:
    """sr mcd's quirk (problems.py:254): every conv kernel re-drawn from
    N(0, std), in the tree's order from ``generator``; biases and the
    BatchNorm affine unchanged. JAX folds a key per kernel, so the two
    packages' draws differ and agree in distribution only."""
    return {k: (torch.randn(v.shape, generator=generator, dtype=v.dtype)
                * std if k.endswith(".conv.w") else v)
            for k, v in params.items()}
