"""The plain reference of bo_mfvi_inp's MFVI inpainting fit's first steps,
in float32 with TF32 off, on any device: the reference module of the inp
configurations (their ``"reference": "inp"``). It gives what
``reference/step.py``'s docstring asks of a module: ``Fit(cfg, temp,
sigma, seed, device, quant)`` and ``conv_sites(cfg)``.

Written from the published description: the Deep Image Prior inpainting
net of Ulyanov et al. (CVPR 2018) as the upstream repository's
``run_inp_mfvi`` builds it (``skip`` with these arguments), and its
``nll_masked`` loss. The net, on an input of ``input_depth`` channels, per
level i of n = 6 (widths d = u = [16, 32, 64, 128, 128, 128], no skip
branch), on an input of c_i channels:

    down1:  pad -> conv 5x5, stride 2 (c_i -> d_i) -> BN -> LeakyReLU(0.2)
    down2:  pad -> conv 5x5 (d_i -> d_i)           -> BN -> LeakyReLU
            [level i + 1]                     (all but the deepest level)
            nearest x2 upsample
            BN over the deeper output (bn_cat: a concat of no skip)
    up:     pad -> conv 3x3                         -> BN -> LeakyReLU
    out:    conv 1x1 (u_0 -> 4), no sigmoid

(no 1x1 up conv), reflection padding, train-mode BatchNorm (the batch's
biased moments, eps 1e-5) and every conv's bias kept, as published (the
program may drop a bias that a BatchNorm removes). The output's first
three channels are the RGB mean, its fourth the negative log variance.

One step, as the upstream trainer defines it for inp under mfvi:

  * the input jitter z + 0.1 * N(0, 1), then one draw of the whole tree
    w = mu + softplus(rho) * eps, from the fit's generator, as
    ``step.py`` draws them;
  * the data loss: the masked Gaussian NLL of the image under (mean,
    negative log variance) = (sigmoid(out[:, :3]), out[:, 3:]), the log
    variance clamped to [-20, 20], each pixel's term times the rounded
    mask (1 = a known pixel) and the mean taken over all pixels, known or
    not, and the three channels; plus temp times the closed-form KL;
  * AdamW (``step.py``'s constants, no weight decay), skipped where the
    loss is not finite;
  * the transform (sigmoid of the mean channels, exp(-out) of the fourth),
    its EMA seeded with the first, and the row: the EMA's MSE against the
    image twice (no corrupted image besides the masked one), then PSNR and
    SSIM of the output against the image, of the masked output and of the
    masked EMA against the masked image, as the upstream loop logs them.

Departures: the checkout has no upstream image or mask, so image 0 is a
deterministic stand-in, a skin-like RGB texture and a hair-like mask of
thin curves (``hair_image``, from ``default_rng(4000 + img)``); the
parameters are made as ``net.py``'s ``init_params`` makes them (the
upstream's PyTorch-default init, then the MFVI re-initialisation, from
one seeded CPU generator).
"""

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import data, net as N
from portbench.reference.step import (ADAM_B1, ADAM_B2, ADAM_EPS,
                                      EXP_WEIGHT, REG_NOISE_STD, kl_reverse,
                                      psnr, ssim)

MEAN_CH = 3


@dataclasses.dataclass(frozen=True)
class Net:
    """The inpainting net's static topology; ``level_sites``,
    ``bn_cat_channels`` and ``out_site`` are what ``net.init_params``
    reads. (No ``from __future__ import annotations`` here: the harness
    loads this file as a module it does not register, where a dataclass
    cannot resolve annotations given as strings.)"""
    input_depth: int
    down: tuple
    up: tuple
    n_out: int
    k_down: int
    k_up: int

    @staticmethod
    def of(cfg: dict) -> "Net":
        n = cfg["net"]
        if any(n["skip_n11"]) or n["upsample_mode"] != "nearest" \
                or n["need1x1_up"]:
            raise ValueError("the inpainting net has no skip branch, "
                             "nearest upsampling and no 1x1 up conv")
        return Net(int(cfg["input_depth"]), tuple(n["skip_n33d"]),
                   tuple(n["skip_n33u"]), int(n["n_out"]),
                   int(n["filter_size_down"]), int(n["filter_size_up"]))

    @property
    def n_scales(self) -> int:
        return len(self.down)

    def bn_cat_channels(self, i: int) -> int:
        return self.down[i] if i == self.n_scales - 1 else self.up[i + 1]

    def level_sites(self, i: int) -> dict:
        c_in = self.input_depth if i == 0 else self.down[i - 1]
        p = f"levels.{i}"
        return {"down1": N.Site(f"{p}.down1", c_in, self.down[i],
                                self.k_down, 2),
                "down2": N.Site(f"{p}.down2", self.down[i], self.down[i],
                                self.k_down),
                "up": N.Site(f"{p}.up", self.bn_cat_channels(i), self.up[i],
                             self.k_up)}

    def out_site(self) -> N.Site:
        return N.Site("out", self.up[0], self.n_out, 1)

    def conv_sites(self, size: int) -> list:
        """Every conv site on a ``size`` x ``size`` input, as a reference
        module's ``conv_sites`` gives them; level 0's down1 reads the net
        input, which needs no gradient."""
        out = []
        for i in range(self.n_scales):
            s_in = size >> i
            lv = self.level_sites(i)
            for part, side, dx in (("down1", s_in, i > 0),
                                   ("down2", s_in // 2, True),
                                   ("up", s_in, True)):
                s = lv[part]
                out.append(dict(name=s.name, c_in=s.c_in, c_out=s.c_out,
                                k=s.k, stride=s.stride, size_in=side,
                                needs_dx=dx))
        s = self.out_site()
        out.append(dict(name=s.name, c_in=s.c_in, c_out=s.c_out, k=s.k,
                        stride=s.stride, size_in=size, needs_dx=True))
        return out


def conv_sites(cfg: dict) -> list:
    return Net.of(cfg).conv_sites(int(cfg["imsize"]))


def forward(net: Net, w: dict, x: torch.Tensor, quant=None) -> torch.Tensor:
    """The net on ``x`` (1, D, H, W) with the drawn weights ``w``."""

    def site(s: N.Site, h: torch.Tensor) -> torch.Tensor:
        h = N.conv(h, w[f"{s.name}.conv.w"], w[f"{s.name}.conv.b"],
                   s.stride, quant)
        return N.leaky_relu(N.batch_norm(h, w[f"{s.name}.bn.scale"],
                                         w[f"{s.name}.bn.offset"]))

    def level(i: int, h: torch.Tensor) -> torch.Tensor:
        sites = net.level_sites(i)
        h = site(sites["down2"], site(sites["down1"], h))
        if i < net.n_scales - 1:
            h = level(i + 1, h)
        h = F.interpolate(h, scale_factor=2.0, mode="nearest")
        h = N.batch_norm(h, w[f"levels.{i}.bn_cat.scale"],
                         w[f"levels.{i}.bn_cat.offset"])
        return site(sites["up"], h)

    return N.conv(level(0, x), w["out.conv.w"], w["out.conv.b"], 1, quant)


def hair_image(size: int, img: int = 0) -> tuple:
    """Image ``img`` of the inp task and its mask, each (3, s, s) float32
    in [0, 1]: a skin-like texture (a smooth field a channel from
    ``default_rng(4000 + img)``, each scaled to [0, 0.25] over the base
    colour (0.65, 0.45, 0.35)), and twelve hair-like curves drawn from the
    same stream, each 2 s unit steps of a slowly turning heading from a
    random start, that mask the 3 x 3 pixels around each point they pass
    (0 = unknown; coordinates wrap)."""
    rng = np.random.default_rng(4000 + img)
    base = np.clip(np.stack([
        data._norm01(data._smooth(rng.standard_normal((size, size)),
                                  size / 10)) * 0.25 + c
        for c in (0.65, 0.45, 0.35)]), 0, 1)
    mask = np.ones((size, size), np.float32)
    for _ in range(12):
        x, y = rng.uniform(0, size), rng.uniform(0, size)
        ang, curv = rng.uniform(0, np.pi), rng.uniform(-0.02, 0.02)
        for _ in range(2 * size):
            xi, yi = int(x) % size, int(y) % size
            mask[max(yi - 1, 0):yi + 2, max(xi - 1, 0):xi + 2] = 0.0
            ang += curv
            x += np.cos(ang)
            y += np.sin(ang)
    return base.astype(np.float32), np.repeat(mask[None], 3, axis=0)


class Fit:
    """The reference inp fit of configuration ``cfg`` with (temp, sigma)
    from ``seed`` on ``device``: ``flat``, ``m`` and ``v`` are its
    parameters and Adam's moments; ``step()`` runs one iteration."""

    def __init__(self, cfg: dict, temp: float, sigma: float, seed: int,
                 device="cpu", quant=None):
        if cfg["task"] != "inp":
            raise ValueError(f"no inp fit for task {cfg['task']!r}")
        self.device, self.quant = torch.device(device), quant
        dev = self.device
        self.net = Net.of(cfg)
        params = N.init_params(self.net, seed)
        self.layout = N.Layout.of(params)
        self.flat = self.layout.flat(params).to(dev)
        self.m = torch.zeros_like(self.flat)
        self.v = torch.zeros_like(self.flat)
        self.count = 0
        size = int(cfg["imsize"])
        img, mask = hair_image(size, int(cfg["img"]))
        self.gt = torch.from_numpy(img)[None].to(dev)
        self.mask = torch.round(torch.from_numpy(mask)[None]).to(dev)
        # the net input: the first draw of default_rng(seed), uniform [0, 1)
        # in (1, H, W, D) order times 0.1
        z = np.random.default_rng(seed).random(
            (1, size, size, int(cfg["input_depth"])), dtype=np.float32) * 0.1
        self.z = torch.from_numpy(
            np.ascontiguousarray(z.transpose(0, 3, 1, 2))).to(dev)
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.temp = float(temp)
        self.prior_sigma = float(math.sqrt(temp) * sigma)
        self.lr = float(cfg["lr"])
        self.out_avg = None

    def data_loss(self, out: torch.Tensor) -> torch.Tensor:
        mean = torch.sigmoid(out[:, :MEAN_CH])
        nlv = torch.clamp(out[:, MEAN_CH:], -20.0, 20.0)
        return torch.mean((torch.exp(nlv) * (self.gt - mean) ** 2 - nlv)
                          * self.mask)

    @staticmethod
    def transform(out: torch.Tensor) -> torch.Tensor:
        return torch.cat([torch.sigmoid(out[:, :MEAN_CH]),
                          torch.exp(-out[:, MEAN_CH:])], dim=1)

    def metrics(self, out_t: torch.Tensor) -> torch.Tensor:
        o = torch.clamp(out_t[:, :MEAN_CH], 0, 1)
        oa = torch.clamp(self.out_avg[:, :MEAN_CH], 0, 1)
        mse_c = torch.mean((self.out_avg[:, :MEAN_CH] - self.gt) ** 2)
        gm, om, oam = self.gt * self.mask, o * self.mask, oa * self.mask
        return torch.stack([mse_c, mse_c, psnr(self.gt, o), psnr(gm, om),
                            psnr(gm, oam), ssim(self.gt, o), ssim(gm, om),
                            ssim(gm, oam)])

    def step(self) -> dict:
        """One iteration; returns {'row': its metric row, 'grad': the
        gradient the optimizer got (data loss + temp * KL)}."""
        lay, n = self.layout, self.layout.n_var
        x = self.z + REG_NOISE_STD * torch.randn(
            self.z.shape, generator=self.gen, device=self.device)
        eps = torch.randn((n,), generator=self.gen, device=self.device)
        p = self.flat.detach().clone().requires_grad_(True)
        mu, rho = p[:n], p[n:2 * n]
        sample = torch.cat([mu + F.softplus(rho) * eps, p[2 * n:]])
        leaves = {}
        for name, s, o in zip(lay.names, lay.shapes, lay.offsets):
            size = math.prod(s)
            if name.endswith("_mu"):
                leaves[name[:-3]] = sample[o:o + size].view(s)
            elif o >= 2 * n:
                leaves[name] = sample[o - n:o - n + size].view(s)
        out = forward(self.net, leaves, x, self.quant)
        total = self.data_loss(out) + self.temp * kl_reverse(
            mu, rho, self.prior_sigma)
        (grad,) = torch.autograd.grad(total, p)
        with torch.no_grad():
            if torch.isfinite(total):
                self.count += 1
                self.m = ADAM_B1 * self.m + (1 - ADAM_B1) * grad
                self.v = ADAM_B2 * self.v + (1 - ADAM_B2) * grad * grad
                m_hat = self.m / (1 - ADAM_B1 ** self.count)
                v_hat = self.v / (1 - ADAM_B2 ** self.count)
                self.flat = self.flat - self.lr * m_hat / (
                    torch.sqrt(v_hat) + ADAM_EPS)
            out_t = self.transform(out.detach())
            self.out_avg = (out_t if self.out_avg is None else
                            self.out_avg * EXP_WEIGHT
                            + out_t * (1 - EXP_WEIGHT))
            row = self.metrics(out_t)
        return {"row": row, "grad": grad.detach()}
