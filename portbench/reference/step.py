"""The plain reference of an MFVI DIP fit's first steps, in float32 with
TF32 off, on any device: the reference module of the ct and den skip-net
MFVI configurations (their ``"reference": "step"``).

A reference module (portbench/reference/<module>.py, named by a
configuration's ``reference`` key, found by ``spec.reference``) gives:

  * ``Fit(cfg, temp, sigma, seed, device, quant)``: the fit of
    configuration ``cfg`` with (temp, sigma) from ``seed`` on ``device``,
    its inputs, weights and draws made by itself from the seed; ``.flat``
    its parameters as one vector, ``.layout.leaves(flat)`` a vector of that
    layout by leaf name (the program's leaf names), ``.step()`` one
    iteration, returning ``{"row": its metric row (8,), "grad": the
    gradient the optimizer got, in ``flat``'s layout}``; ``quant`` (a
    ``precision.Rounding`` or None) computes its convs at a lower precision
    (the control);
  * ``conv_sites(cfg)``: each conv site of the configuration's net as a
    dict: name, c_in, c_out, k, stride, size_in (the side of its input)
    and needs_dx (False for a site that reads the net input), which
    work/conv.py reckons operations and bytes from.

It imports nothing of the program. ``net.py``, ``data.py``, ``radon.py``
and ``precision.py`` are helpers a module may import.

One step, as the upstream trainer defines it:

  * the input jitter z + 0.1 * N(0, 1), drawn first from the fit's generator;
  * one reparameterised draw of the whole tree, w = mu + softplus(rho) * eps,
    eps ~ N(0, 1) drawn as one vector over the [mu] segment in layout order;
  * the net's output and the data loss: for ct the MSE of A(out) against
    A(gt), A the reference Radon operator; for den the Gaussian NLL of the
    noisy image under (mean, negative log variance) = (out[:1], out[1:]),
    the log variance clamped to [-20, 20];
  * plus temp times the closed-form KL(prior || posterior) summed over every
    variational element, prior N(0, sqrt(temp) * sigma + 1e-6);
  * the gradient by autograd, then AdamW (b1 0.9, b2 0.999, eps 1e-8, no
    weight decay, bias-corrected), skipped where the loss is not finite;
  * the output's EMA (seeded with the first output; den's second channel as
    exp(-out)) and the metric row (mse_corrupted, mse_gt, psnr x 3,
    ssim x 3) as the upstream loop logs it.

The draws come from the reference's own generator, seeded as the program's
fit seeds its own, on the same device: the same calls in the same order give
the same numbers. ``quant`` rounds every conv's operands to a lower precision
(the control, ``precision.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import data, net as N, radon as R

EXP_WEIGHT = 0.99
REG_NOISE_STD = 0.1
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
PRIOR_SIGMA_STABILIZER = 1e-6


def gaussian_window(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / float(2 * sigma ** 2))
    g /= g.sum()
    return torch.from_numpy(g.astype(np.float32))


def psnr(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return 10.0 * torch.log10(1.0 / torch.mean((a - b) ** 2))


def ssim(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean SSIM with an 11 x 11 Gaussian window (sigma 1.5) applied with
    zero padding, C1 = 0.01^2, C2 = 0.03^2, over (1, C, H, W) images."""
    g = gaussian_window().to(x.device)
    c = x.shape[1]
    k = (g[:, None] * g[None, :])[None, None].expand(5 * c, 1, 11, 11)
    stack = torch.cat([x, y, x * x, y * y, x * y], dim=1)
    blurred = F.conv2d(stack, k.contiguous(), padding=5, groups=5 * c)
    mu1, mu2, exx, eyy, exy = (blurred[:, i * c:(i + 1) * c]
                               for i in range(5))
    s1, s2, s12 = exx - mu1 * mu1, eyy - mu2 * mu2, exy - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (s1 + s2 + c2))
    return m.mean()


def kl_reverse(mu, rho, prior_sigma: float) -> torch.Tensor:
    sp = prior_sigma + PRIOR_SIGMA_STABILIZER
    sq = F.softplus(rho)
    return (torch.log(sq) - math.log(sp) + (sp ** 2 + mu ** 2)
            / (2.0 * sq ** 2) - 0.5).sum()


def conv_sites(cfg: dict) -> list:
    """The skip U-Net's conv sites (``net.Net.conv_sites``)."""
    return N.Net.of(cfg).conv_sites(int(cfg["imsize"]))


class Fit:
    """The reference fit of configuration ``cfg`` with (temp, sigma) from
    ``seed`` on ``device``: ``flat``, ``m`` and ``v`` are its parameters and
    Adam's moments; ``step()`` runs one iteration."""

    def __init__(self, cfg: dict, temp: float, sigma: float, seed: int,
                 device="cpu", quant=None):
        self.cfg, self.device, self.quant = cfg, torch.device(device), quant
        self.net = N.Net.of(cfg)
        params = N.init_params(self.net, seed)
        self.layout = N.Layout.of(params)
        self.flat = self.layout.flat(params).to(self.device)
        self.m = torch.zeros_like(self.flat)
        self.v = torch.zeros_like(self.flat)
        self.count = 0
        inputs = data.fit_inputs(cfg, seed)
        dev = self.device
        self.z = torch.from_numpy(inputs["z"]).to(dev)
        self.gt = torch.from_numpy(inputs["gt"])[None].to(dev)
        self.task = cfg["task"]
        if self.task == "ct":
            self.radon = R.operator(tuple(R.theta_deg(cfg).tolist()),
                                    int(cfg["imsize"]), str(dev))
            with torch.no_grad():
                self.target = self.radon(self.gt)
        else:
            self.target = torch.from_numpy(inputs["noisy"])[None].to(dev)
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.temp = float(temp)
        self.prior_sigma = float(math.sqrt(temp) * sigma)
        self.lr = float(cfg["lr"])
        self.out_avg = None
        self.it = 0

    def data_loss(self, out: torch.Tensor) -> torch.Tensor:
        if self.task == "ct":
            return torch.mean((self.radon(out) - self.target) ** 2)
        nlv = torch.clamp(out[:, 1:], -20.0, 20.0)
        return torch.mean(torch.exp(nlv) * (self.target - out[:, :1]) ** 2
                          - nlv)

    def transform(self, out: torch.Tensor) -> torch.Tensor:
        if self.task == "ct":
            return out
        return torch.cat([out[:, :1], torch.exp(-out[:, 1:])], dim=1)

    def metrics(self, out_t: torch.Tensor) -> torch.Tensor:
        o = torch.clamp(out_t[:, :1], 0, 1)
        oa = torch.clamp(self.out_avg[:, :1], 0, 1)
        if self.task == "ct":
            mse_c = torch.mean((self.out_avg[:, :1] - self.gt) ** 2)
            p0, s0 = psnr(self.gt, o), ssim(self.gt, o)
            return torch.stack([mse_c, mse_c, p0, p0, psnr(self.gt, oa),
                                s0, s0, ssim(self.gt, oa)])
        mse_c = torch.mean((self.out_avg[:, :1] - self.target) ** 2)
        mse_g = torch.mean((self.out_avg[:, :1] - self.gt) ** 2)
        return torch.stack([
            mse_c, mse_g, psnr(self.target, o), psnr(self.gt, o),
            psnr(self.gt, oa), ssim(self.target, o), ssim(self.gt, o),
            ssim(self.gt, oa)])

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
        out = N.forward(self.net, leaves, x, self.quant)
        loss = self.data_loss(out)
        total = loss + self.temp * kl_reverse(mu, rho, self.prior_sigma)
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
        self.it += 1
        return {"row": row, "grad": grad.detach()}
