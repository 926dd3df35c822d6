"""The plain reference of the DIP skip U-Net and its mean-field posterior, in
plain PyTorch (F.conv2d, F.interpolate, explicit BatchNorm), NCHW.

Written from the published description (Ulyanov et al.'s ``skip`` net as the
upstream repository builds it): per level i, on an input of c_i channels,

    skip:   pad -> conv 1x1 (c_i -> s_i)           -> BN -> LeakyReLU(0.2)
    down1:  pad -> conv 3x3, stride 2 (c_i -> d_i) -> BN -> LeakyReLU
    down2:  pad -> conv 3x3 (d_i -> d_i)           -> BN -> LeakyReLU
            [level i + 1]                   (all but the deepest level)
            bilinear x2 upsample (align_corners=False)
            concat(skip, deeper), BN over the concat
    up:     pad -> conv 3x3                       -> BN -> LeakyReLU
    up1x1:  conv 1x1                              -> BN -> LeakyReLU
    out:    conv 1x1 (u_0 -> n_out), no sigmoid

with reflection padding and every conv's bias kept (the program may drop a
bias that a BatchNorm removes; here it stays, as published). BatchNorm is
train mode: the batch's biased moments, eps 1e-5.

Parameters are one dict keyed by leaf path (``levels.0.down1.conv.w``,
``levels.0.down1.bn.scale``, ``out.conv.b``, ...), made in the order the
upstream ``init`` draws them from one seeded CPU generator: every conv's
kernel and then its bias ~ U(+-1/sqrt(fan_in)) (PyTorch's default), then
the MFVI re-initialisation, every conv leaf replaced by mu ~ N(0, 0.1) and
rho ~ N(-3, 0.1), drawn in the dict's order. The flat layout
[mu | rho | det] fixes the order in which one standard-normal vector draws
the whole tree's weights each step.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Site:
    name: str
    c_in: int
    c_out: int
    k: int
    stride: int = 1


@dataclasses.dataclass(frozen=True)
class Net:
    """The static topology of a configuration's net."""
    input_depth: int
    down: tuple
    up: tuple
    skip: tuple
    n_out: int
    filter_size: int = 3

    @staticmethod
    def of(cfg: dict) -> "Net":
        n = cfg["net"]
        return Net(int(cfg["input_depth"]), tuple(n["skip_n33d"]),
                   tuple(n["skip_n33u"]),
                   tuple([n["skip_n11"]] * len(n["skip_n33d"])
                         if isinstance(n["skip_n11"], int) else n["skip_n11"]),
                   int(n["n_out"]), int(n.get("filter_size", 3)))

    @property
    def n_scales(self) -> int:
        return len(self.down)

    def level_sites(self, i: int) -> dict:
        """Level i's conv sites by part ('skip' absent without a skip)."""
        c_in = self.input_depth if i == 0 else self.down[i - 1]
        last = i == self.n_scales - 1
        deeper = self.down[i] if last else self.up[i + 1]
        k = self.filter_size
        p = f"levels.{i}"
        sites = {}
        if self.skip[i]:
            sites["skip"] = Site(f"{p}.skip", c_in, self.skip[i], 1)
        sites["down1"] = Site(f"{p}.down1", c_in, self.down[i], k, 2)
        sites["down2"] = Site(f"{p}.down2", self.down[i], self.down[i], k)
        sites["up"] = Site(f"{p}.up", self.skip[i] + deeper, self.up[i], k)
        sites["up1x1"] = Site(f"{p}.up1x1", self.up[i], self.up[i], 1)
        return sites

    def bn_cat_channels(self, i: int) -> int:
        last = i == self.n_scales - 1
        return self.skip[i] + (self.down[i] if last else self.up[i + 1])

    def out_site(self) -> Site:
        return Site("out", self.up[0], self.n_out, 1)

    def sites(self) -> list:
        """Every conv site in the order of the parameter dict."""
        out = []
        for i in range(self.n_scales):
            out += list(self.level_sites(i).values())
        return out + [self.out_site()]

    def conv_sites(self, size: int) -> list:
        """Every conv site on a ``size`` x ``size`` net input, as a
        reference module's ``conv_sites`` gives them: name, c_in, c_out,
        k, stride, size_in (the side of the site's input) and needs_dx.
        Level 0's skip and down1 read the net input, which needs no
        gradient, so they have no dx."""
        out = []

        def add(s: Site, s_in: int, needs_dx: bool):
            out.append(dict(name=s.name, c_in=s.c_in, c_out=s.c_out, k=s.k,
                            stride=s.stride, size_in=s_in,
                            needs_dx=needs_dx))

        for i in range(self.n_scales):
            lv = self.level_sites(i)
            s_in = size >> i
            if "skip" in lv:
                add(lv["skip"], s_in, i > 0)
            add(lv["down1"], s_in, i > 0)
            add(lv["down2"], s_in // 2, True)
            add(lv["up"], s_in, True)
            add(lv["up1x1"], s_in, True)
        add(self.out_site(), size, True)
        return out


def init_params(net: Net, seed: int) -> dict:
    """The deterministic tree (PyTorch-default conv init) from a CPU
    generator seeded ``seed``, then the MFVI re-initialisation from the same
    generator. Returns {leaf path: CPU float32 tensor} in dict order."""
    gen = torch.Generator().manual_seed(seed)
    params = {}

    def conv(s: Site):
        bound = 1.0 / math.sqrt(s.c_in * s.k * s.k)
        u = torch.rand((s.c_out, s.c_in, s.k, s.k), generator=gen)
        params[f"{s.name}.conv.w"] = u * (2 * bound) - bound
        params[f"{s.name}.conv.b"] = (torch.rand((s.c_out,), generator=gen)
                                      * (2 * bound) - bound)

    def bn(prefix: str, c: int):
        params[f"{prefix}.scale"] = torch.ones(c)
        params[f"{prefix}.offset"] = torch.zeros(c)

    for i in range(net.n_scales):
        sites = net.level_sites(i)
        for part in ("skip", "down1", "down2", "bn_cat", "up", "up1x1"):
            if part == "bn_cat":
                bn(f"levels.{i}.bn_cat", net.bn_cat_channels(i))
            elif part in sites:
                conv(sites[part])
                bn(f"{sites[part].name}.bn", sites[part].c_out)
    conv(net.out_site())

    mfvi = {}
    for name, t in params.items():
        prefix, leaf = name.rsplit(".", 1)
        if leaf in ("w", "b") and f"{prefix}.w" in params:
            mfvi[f"{prefix}.{leaf}_mu"] = 0.0 + 0.1 * torch.randn(
                tuple(t.shape), generator=gen)
            mfvi[f"{prefix}.{leaf}_rho"] = -3.0 + 0.1 * torch.randn(
                tuple(t.shape), generator=gen)
        else:
            mfvi[name] = t
    return mfvi


@dataclasses.dataclass
class Layout:
    """The flat [mu | rho | det] layout of a variational tree."""
    names: list
    shapes: list
    offsets: list
    n_var: int

    @staticmethod
    def of(params: dict) -> "Layout":
        mu = [n for n in params if n.endswith("_mu")]
        rho = [n[:-3] + "_rho" for n in mu]
        det = [n for n in params if not n.endswith(("_mu", "_rho"))]
        names = mu + rho + det
        shapes = [tuple(params[n].shape) for n in names]
        offsets, off = [], 0
        for s in shapes:
            offsets.append(off)
            off += math.prod(s)
        return Layout(names, shapes, offsets,
                      sum(math.prod(params[n].shape) for n in mu))

    def flat(self, params: dict) -> torch.Tensor:
        return torch.cat([params[n].reshape(-1).float() for n in self.names])

    def leaves(self, flat: torch.Tensor) -> dict:
        return {n: flat[o:o + math.prod(s)].view(s)
                for n, s, o in zip(self.names, self.shapes, self.offsets)}


def batch_norm(x: torch.Tensor, scale: torch.Tensor, offset: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    return ((x - mean) * torch.rsqrt(var + eps) * scale[None, :, None, None]
            + offset[None, :, None, None])


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int,
         quant=None) -> torch.Tensor:
    """A conv site: reflection pad (k - 1) / 2, then F.conv2d. ``quant``
    (a ``precision.Rounding``) computes it at a lower precision (the
    control)."""
    p = (w.shape[-1] - 1) // 2
    if p:
        x = F.pad(x, (p, p, p, p), mode="reflect")
    if quant is None:
        return F.conv2d(x, w, b, stride=stride)
    y = F.conv2d(quant.operand(x), quant.operand(w), None, stride=stride)
    return quant.output(y) + b[None, :, None, None]


def forward(net: Net, w: dict, x: torch.Tensor, quant=None) -> torch.Tensor:
    """The net on ``x`` (1, D, H, W) with the drawn weights ``w``
    ({'<site>.conv.w' / '.conv.b', '<bn>.scale' / '.offset'})."""

    def site(s: Site, h: torch.Tensor) -> torch.Tensor:
        h = conv(h, w[f"{s.name}.conv.w"], w[f"{s.name}.conv.b"], s.stride,
                 quant)
        return leaky_relu(batch_norm(h, w[f"{s.name}.bn.scale"],
                                     w[f"{s.name}.bn.offset"]))

    def level(i: int, h_in: torch.Tensor) -> torch.Tensor:
        sites = net.level_sites(i)
        h = site(sites["down2"], site(sites["down1"], h_in))
        if i < net.n_scales - 1:
            h = level(i + 1, h)
        h = F.interpolate(h, scale_factor=2.0, mode="bilinear",
                          align_corners=False)
        if "skip" in sites:
            h = torch.cat([site(sites["skip"], h_in), h], dim=1)
        h = batch_norm(h, w[f"levels.{i}.bn_cat.scale"],
                       w[f"levels.{i}.bn_cat.offset"])
        return site(sites["up1x1"], site(sites["up"], h))

    return conv(level(0, x), w["out.conv.w"], w["out.conv.b"], 1, quant)
