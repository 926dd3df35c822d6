"""The DIP skip-connection encoder-decoder U-Net (counterpart of
mfvi_dip_mia_tpu/nn/skip.py: the 5-scale skip topology, and the inpainting
task's 6-scale no-skip k5 / k3 net with nearest up and no 1x1 up), NCHW.

  level i (of n scales), input x with c_i channels:
    skip branch (if skip_ch[i] > 0):  conv1x1 -> BN -> act
    deeper:   conv(k_down, stride2) -> BN -> act
              conv(k_down)          -> BN -> act
              [ level i+1 ]                        (except at the deepest)
              upsample x2 (bilinear|nearest)
    join:     concat(skip, deeper)  (center-crop to min spatial size)
              BN(skip_ch + deeper_ch)
              conv(k_up) -> BN -> act
              [conv1x1 -> BN -> act]               (if need1x1_up)
  output:  conv1x1 -> [sigmoid]

Every conv site is pad -> conv -> [dropout]; dropout is MC-style, drawn
from the forward's generator whenever it trains (skip.py:295-305), so MC
dropout (mcd) puts always-on dropout2d on the down and up sites.

The module holds the static topology only; parameters are a flat dict of
tensors keyed by the JAX package's leaf paths (``levels.0.down1.conv.w``,
``levels.0.down1.bn.scale``, ``out.conv.b``, ...), so one forward serves the
deterministic and the sampled-variational trees, and weights move across from
the JAX package by name (utils/bridge.py). Conv kernels are OIHW.

Every stride-1 conv -> BN -> act site on a batch-1 f32 input with k in
{1, 3} runs as one fused block (ops/kernels/fused_block.py), as JAX routes
its channels-first sites (skip.py:325-343); JAX's further W % 128 / H % 8 /
VMEM gate was about the TPU, so at 256^2 the port fuses 20 sites where JAX
fuses 5. The stride-2 down1 sites (k5 ones as k3 parity planes), the k5
stride-1 sites, the bn_cat BatchNorms and every bf16 site keep the conv
kernel + shifted one-pass BN + LeakyReLU chain, and so does
every site with dropout (skip.py:322-343): the dropout sits between the conv
and the BN, so the site keeps its bias and does not fuse. Under mcd only the
skip sites fuse.

``reparam='lrt'`` (local reparameterization) samples every variational conv
site in activation space on the LRT double-conv kernel (nn/var_conv.py): no
site elides its bias and none fuses, since the activation noise sits between
the conv and the BN (skip.py:318-333). The output conv is an LRT site too.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from ..ops.kernels import fused_block
from . import init as init_lib
from . import layers
from .var_conv import apply_conv_leaf, sample_rt_kernel

_CONV_KEYS = ("w", "b", "w_mu", "w_rho", "b_mu", "b_rho")


@dataclasses.dataclass(frozen=True)
class ConvSite:
    """Static description of one conv site."""
    site_id: int
    c_in: int
    c_out: int
    kernel: int
    stride: int = 1
    pad_mode: str = "zero"            # 'zero' | 'reflection'
    bias: bool = True
    dropout_mode: str = "None"        # 'None' | '1d' | '2d'
    dropout_p: float = 0.5


@dataclasses.dataclass(frozen=True)
class _LevelCfg:
    skip_conv: ConvSite | None
    down1: ConvSite
    down2: ConvSite
    up: ConvSite
    up1x1: ConvSite | None
    bn_cat_ch: int
    upsample_mode: str


def _as_list(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) != n:
            raise ValueError(f"expected {n} entries, got {len(v)}")
        return list(v)
    return [v] * n


class SkipNet(nn.Module):
    """Static network description; ``init_params(generator)`` makes the
    parameter dict and ``forward(params, x)`` applies it."""

    def __init__(self, num_input_channels: int = 2,
                 num_output_channels: int = 3,
                 num_channels_down: Sequence[int] = (16, 32, 64, 128, 128),
                 num_channels_up: Sequence[int] = (16, 32, 64, 128, 128),
                 num_channels_skip: Sequence[int] = (4, 4, 4, 4, 4),
                 filter_size_down=3, filter_size_up=3,
                 filter_skip_size: int = 1, need_sigmoid: bool = True,
                 need_bias: bool = True, pad: str = "zero",
                 upsample_mode="nearest", act_fun: str = "LeakyReLU",
                 need1x1_up: bool = True,
                 dropout_mode_down: str = "None", dropout_p_down: float = 0.5,
                 dropout_mode_up: str = "None", dropout_p_up: float = 0.5,
                 dropout_mode_skip: str = "None", dropout_p_skip: float = 0.5,
                 dropout_mode_output: str = "None",
                 dropout_p_output: float = 0.5):
        super().__init__()
        n = len(num_channels_down)
        if not len(num_channels_up) == len(num_channels_skip) == n:
            raise ValueError("channel lists must have one entry per scale")
        if act_fun != "LeakyReLU":
            raise NotImplementedError(f"activation {act_fun!r} is not ported "
                                      "yet (ROADMAP Queue 1 item 6)")
        self.n_scales = n
        self.need_sigmoid = need_sigmoid
        up_modes = _as_list(upsample_mode, n)
        k_down = _as_list(filter_size_down, n)
        k_up = _as_list(filter_size_up, n)

        sid = [0]

        def site(c_in, c_out, k, stride=1, dmode="None", dp=0.5) -> ConvSite:
            s = ConvSite(site_id=sid[0], c_in=c_in, c_out=c_out, kernel=k,
                         stride=stride, pad_mode=pad, bias=need_bias,
                         dropout_mode=dmode, dropout_p=dp)
            sid[0] += 1
            return s

        levels = []
        c_in = num_input_channels
        for i in range(n):
            last = i == n - 1
            deeper_out = num_channels_down[i] if last else num_channels_up[i + 1]
            skip_conv = None
            if num_channels_skip[i] != 0:
                skip_conv = site(c_in, num_channels_skip[i], filter_skip_size,
                                 1, dropout_mode_skip, dropout_p_skip)
            down1 = site(c_in, num_channels_down[i], k_down[i], 2,
                         dropout_mode_down, dropout_p_down)
            down2 = site(num_channels_down[i], num_channels_down[i],
                         k_down[i], 1, dropout_mode_down, dropout_p_down)
            up = site(num_channels_skip[i] + deeper_out, num_channels_up[i],
                      k_up[i], 1, dropout_mode_up, dropout_p_up)
            up1x1 = (site(num_channels_up[i], num_channels_up[i], 1, 1,
                          dropout_mode_up, dropout_p_up)
                     if need1x1_up else None)
            levels.append(_LevelCfg(
                skip_conv=skip_conv, down1=down1, down2=down2, up=up,
                up1x1=up1x1, bn_cat_ch=num_channels_skip[i] + deeper_out,
                upsample_mode=up_modes[i]))
            c_in = num_channels_down[i]
        self.levels = levels
        self.out_conv = site(num_channels_up[0], num_output_channels, 1, 1,
                             dropout_mode_output, dropout_p_output)
        self.num_conv_sites = sid[0]

    # -- init ---------------------------------------------------------------

    def init_params(self, generator: torch.Generator) -> dict:
        """Deterministic parameters with torch-default conv init, in the JAX
        package's SkipNet.init insertion order (CPU tensors)."""
        params = {}

        def conv(prefix, s: ConvSite):
            params[f"{prefix}.conv.w"] = init_lib.conv_kernel_torch_default(
                generator, s.kernel, s.kernel, s.c_in, s.c_out)
            if s.bias:
                params[f"{prefix}.conv.b"] = init_lib.conv_bias_torch_default(
                    generator, s.c_out, s.c_in * s.kernel * s.kernel)

        def bn(prefix, c):
            params[f"{prefix}.scale"] = torch.ones(c)
            params[f"{prefix}.offset"] = torch.zeros(c)

        for i, cfg in enumerate(self.levels):
            p = f"levels.{i}"
            parts = (("skip", cfg.skip_conv), ("down1", cfg.down1),
                     ("down2", cfg.down2), ("bn_cat", None), ("up", cfg.up),
                     ("up1x1", cfg.up1x1))
            for name, s in parts:
                if name == "bn_cat":
                    bn(f"{p}.bn_cat", cfg.bn_cat_ch)
                elif s is not None:
                    conv(f"{p}.{name}", s)
                    bn(f"{p}.{name}.bn", s.c_out)
        conv("out", self.out_conv)
        return params

    # -- forward ------------------------------------------------------------

    @staticmethod
    def _leaf(params: dict, prefix: str) -> dict:
        return {k: params[f"{prefix}.{k}"] for k in _CONV_KEYS
                if f"{prefix}.{k}" in params}

    def _conv_site(self, s: ConvSite, params, prefix, x, generator, training,
                   reparam, dropout_p=None, skip_bias=False):
        out = apply_conv_leaf(self._leaf(params, f"{prefix}.conv"), x,
                              stride=s.stride, padding=(s.kernel - 1) // 2,
                              pad_mode=s.pad_mode, generator=generator,
                              training=training, skip_bias=skip_bias,
                              reparam=reparam, site_id=s.site_id)
        if s.dropout_mode == "None" or not training:
            return out
        if generator is None:
            raise ValueError("dropout needs a generator when training")
        p = s.dropout_p if dropout_p is None else dropout_p
        if s.dropout_mode == "2d":
            return layers.dropout2d(out, p, generator)
        return layers.dropout(out, p, generator)

    def _conv_bn_act(self, s: ConvSite, params, prefix, x, generator,
                     training, reparam, dropout_p):
        # the conv bias is a per-channel constant that the train-mode BN's
        # mean subtraction removes exactly: skip it (skip.py::_conv_bn_act),
        # unless dropout or LRT noise sits between the conv and the BN; such
        # a site does not fuse either
        skip_bias = s.dropout_mode == "None" and reparam != "lrt"
        scale = params[f"{prefix}.bn.scale"]
        offset = params[f"{prefix}.bn.offset"]
        if s.stride == 1 and skip_bias and fused_block.supported(x, s.kernel):
            # the whole chain as one fused block (skip.py:328-343), with the
            # kernel the unfused site would draw, so the RT stream is the same
            w = sample_rt_kernel(self._leaf(params, f"{prefix}.conv"),
                                 generator, training)
            return fused_block.apply_fused(x, w, scale, offset,
                                           pad_mode=s.pad_mode)
        x = self._conv_site(s, params, prefix, x, generator, training,
                            reparam, dropout_p, skip_bias)
        return layers.leaky_relu(layers.batch_norm_train(x, scale, offset))

    def _apply_level(self, params, i, x, generator, training, reparam,
                     dropout_p):
        cfg = self.levels[i]
        p = f"levels.{i}"
        h = self._conv_bn_act(cfg.down1, params, f"{p}.down1", x, generator,
                              training, reparam, dropout_p)
        h = self._conv_bn_act(cfg.down2, params, f"{p}.down2", h, generator,
                              training, reparam, dropout_p)
        if i < self.n_scales - 1:
            h = self._apply_level(params, i + 1, h, generator, training,
                                  reparam, dropout_p)
        h = layers.upsample2x(h, cfg.upsample_mode)
        if cfg.skip_conv is not None:
            s = self._conv_bn_act(cfg.skip_conv, params, f"{p}.skip", x,
                                  generator, training, reparam, dropout_p)
            z = layers.concat_center_crop([s, h])
        else:
            z = h
        z = layers.batch_norm_train(z, params[f"{p}.bn_cat.scale"],
                                    params[f"{p}.bn_cat.offset"])
        z = self._conv_bn_act(cfg.up, params, f"{p}.up", z, generator,
                              training, reparam, dropout_p)
        if cfg.up1x1 is not None:
            z = self._conv_bn_act(cfg.up1x1, params, f"{p}.up1x1", z,
                                  generator, training, reparam, dropout_p)
        return z

    def forward(self, params: dict, x: torch.Tensor, generator=None,
                training: bool = True, reparam: str = "rt",
                dropout_p=None) -> torch.Tensor:
        """x: (1, C, H, W). ``generator`` drives the RT weight draws (or,
        with ``reparam='lrt'``, the activation noise) of a variational tree
        and the dropout masks; a deterministic (or pre-sampled) tree on a
        net without dropout needs none. ``dropout_p`` overrides every
        dropout site's rate, as JAX's ``apply`` does."""
        z = self._apply_level(params, 0, x, generator, training, reparam,
                              dropout_p)
        z = self._conv_site(self.out_conv, params, "out", z, generator,
                            training, reparam, dropout_p)
        return torch.sigmoid(z) if self.need_sigmoid else z


def build_skip_net(input_depth: int, n_channels: int = 3, pad: str = "zero",
                   upsample_mode="nearest", act_fun: str = "LeakyReLU",
                   need_sigmoid: bool = False, skip_n33d=128, skip_n33u=128,
                   skip_n11=4, num_scales: int = 5,
                   **dropout_kwargs) -> SkipNet:
    """get_net() parity constructor (skip.py::build_skip_net);
    ``dropout_kwargs`` are SkipNet's ``dropout_mode_*`` / ``dropout_p_*``."""
    def per_scale(v):
        return [v] * num_scales if isinstance(v, int) else v
    return SkipNet(
        num_input_channels=input_depth, num_output_channels=n_channels,
        num_channels_down=per_scale(skip_n33d),
        num_channels_up=per_scale(skip_n33u),
        num_channels_skip=per_scale(skip_n11),
        upsample_mode=upsample_mode, need_sigmoid=need_sigmoid,
        need_bias=True, pad=pad, act_fun=act_fun, **dropout_kwargs)
