"""Local-reparameterization (LRT) convolution on a hand-written CUDA kernel.

Counterpart of ``mfvi_dip_mia_tpu/ops/pallas/lrt_conv_pallas.py`` (the kernel)
and ``mfvi_dip_mia_tpu/ops/pallas/lrt_conv.py`` (the sampled conv). The LRT
forward of a conv site needs two convolutions over the same input patches
(ref BayTorch/modules/reparam_layers.py:58-72):

    act_mu  = conv(x,   w_mu)                + b_mu
    act_var = conv(x^2, softplus(w_rho)^2)   + softplus(b_rho)^2
    out     = act_mu + sqrt(1e-16 + act_var) * eps

One kernel (``csrc/lrt_conv.cu``), ``lrt_conv_fwd``, replaces
``_double_conv_fwd``: both VALID stride-1 contractions from one read of the
padded input, batch 1, square k in {1, 2, 3, 5}, f32 or bf16 storage with f32
accumulation, outputs in the input's dtype: the tensor-core implicit GEMM of
csrc/conv_mma.cuh with a w_mu and a w_var operand (f32 as 3xTF32), on the
tile and cluster split of K that ``cf_conv.tile_plan`` picks. Bound on the
card: arithmetic, and at the deep sites the number of blocks (see the source
note). Its backward is the TPU module's XLA formulas
(lrt_conv_pallas.py::_vjp_bwd) on the VALID conv's dx and dw kernels
(ops/kernels/cf_conv.py).

The reflection or zero pad runs once, before the kernel:
reflect(x)^2 == reflect(x^2), so the squared stream needs no pad of its own
(nn/cf.py:212-213). Stride-2 sites run the same kernel on space-to-depth
parity planes with the plane kernels of both weights; squaring commutes with
the plane shuffle and with its zero fill, so every LRT site of the U-Net is
one launch. JAX keeps its stride-2 sites and the shapes its TPU gate refuses
(``supported``: H_out % 8, W_out >= 16, W_out % 8, a 48 MB VMEM budget) and
every k = 5 site (lrt_conv_pallas.py:63) on the block-diagonal XLA conv, the
same function; those gates are the TPU's, so here every site with k in
{1, 3, 5} runs the kernel (the inpainting net's k5 sites: stride 1 as it
is, stride 2 as k3 parity planes). At k = 5 a stage holds the 12 x 20 halo'd
slab and both 5 x 5 weight tiles, 107-110 KB at the 64-wide tiles, so the
ring is 2 stages, within a block's 227 KB.

Beside the kernel is its plain PyTorch version, ``fused_double_conv`` (the
counterpart of ``_fused_double_conv`` without its block-diagonal zeros). The
wrapper takes it only for a tensor on the CPU; for a CUDA tensor it launches
the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import pad
from . import build
from . import cf_conv as tcf

FWD = build.Kernel(
    "lrt_conv_fwd", "mfvi_dip_mia_tpu_torch/csrc/lrt_conv.cu",
    "mfvi_dip_mia_tpu/ops/pallas/lrt_conv_pallas.py:75 (_double_conv_fwd)")

_DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_SIZES = (1, 2, 3, 5)


def _check_shapes(xp: torch.Tensor, w_mu: torch.Tensor,
                  w_var: torch.Tensor) -> int:
    if w_var.shape != w_mu.shape:
        raise ValueError(f"w_mu {tuple(w_mu.shape)} and w_var "
                         f"{tuple(w_var.shape)} differ")
    kh, kw = tcf._check_shapes(xp, w_mu)
    if kh not in _KERNEL_SIZES:
        raise ValueError(f"square kernel in {_KERNEL_SIZES} expected, got "
                         f"{kh}x{kw}")
    return kh


def fused_double_conv(xp: torch.Tensor, w_mu: torch.Tensor,
                      w_var: torch.Tensor):
    """Plain version of ``lrt_conv_fwd``: (conv(xp, w_mu), conv(xp^2,
    w_var)), VALID, in f32 (x^2 of the f32 value), each cast to xp's
    dtype."""
    _check_shapes(xp, w_mu, w_var)
    x = xp.float()
    act_mu = tcf.conv_valid_plain(x, w_mu.float())
    act_var = tcf.conv_valid_plain(x * x, w_var.float())
    return act_mu.to(xp.dtype), act_var.to(xp.dtype)


def double_conv_fwd(xp: torch.Tensor, w_mu: torch.Tensor,
                    w_var: torch.Tensor):
    """xp (C, Hp, Wp), w_mu / w_var (O, C, k, k) -> (act_mu, act_var), each
    (O, Hp-k+1, Wp-k+1) in xp's dtype. CUDA tensors launch
    ``lrt_conv_fwd``; CPU tensors take the plain version."""
    k = _check_shapes(xp, w_mu, w_var)
    if not xp.is_cuda:
        return fused_double_conv(xp, w_mu, w_var)
    build.require_cuda(xp, "lrt_conv_fwd xp", _DTYPES)
    build.require_cuda(w_mu, "lrt_conv_fwd w_mu", (xp.dtype,))
    build.require_cuda(w_var, "lrt_conv_fwd w_var", (xp.dtype,))
    c, hp, wp = xp.shape
    o = w_mu.shape[0]
    act_mu = torch.empty((o, hp - k + 1, wp - k + 1), dtype=xp.dtype,
                         device=xp.device)
    act_var = torch.empty_like(act_mu)
    plan = tcf.tile_plan(hp - k + 1, wp - k + 1, o, c, xp.dtype, k, 2)
    lib = build.library()
    err = lib.lrt_conv_fwd(xp.data_ptr(), w_mu.data_ptr(), w_var.data_ptr(),
                           act_mu.data_ptr(), act_var.data_ptr(),
                           _DTYPE_CODE[xp.dtype], c, hp, wp, o, k, plan.tile,
                           plan.split, ctypes.c_void_p(build.stream_of(xp)))
    FWD.count(xp)
    build.check(err, FWD.name)
    return act_mu, act_var


class _LrtDoubleConv(torch.autograd.Function):
    """The forward kernel; the backward is lrt_conv_pallas.py::_vjp_bwd on
    the padded input: dxp = conv_dx(g_mu, w_mu) + 2 xp conv_dx(g_var, w_var),
    dw_mu = conv_dw(xp, g_mu), dw_var = conv_dw(xp^2, g_var)."""

    @staticmethod
    def forward(ctx, xp, w_mu, w_var):
        ctx.save_for_backward(xp, w_mu, w_var)
        return double_conv_fwd(xp, w_mu, w_var)

    @staticmethod
    def backward(ctx, g_mu, g_var):
        xp, w_mu, w_var = ctx.saved_tensors
        g_mu = g_mu.to(xp.dtype).contiguous()
        g_var = g_var.to(xp.dtype).contiguous()
        k = w_mu.shape[2]
        dx = dw_mu = dw_var = None
        if ctx.needs_input_grad[0]:
            dx = (tcf.conv_dx(g_mu, w_mu.to(xp.dtype))
                  + 2.0 * xp * tcf.conv_dx(g_var, w_var.to(xp.dtype)))
        if ctx.needs_input_grad[1]:
            dw_mu = tcf.conv_dw(xp, g_mu, k, k).to(w_mu.dtype)
        if ctx.needs_input_grad[2]:
            dw_var = tcf.conv_dw((xp * xp).contiguous(), g_var, k,
                                 k).to(w_var.dtype)
        return dx, dw_mu, dw_var


def lrt_double_conv(xp: torch.Tensor, w_mu: torch.Tensor,
                    w_var: torch.Tensor):
    """Differentiable (conv(xp, w_mu), conv(xp^2, w_var)), VALID stride 1
    (lrt_conv_pallas.py::lrt_double_conv_pallas on a pre-padded input)."""
    return _LrtDoubleConv.apply(xp.contiguous(), w_mu.contiguous(),
                                w_var.contiguous())


def double_conv(xs: torch.Tensor, w_mu: torch.Tensor, w_var: torch.Tensor,
                stride: int = 1):
    """(conv(xs, w_mu), conv(xs^2, w_var)) of a padded (C, Hs, Ws) input at
    stride 1 or 2, one ``lrt_conv_fwd`` launch: stride 2 runs as parity
    planes with the plane kernels of both weights (cf_conv.py::
    conv2d_cf's routing), 1x1 stride 2 as a subsample."""
    kh, kw = w_mu.shape[2], w_mu.shape[3]
    if stride == 1:
        return lrt_double_conv(xs, w_mu, w_var)
    if stride == 2 and kh == 1:
        return lrt_double_conv(xs[:, ::2, ::2], w_mu, w_var)
    if stride == 2:
        h_out = (xs.shape[1] - kh) // 2 + 1
        w_out = (xs.shape[2] - kw) // 2 + 1
        act_mu, act_var = lrt_double_conv(
            tcf.s2_planes(xs, kh, kw), tcf.s2_plane_weight(w_mu),
            tcf.s2_plane_weight(w_var))
        return act_mu[:, :h_out, :w_out], act_var[:, :h_out, :w_out]
    raise ValueError(f"stride {stride} not supported")


def lrt_conv(x: torch.Tensor, w_mu: torch.Tensor, w_rho: torch.Tensor,
             b_mu: torch.Tensor | None, b_rho: torch.Tensor | None,
             stride: int, padding: int, pad_mode: str,
             eps: torch.Tensor) -> torch.Tensor:
    """The LRT sampled conv of one site (lrt_conv.py::lrt_conv), batch-1
    NCHW: x (1, C, H, W), OIHW weights, ``eps`` the standard-normal
    activation noise of the output's shape (1, O, H', W'). ``pad_mode``
    'reflection' is torch ReflectionPad2d, else zeros. The variances are
    formed in the weights' dtype, as JAX forms them in the compute dtype."""
    if x.dim() != 4 or x.shape[0] != 1:
        raise ValueError(f"batch-1 NCHW input expected, got {tuple(x.shape)}")
    xs = x[0]
    if padding:
        xs = (pad.reflection_pad(xs, padding) if pad_mode == "reflection"
              else F.pad(xs, (padding,) * 4))
    act_mu, act_var = double_conv(xs, w_mu, F.softplus(w_rho) ** 2, stride)
    act_mu, act_var = act_mu[None], act_var[None]
    if b_mu is not None:
        act_mu = act_mu + b_mu[None, :, None, None].to(act_mu.dtype)
        act_var = act_var + (F.softplus(b_rho) ** 2)[None, :, None, None].to(
            act_var.dtype)
    if eps.shape != act_mu.shape:
        raise ValueError(f"eps {tuple(eps.shape)} does not match the output "
                         f"{tuple(act_mu.shape)}")
    return act_mu + torch.sqrt(1e-16 + act_var) * eps.to(act_mu.dtype)
