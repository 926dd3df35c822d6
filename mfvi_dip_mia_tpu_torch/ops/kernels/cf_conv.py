"""Channels-first VALID convolution on a hand-written CUDA kernel.

Counterpart of ``mfvi_dip_mia_tpu/ops/pallas/cf_conv.py``. Two kernels
(``csrc/cf_conv.cu``):

* ``cf_conv_fwd`` replaces ``_conv_call``: a VALID stride-1 conv, batch 1,
  square k in {1, 2, 3, 5}, (I, Hp, Wp) x (O, I, k, k) -> (O, H, W), f32 or
  bf16 storage with f32 accumulation, output in the input's dtype. The
  backward's dx runs on the same kernel: a full correlation of the
  (k-1)-zero-padded cotangent with the flipped, I/O-transposed weight.
* ``cf_conv_dw`` replaces ``_dw_call``: the all-tap weight gradient
  dw[o, i, ky, kx] = sum_{y,x} g[o, y, x] * xp[i, y + ky, x + kx] in one pass
  over input and cotangent, f32.

Bound on the card: arithmetic (the sites' FLOPs per byte are far above the
H100's balance). The first version accumulates with FFMA on the CUDA cores
in register tiles; see the source note in csrc/cf_conv.cu.

Every conv site of the U-Net goes through ``conv2d_cf``: stride 2 runs as
space-to-depth parity planes plus one stride-1 VALID conv (``_conv_s2_planes``
in the JAX module) and 1x1 stride 2 as a subsample, so the kernel needs no
stride. The JAX module's "output narrower than 64 lanes -> XLA conv" gate was
about the TPU's lane width, not semantics, so here every site runs the kernel.

Beside each kernel is its plain PyTorch version (im2col + one matmul, the
arithmetic of the TPU kernel's body). A wrapper takes the plain version only
for a tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

FWD = build.Kernel("cf_conv_fwd", "mfvi_dip_mia_tpu_torch/csrc/cf_conv.cu",
                   "mfvi_dip_mia_tpu/ops/pallas/cf_conv.py:104 (_conv_call)")
DW = build.Kernel("cf_conv_dw", "mfvi_dip_mia_tpu_torch/csrc/cf_conv.cu",
                  "mfvi_dip_mia_tpu/ops/pallas/cf_conv.py:239 (_dw_call)")

_DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_SIZES = (1, 2, 3, 5)


def _check_shapes(xp: torch.Tensor, w: torch.Tensor) -> tuple[int, int]:
    if xp.dim() != 3 or w.dim() != 4:
        raise ValueError(f"expected xp (I, Hp, Wp) and w (O, I, kh, kw), got "
                         f"{tuple(xp.shape)} and {tuple(w.shape)}")
    o, i, kh, kw = w.shape
    if i != xp.shape[0]:
        raise ValueError(f"channel mismatch: xp has {xp.shape[0]}, w {i}")
    if kh != kw or kh not in _KERNEL_SIZES:
        raise ValueError(f"square kernel in {_KERNEL_SIZES} expected, got "
                         f"{kh}x{kw}")
    if xp.shape[1] < kh or xp.shape[2] < kw:
        raise ValueError(f"input {tuple(xp.shape)} smaller than the kernel")
    return kh, kw


def _patches(xp: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """(I, Hp, Wp) -> (I*kh*kw, H*W) im2col rows in (i, ky, kx) order."""
    return F.unfold(xp[None], (kh, kw))[0]


# -- kernel 1: the VALID conv --------------------------------------------------

def conv_valid_plain(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of ``cf_conv_fwd``: f32 im2col + one matmul, cast to
    xp's dtype."""
    kh, kw = _check_shapes(xp, w)
    h, wd = xp.shape[1] - kh + 1, xp.shape[2] - kw + 1
    out = w.float().reshape(w.shape[0], -1) @ _patches(xp.float(), kh, kw)
    return out.reshape(w.shape[0], h, wd).to(xp.dtype)


def conv_valid_fwd(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """VALID stride-1 conv: xp (I, Hp, Wp) x w (O, I, k, k) -> (O, H, W) in
    xp's dtype. CUDA tensors launch ``cf_conv_fwd``; CPU tensors take the
    plain version."""
    kh, kw = _check_shapes(xp, w)
    if not xp.is_cuda:
        return conv_valid_plain(xp, w)
    build.require_cuda(xp, "cf_conv_fwd xp", _DTYPES)
    build.require_cuda(w, "cf_conv_fwd w", (xp.dtype,))
    i_ch, hp, wp = xp.shape
    o_ch = w.shape[0]
    out = torch.empty((o_ch, hp - kh + 1, wp - kw + 1), dtype=xp.dtype,
                      device=xp.device)
    lib = build.library()
    err = lib.cf_conv_fwd(xp.data_ptr(), w.data_ptr(), out.data_ptr(),
                          _DTYPE_CODE[xp.dtype], i_ch, hp, wp, o_ch, kh,
                          ctypes.c_void_p(build.stream_of(xp)))
    FWD.launches += 1
    build.check(err, FWD.name)
    return out


# -- kernel 2: the weight gradient ---------------------------------------------

def conv_dw_plain(xp: torch.Tensor, g: torch.Tensor, kh: int,
                  kw: int) -> torch.Tensor:
    """Plain version of ``cf_conv_dw``: (O, H*W) @ patches^T in f32 ->
    (O, I, kh, kw)."""
    o_ch = g.shape[0]
    dw = g.float().reshape(o_ch, -1) @ _patches(xp.float(), kh, kw).T
    return dw.reshape(o_ch, xp.shape[0], kh, kw)


def _dw_splits(hw: int, n_tiles: int) -> tuple[int, int]:
    """Split the H*W reduction so the grid holds ~4 blocks per SM of the
    H100's 132, in whole 64-pixel chunks. Returns (n_split, pix_per_split)."""
    want = max(1, -(-528 // n_tiles))
    per = -(-hw // want)
    per = -(-per // 64) * 64
    return -(-hw // per), per


def conv_dw(xp: torch.Tensor, g: torch.Tensor, kh: int,
            kw: int) -> torch.Tensor:
    """Weight gradient of the VALID conv: xp (I, Hp, Wp), g (O, H, W) ->
    (O, I, kh, kw) f32. CUDA tensors launch ``cf_conv_dw``; CPU tensors take
    the plain version."""
    if not xp.is_cuda:
        return conv_dw_plain(xp, g, kh, kw)
    build.require_cuda(xp, "cf_conv_dw xp", _DTYPES)
    build.require_cuda(g, "cf_conv_dw g", (xp.dtype,))
    if kh != kw or kh not in _KERNEL_SIZES:
        raise ValueError(f"square kernel in {_KERNEL_SIZES} expected")
    i_ch, hp, wp = xp.shape
    o_ch, h, wd = g.shape
    if (h, wd) != (hp - kh + 1, wp - kw + 1):
        raise ValueError(f"cotangent {tuple(g.shape)} does not match xp "
                         f"{tuple(xp.shape)} and a {kh}x{kw} kernel")
    k_tot = i_ch * kh * kw
    n_tiles = -(-k_tot // 32) * -(-o_ch // 32)
    n_split, per = _dw_splits(h * wd, n_tiles)
    partial = torch.empty((n_split, o_ch, k_tot), dtype=torch.float32,
                          device=xp.device)
    out = torch.empty((o_ch, i_ch, kh, kw), dtype=torch.float32,
                      device=xp.device)
    lib = build.library()
    err = lib.cf_conv_dw(xp.data_ptr(), g.data_ptr(), partial.data_ptr(),
                         out.data_ptr(), _DTYPE_CODE[xp.dtype], i_ch, hp, wp,
                         o_ch, kh, n_split, per,
                         ctypes.c_void_p(build.stream_of(xp)))
    DW.launches += 1
    build.check(err, DW.name)
    return out


# -- autograd ------------------------------------------------------------------

def _dx_operands(g: torch.Tensor, w: torch.Tensor):
    """The input gradient of the VALID conv is a full correlation: the VALID
    conv of the cotangent zero-padded by (kh-1, kw-1) with the flipped,
    I/O-transposed weight (cf_conv.py::_bwd). Row and column pads are
    separate, so the kernel's square-tap assumption lives in one place."""
    kh, kw = w.shape[2], w.shape[3]
    gp = F.pad(g, (kw - 1, kw - 1, kh - 1, kh - 1))
    return gp, w.flip(2, 3).transpose(0, 1).contiguous()


def conv_dx(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of the VALID conv on the ``cf_conv_fwd`` kernel."""
    return conv_valid_fwd(*_dx_operands(g, w))


def conv_dx_plain(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version of ``conv_dx``."""
    return conv_valid_plain(*_dx_operands(g, w))


class _ConvValid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xp, w):
        ctx.save_for_backward(xp, w)
        return conv_valid_fwd(xp, w)

    @staticmethod
    def backward(ctx, g):
        xp, w = ctx.saved_tensors
        g = g.to(xp.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv_dx(g, w.to(xp.dtype))
        if ctx.needs_input_grad[1]:
            dw = conv_dw(xp, g, w.shape[2], w.shape[3]).to(w.dtype)
        return dx, dw


def conv_valid(xp: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable VALID conv (cf_conv.py::conv_valid_cf)."""
    return _ConvValid.apply(xp.contiguous(), w.contiguous())


# -- conv-site dispatch (cf_conv.py::conv2d_cf_pallas) -----------------------

def s2_plane_weight(w: torch.Tensor) -> torch.Tensor:
    """(O, C, kh, kw) stride-2 kernel -> (O, 4C, k2, k2) plane kernel: tap
    (dy, dx) of plane (p, q) is the original tap (2dy+p, 2dx+q), zero where
    that exceeds k; channel blocks in the planes' (p*2 + q) order."""
    o, c, kh, kw = w.shape
    k2 = (kh + 1) // 2
    wz = F.pad(w, (0, 2 * k2 - kw, 0, 2 * k2 - kh))
    return (wz.reshape(o, c, k2, 2, k2, 2)        # (O, C, dy, p, dx, q)
            .permute(0, 3, 5, 1, 2, 4)             # (O, p, q, C, dy, dx)
            .reshape(o, 4 * c, k2, k2))


def s2_planes(xs: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """(C, Hs, Ws) -> (4C, m, n) space-to-depth parity planes with enough
    rows and columns for the plane kernel's VALID conv."""
    c = xs.shape[0]
    k2 = (kh + 1) // 2
    h_out = (xs.shape[1] - kh) // 2 + 1
    w_out = (xs.shape[2] - kw) // 2 + 1
    m, n = h_out + k2 - 1, w_out + k2 - 1
    pad_h = max(0, 2 * m - xs.shape[1])
    pad_w = max(0, 2 * n - xs.shape[2])
    if pad_h or pad_w:
        xs = F.pad(xs, (0, pad_w, 0, pad_h))
    xs = xs[:, :2 * m, :2 * n]
    return (xs.reshape(c, m, 2, n, 2)
            .permute(2, 4, 0, 1, 3)                # (p, q, C, m, n)
            .reshape(4 * c, m, n))


def conv_s2_planes(xs: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-2 conv as parity planes + one stride-1 VALID conv at half
    resolution (cf_conv.py::_conv_s2_planes)."""
    kh, kw = w.shape[2], w.shape[3]
    h_out = (xs.shape[1] - kh) // 2 + 1
    w_out = (xs.shape[2] - kw) // 2 + 1
    out = conv_valid(s2_planes(xs, kh, kw), s2_plane_weight(w))
    return out[:, :h_out, :w_out]


def conv2d_cf(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
              stride: int = 1, padding: int = 0,
              pad_mode: str = "zero") -> torch.Tensor:
    """Batch-1 NCHW conv with torch cross-correlation semantics on the VALID
    kernel: x (1, I, H, W), w (O, I, k, k) -> (1, O, H', W').
    ``pad_mode='reflection'`` is torch ReflectionPad2d, applied outside the
    kernel as in the JAX default (its merged one-pad path is off)."""
    if x.dim() != 4 or x.shape[0] != 1:
        raise ValueError(f"batch-1 NCHW input expected, got {tuple(x.shape)}")
    xs = x[0]
    if padding:
        mode = "reflect" if pad_mode == "reflection" else "constant"
        xs = F.pad(xs[None], (padding,) * 4, mode=mode)[0]
    kh = w.shape[2]
    if stride == 1:
        out = conv_valid(xs, w)
    elif stride == 2 and kh == 1:
        out = conv_valid(xs[:, ::2, ::2], w)     # subsampling commutes
    elif stride == 2:
        out = conv_s2_planes(xs, w)
    else:
        raise ValueError(f"stride {stride} not supported")
    out = out[None]
    if b is not None:
        out = out + b[None, :, None, None].to(out.dtype)
    return out
