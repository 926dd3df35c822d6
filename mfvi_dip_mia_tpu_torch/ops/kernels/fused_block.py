"""Fused 'same' conv + train-mode BatchNorm + LeakyReLU on hand-written CUDA
kernels (counterpart of ``mfvi_dip_mia_tpu/ops/pallas/fused_block.py``).

Four kernels (``csrc/fused_block.cu``), in f32 as the TPU block is, and in
bf16 (below):

* ``fused_block_fwd`` replaces ``_fwd_call``: a VALID conv of the padded
  input (k in {1, 3}) on the tensor cores (csrc/conv_mma.cuh's tile, 3xTF32,
  ``FWD_TILE``), BatchNorm over H*W with the exact two-pass
  biased variance, LeakyReLU with ``y > 0``; returns (out, stats = [mu,
  inv]).
* ``fused_block_bwd_dc`` replaces ``_bwd_dc_call``: dconv, dgamma and dbeta
  with xhat recomputed from the block output (LeakyReLU inverted by sign, a
  safe reciprocal of gamma), so the conv output is never stored. One
  ordinary cluster launch on ``dc_plan``'s plan: a channel's slices held in
  its cluster's shared memory, its sums met in rank order.
* ``fused_block_bwd_dw`` replaces ``_bwd_dw_call``: the weight gradient, on
  csrc/conv_mma.cuh's dw tile (3xTF32, the pixels split over a cluster and
  groups of clusters, ``dw_plan``), as ``cf_conv_dw`` in f32.
* ``fused_block_bwd_dx`` replaces ``_bwd_dx_call``: the gradient of the
  padded input, a full correlation of dconv with the flipped, I/O-transposed
  kernel, on conv_mma.cuh's FULL tile (3xTF32, ``dx_plan``): the zero halo
  is applied by bounds in the kernel and the flip by indexing.

Layouts are the port's: the padded input xp (Ci, H+k-1, W+k-1) and OIHW
kernels, where the TPU kernel took a lane-aligned (Ci, H+8, Wp) input and a
tap-major weight matrix. The TPU's ``supported()`` gate (W % 128, H % 8, a
VMEM budget) was about its tiling and VMEM, not semantics, so every f32 or
bf16 batch-1 site with k in {1, 3} fuses (``supported``). Neither the
block's on/off switch nor its MXU-precision knob has a counterpart: on the
card a wrapper launches its kernel or raises.

bf16, which the TPU block never took (the port's bf16 fits convolve in bf16
with f32 master parameters): the same four kernels on bf16 operands, each a
template of the f32 one, chosen by the input's dtype. Every operand of a
call (xp, w, gamma, beta; g and out; dconv) is of one dtype, the site's;
``stats`` is f32. The sums, the statistics and the BN / LeakyReLU
arithmetic are f32 (the forward keeps its f32 conv output in a scratch
buffer), and each output is rounded to bf16 once: out, dconv, dgamma,
dbeta, the weight gradient (f32 sums, as ``cf_conv_dw``'s, cast as the
unfused site casts them) and dx. The conv tiles are the bf16 ones
``cf_conv`` runs (``FWD_TILE_BF16``; ``dw_plan`` / ``dx_plan`` at bf16),
and ``dc_plan`` plans bf16 slices on 2 bytes a value.

Beside each kernel is its plain PyTorch version, which repeats the TPU
kernel's arithmetic (the conv as unfold + matmul) in f32 on f32-widened
operands, rounding each output to the operands' dtype once; a wrapper takes
it only for a tensor on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import pad
from . import build
from . import cf_conv as tcf
from .cf_conv import DwPlan, TilePlan, _plan, chunk_channels

_SRC = "mfvi_dip_mia_tpu_torch/csrc/fused_block.cu"
_TPU = "mfvi_dip_mia_tpu/ops/pallas/fused_block.py"
FWD = build.Kernel("fused_block_fwd", _SRC, f"{_TPU}:127 (_fwd_call)")
DC = build.Kernel("fused_block_bwd_dc", _SRC, f"{_TPU}:212 (_bwd_dc_call)")
DW = build.Kernel("fused_block_bwd_dw", _SRC, f"{_TPU}:280 (_bwd_dw_call)")
DX = build.Kernel("fused_block_bwd_dx", _SRC, f"{_TPU}:326 (_bwd_dx_call)")

SLOPE = 0.2
EPS = 1e-5
KERNEL_SIZES = (1, 3)
_F32 = (torch.float32,)
_FWD_PIX = 2048         # pixels of one forward BN work item (csrc kFwdPix)


def supported(x: torch.Tensor, k: int) -> bool:
    """Whether a stride-1 conv -> BN -> LeakyReLU site on ``x`` (1, Ci, H, W)
    with a k x k kernel runs as the fused block: batch 1, f32 or bf16, k in
    {1, 3} (fused_block.py:463-465, which also takes f32 alone)."""
    return (x.dim() == 4 and x.shape[0] == 1 and x.dtype in tcf._DTYPES
            and k in KERNEL_SIZES)


def _one_dtype(kernel: str, **tensors) -> torch.dtype:
    """The dtype every one of ``tensors`` has, f32 or bf16; raises on a mix
    or on any other dtype, whatever the device."""
    dtypes = {t.dtype for t in tensors.values()}
    if len(dtypes) != 1 or not dtypes <= set(tcf._DTYPES):
        raise ValueError(f"{kernel}: expected {', '.join(tensors)} of one "
                         f"dtype in {tcf._DTYPES}, got "
                         + ", ".join(f"{n} {t.dtype}"
                                     for n, t in tensors.items()))
    return dtypes.pop()


def _require_cuda(kernel: str, **tensors) -> None:
    for what, t in tensors.items():
        build.require_cuda(t, f"{kernel} {what}")


def _check(xp: torch.Tensor, w: torch.Tensor) -> int:
    if xp.dim() != 3 or w.dim() != 4 or w.shape[1] != xp.shape[0]:
        raise ValueError(f"expected xp (Ci, Hp, Wp) and w (Co, Ci, k, k), got "
                         f"{tuple(xp.shape)} and {tuple(w.shape)}")
    k = w.shape[2]
    if w.shape[3] != k or k not in KERNEL_SIZES:
        raise ValueError(f"square kernel in {KERNEL_SIZES} expected, got "
                         f"{w.shape[2]}x{w.shape[3]}")
    if xp.shape[1] < k or xp.shape[2] < k:
        raise ValueError(f"input {tuple(xp.shape)} smaller than the kernel")
    return k


def _lib_stream(t: torch.Tensor):
    return build.library(), ctypes.c_void_p(build.stream_of(t))


# -- kernel 1: forward ---------------------------------------------------------

# The forward's conv tile: 128 pixels x 16 channels (cf_conv.py::TILES[5]).
# sweep_conv_plans.py --dw timed every tile at the 20 fused sites of the
# 256^2 den net: 128x16 was the fastest at 16 of them and within 1 % of the
# best tile per site in sum. The cooperative grid walks the tiles, so there
# is no split of K.
FWD_TILE = 5
# The bf16 forward's tile (16-channel chunks, one MMA a product where f32
# takes three): 256 pixels x 16 channels (TILES[4]). Timed at the same 20
# sites on an H100 (the profiler's device time, the sum over the sites):
# 256x16 0.408 ms, within 1 % of the best tile per site (0.406), where
# f32's 128x16 took 0.433.
FWD_TILE_BF16 = 4


def fwd_plan(h: int, w: int, co: int, ci: int, k: int,
             dtype: torch.dtype = torch.float32) -> TilePlan:
    """The conv tile of the forward at an (h, w) output of co channels from
    ci input channels of ``dtype`` (k x k taps: the tile does not depend on
    it)."""
    tile = FWD_TILE if dtype == torch.float32 else FWD_TILE_BF16
    return _plan(tile, 1, h, w, co, -(-ci // chunk_channels(dtype)))


def fwd_plain(xp, w, gamma, beta, slope=SLOPE, eps=EPS):
    """Plain version of ``fused_block_fwd``: (out (Co, H, W) in xp's dtype,
    stats (Co, 2) f32)."""
    k = _check(xp, w)
    co = w.shape[0]
    h, wd = xp.shape[1] - k + 1, xp.shape[2] - k + 1
    inv_hw = 1.0 / (h * wd)
    c = (w.float().reshape(co, -1) @ F.unfold(xp.float()[None], k)[0]
         ).reshape(co, h, wd)
    mu = c.sum(dim=(1, 2)) * inv_hw
    d = c - mu[:, None, None]
    var = (d * d).sum(dim=(1, 2)) * inv_hw
    inv = torch.rsqrt(var + eps)
    y = (d * inv[:, None, None] * gamma.float()[:, None, None]
         + beta.float()[:, None, None])
    return (torch.where(y > 0, y, slope * y).to(xp.dtype),
            torch.stack([mu, inv], dim=1))


def fwd(xp, w, gamma, beta, slope=SLOPE, eps=EPS):
    """conv + BN + LeakyReLU of the padded input xp (Ci, H+k-1, W+k-1) with
    w (Co, Ci, k, k), gamma and beta (Co,), all of one dtype: (out (Co, H, W)
    in it, stats (Co, 2) = [mu, inv] in f32). CUDA tensors launch
    ``fused_block_fwd``; CPU tensors take the plain version."""
    k = _check(xp, w)
    dtype = _one_dtype(FWD.name, xp=xp, w=w, gamma=gamma, beta=beta)
    if not xp.is_cuda:
        return fwd_plain(xp, w, gamma, beta, slope, eps)
    _require_cuda(FWD.name, xp=xp, w=w, gamma=gamma, beta=beta)
    ci, hp, wp = xp.shape
    co = w.shape[0]
    h, wd = hp - k + 1, wp - k + 1
    out = torch.empty((co, h, wd), dtype=dtype, device=xp.device)
    stats = torch.empty((co, 2), dtype=torch.float32, device=xp.device)
    plan = fwd_plan(h, wd, co, ci, k, dtype)
    # bf16: the f32 conv output (f32 stores it in out); then the per-tile
    # channel sums of the conv and the per-chunk centred squares
    n_conv = 0 if dtype == torch.float32 else co * h * wd
    part_sum = n_conv + plan.m_tiles * co
    part = torch.empty(part_sum + co * -(-(h * wd) // _FWD_PIX),
                       dtype=torch.float32, device=xp.device)
    conv = out if n_conv == 0 else part
    lib, st = _lib_stream(xp)
    err = lib.fused_block_fwd(
        xp.data_ptr(), w.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        conv.data_ptr(), out.data_ptr(), stats.data_ptr(),
        part[n_conv:].data_ptr(), part[part_sum:].data_ptr(),
        tcf._DTYPE_CODE[dtype], ci, h, wd, co, k, plan.tile, 1.0 / (h * wd),
        slope, eps, st)
    FWD.count(xp)
    build.check(err, FWD.name)
    return out, stats


# -- kernel 2: dconv, dgamma, dbeta ----------------------------------------------

def bwd_dc_plain(g, out, stats, gamma, beta, slope=SLOPE):
    """Plain version of ``fused_block_bwd_dc``: (dconv, dgamma, dbeta), f32
    sums, dconv in out's dtype, dgamma and dbeta in gamma's."""
    dtype, leaf = out.dtype, gamma.dtype
    g, out = g.float(), out.float()
    h, wd = out.shape[1], out.shape[2]
    inv_hw = 1.0 / (h * wd)
    ga, be = gamma.float()[:, None, None], beta.float()[:, None, None]
    inv = stats[:, 1, None, None]
    rg = 1.0 / torch.where(ga.abs() < 1e-20, torch.full_like(ga, 1e-20), ga)
    mask = out > 0
    xhat = (torch.where(mask, out, out * (1.0 / slope)) - be) * rg
    gp = torch.where(mask, g, slope * g)
    s1 = gp.sum(dim=(1, 2))
    s2 = (gp * xhat).sum(dim=(1, 2))
    m1 = (s1 * inv_hw)[:, None, None]
    m2 = (s2 * inv_hw)[:, None, None]
    return ((inv * ga * (gp - m1 - xhat * m2)).to(dtype), s2.to(leaf),
            s1.to(leaf))


# The dc kernel's plan depends on the shape alone (so do its bits): one wave
# of an H100 SXM's 132 SMs is the target on any card.
DC_SMS = 132
DC_THREADS = 256        # a block's threads (csrc conv_tile::kThreads)
DC_MAX_CLUSTER = 8      # blocks sharing one channel at most (portable size)
DC_MAX_CPB = DC_THREADS // 32   # channels per block at most: a warp each
DC_MIN_PIX = 1024       # a block's pixels before a channel is split, and
                        # the most a block of several channels takes
DC_SMEM = 224 * 1024    # dynamic shared memory per block (csrc kDcSmemMax)
DC_CHUNK_PIX = 2048     # pixels of one bulk copy at least (8 KB of g or out)
DC_MAX_CHUNKS = 4       # bulk copies per slice at most (csrc kDcMaxChunks)


class DcPlan(NamedTuple):
    """How ``fused_block_bwd_dc`` cuts a (co, hw) site: ``cluster`` blocks
    share one channel, rank r taking pixels [r * length, (r + 1) * length),
    or one block takes ``cpb`` whole channels; the first ``res`` pixels of
    each slice are resident in shared memory (``smem`` bytes a block: g and
    out, ``itemsize`` bytes a value), bulk-copied in ``chunks`` pieces."""
    cluster: int
    cpb: int
    length: int
    res: int
    chunks: int
    blocks: int
    smem: int


@functools.lru_cache(maxsize=None)
def dc_plan(co: int, hw: int, itemsize: int = 4) -> DcPlan:
    """The plan of ``fused_block_bwd_dc`` at co channels of hw pixels of
    ``itemsize`` bytes (4: f32, 2: bf16): a channel split over as many
    blocks (1-8, a cluster) as fill one wave with at least DC_MIN_PIX pixels
    each, more where a slice would not fit in shared memory; an unsplit
    channel of at most DC_MIN_PIX / 2 pixels shares its block with others
    (2, 4 or 8 channels, as many as keep the block within DC_MIN_PIX
    pixels). Slices are multiples of 16 bytes of pixels (4 f32, 8 bf16), so
    each starts on a 16-byte boundary where hw is such a multiple; a
    resident slice is copied in one piece per DC_CHUNK_PIX pixels, up to
    four, so the sums start before the last piece lands."""
    q = 16 // itemsize          # pixels of 16 bytes
    px = 2 * itemsize           # shared memory a resident pixel: g and out

    def rq(n):
        return -(-n // q) * q

    cluster = max(1, min(DC_MAX_CLUSTER, DC_SMS // co, hw // DC_MIN_PIX))
    while (cluster < DC_MAX_CLUSTER
           and px * rq(-(-hw // cluster)) > DC_SMEM):
        cluster += 1
    cpb = 1
    while cluster == 1 and cpb < DC_MAX_CPB and 2 * cpb * hw <= DC_MIN_PIX:
        cpb *= 2
    length = rq(-(-hw // cluster))
    res = min(length, DC_SMEM // (px * cpb) // q * q)
    chunks = max(1, min(DC_MAX_CHUNKS, res // DC_CHUNK_PIX))
    return DcPlan(cluster, cpb, length, res, chunks,
                  -(-co // cpb) * cluster, cpb * px * res)


def bwd_dc(g, out, stats, gamma, beta, slope=SLOPE):
    """The BN + LeakyReLU backward from the block output: (dconv (Co, H, W),
    dgamma (Co,), dbeta (Co,)), in the dtype of g, out, gamma and beta (one
    dtype; stats f32). CUDA tensors launch ``fused_block_bwd_dc`` (one
    cluster launch on ``dc_plan``'s plan, no scratch; the C entry takes the
    bulk copies where H*W is a multiple of 16 bytes of pixels and g, out and
    dconv are 16-byte aligned)."""
    if g.shape != out.shape or out.dim() != 3:
        raise ValueError(f"g {tuple(g.shape)} and out {tuple(out.shape)} "
                         "must be the same (Co, H, W)")
    dtype = _one_dtype(DC.name, g=g, out=out, gamma=gamma, beta=beta)
    if not out.is_cuda:
        return bwd_dc_plain(g, out, stats, gamma, beta, slope)
    _require_cuda(DC.name, g=g, out=out, gamma=gamma, beta=beta)
    build.require_cuda(stats, f"{DC.name} stats", _F32)
    co, h, wd = out.shape
    plan = dc_plan(co, h * wd, dtype.itemsize)
    dc = torch.empty_like(out)
    dgb = torch.empty((2, co), dtype=dtype, device=out.device)
    lib, st = _lib_stream(out)
    err = lib.fused_block_bwd_dc(
        g.data_ptr(), out.data_ptr(), stats.data_ptr(), gamma.data_ptr(),
        beta.data_ptr(), dc.data_ptr(), dgb.data_ptr(),
        tcf._DTYPE_CODE[dtype], co, h * wd, plan.cluster, plan.cpb,
        plan.length, plan.res, plan.chunks, 1.0 / (h * wd), slope,
        1.0 / slope, st)
    DC.count(out)
    build.check(err, DC.name)
    return (dc, *dgb.unbind())


# -- kernel 3: the weight gradient -------------------------------------------------

def dw_plan(h: int, w: int, co: int, ci: int, k: int,
            dtype: torch.dtype = torch.float32) -> DwPlan:
    """The dw tile and pixel split of ``fused_block_bwd_dw`` at an (h, w)
    dconv of co channels and ci input channels of ``dtype``:
    ``cf_conv_dw``'s plan, whose tile it runs."""
    return tcf.dw_plan(h, w, co, ci, dtype, k)


def bwd_dw_plain(dc, xp, k):
    """Plain version of ``fused_block_bwd_dw``: (Co, Ci, k, k), f32 sums in
    dc's dtype."""
    co = dc.shape[0]
    dw = dc.float().reshape(co, -1) @ F.unfold(xp.float()[None], k)[0].T
    return dw.reshape(co, xp.shape[0], k, k).to(dc.dtype)


def bwd_dw(dc, xp, k):
    """Weight gradient from dconv (Co, H, W) and the padded input xp
    (Ci, H+k-1, W+k-1), both of one dtype, in it. CUDA tensors launch
    ``fused_block_bwd_dw`` (one launch on the tensor cores, the plan of
    ``dw_plan``)."""
    ci, hp, wp = xp.shape
    co, h, wd = dc.shape
    if k not in KERNEL_SIZES or (h, wd) != (hp - k + 1, wp - k + 1):
        raise ValueError(f"dconv {tuple(dc.shape)} does not match xp "
                         f"{tuple(xp.shape)} and a {k}x{k} kernel")
    dtype = _one_dtype(DW.name, dc=dc, xp=xp)
    if not xp.is_cuda:
        return bwd_dw_plain(dc, xp, k)
    _require_cuda(DW.name, xp=xp, dc=dc)
    plan = dw_plan(h, wd, co, ci, k, dtype)
    dw = torch.empty((co, ci, k, k), dtype=dtype, device=xp.device)
    # the groups' sums (f32); unread with one group
    partial = (torch.empty(plan.partial_floats(k), dtype=torch.float32,
                           device=xp.device) if plan.groups > 1 else dw)
    ticket = tcf._tickets(xp.device, plan.tiles)
    lib, st = _lib_stream(xp)
    err = lib.fused_block_bwd_dw(xp.data_ptr(), dc.data_ptr(),
                                 partial.data_ptr(), ticket.data_ptr(),
                                 dw.data_ptr(), tcf._DTYPE_CODE[dtype], ci,
                                 h, wd, co, k, plan.tile, plan.cluster,
                                 plan.groups, st)
    DW.count(xp)
    build.check(err, DW.name)
    return dw


# -- kernel 4: the input gradient ----------------------------------------------------

def dx_plan(h: int, w: int, co: int, ci: int, k: int,
            dtype: torch.dtype = torch.float32) -> TilePlan:
    """The tile and split of K of ``fused_block_bwd_dx`` at an (h, w) dconv
    of co channels of ``dtype``: the FULL conv's plan, an (h+k-1, w+k-1)
    output of ci channels from co, as ``cf_conv.conv_dx`` launches it."""
    return tcf.tile_plan(h + k - 1, w + k - 1, ci, co, dtype, k)


def bwd_dx_plain(dc, w):
    """Plain version of ``fused_block_bwd_dx``: the (k-1)-zero-padded dconv
    correlated with the flipped, I/O-transposed kernel, (Ci, H+k-1, W+k-1),
    f32 sums in dc's dtype."""
    co, ci, k, _ = w.shape
    h, wd = dc.shape[1], dc.shape[2]
    dcp = F.pad(dc.float(), (k - 1,) * 4)
    wf = w.float().flip(2, 3).transpose(0, 1).reshape(ci, -1)
    return (wf @ F.unfold(dcp[None], k)[0]).reshape(
        ci, h + k - 1, wd + k - 1).to(dc.dtype)


def bwd_dx(dc, w):
    """Gradient of the padded input from dconv (Co, H, W) and w
    (Co, Ci, k, k), both of one dtype, in it. CUDA tensors launch
    ``fused_block_bwd_dx`` (the FULL conv on the tensor cores on dc and w as
    stored, the plan of ``dx_plan``)."""
    co, ci, k, _ = w.shape
    if dc.dim() != 3 or dc.shape[0] != co or k not in KERNEL_SIZES:
        raise ValueError(f"dconv {tuple(dc.shape)} and w {tuple(w.shape)}")
    dtype = _one_dtype(DX.name, dc=dc, w=w)
    if not dc.is_cuda:
        return bwd_dx_plain(dc, w)
    _require_cuda(DX.name, dc=dc, w=w)
    h, wd = dc.shape[1], dc.shape[2]
    plan = dx_plan(h, wd, co, ci, k, dtype)
    dx = torch.empty((ci, h + k - 1, wd + k - 1), dtype=dtype,
                     device=dc.device)
    lib, st = _lib_stream(dc)
    err = lib.fused_block_bwd_dx(dc.data_ptr(), w.data_ptr(), dx.data_ptr(),
                                 tcf._DTYPE_CODE[dtype], co, h, wd, ci, k,
                                 plan.tile, plan.split, st)
    DX.count(dc)
    build.check(err, DX.name)
    return dx


# -- autograd and the site entry point ----------------------------------------------

class _FusedBlock(torch.autograd.Function):
    """fused_block.py::conv_bn_lrelu_cf: the residuals are the padded input,
    the kernel, gamma, beta, the output and [mu, inv]; no conv output. Every
    gradient comes back in its input's dtype (the kernels' own)."""

    @staticmethod
    def forward(ctx, xp, w, gamma, beta, slope, eps):
        out, stats = fwd(xp, w, gamma, beta, slope, eps)
        ctx.save_for_backward(xp, w, gamma, beta, out, stats)
        ctx.slope = slope
        return out

    @staticmethod
    def backward(ctx, g):
        xp, w, gamma, beta, out, stats = ctx.saved_tensors
        dc, dgamma, dbeta = bwd_dc(g.contiguous(), out, stats, gamma, beta,
                                   ctx.slope)
        dx = bwd_dx(dc, w) if ctx.needs_input_grad[0] else None
        dw = bwd_dw(dc, xp, w.shape[2]) if ctx.needs_input_grad[1] else None
        return dx, dw, dgamma, dbeta, None, None


def conv_bn_lrelu(xp, w, gamma, beta, slope=SLOPE, eps=EPS):
    """Differentiable fused block on the padded input xp (Ci, H+k-1, W+k-1)
    -> (Co, H, W)."""
    return _FusedBlock.apply(xp.contiguous(), w.contiguous(),
                             gamma.contiguous(), beta.contiguous(), slope, eps)


def apply_fused(x, w, gamma, beta, *, pad_mode="reflection", slope=SLOPE,
                eps=EPS):
    """(1, Ci, H, W) -> (1, Co, H, W): 'same' conv with w (Co, Ci, k, k),
    k in {1, 3}, + train-mode BN + LeakyReLU (fused_block.py::apply_fused),
    x, w, gamma and beta of one dtype, f32 or bf16. The reflection (or zero)
    pad runs before the kernel, as JAX's jnp.pad does; the reflection pad's
    adjoint is ``ops/pad.py``'s deterministic fold."""
    k = w.shape[2]
    if (not supported(x, k) or w.shape[3] != k
            or {w.dtype, gamma.dtype, beta.dtype} != {x.dtype}):
        raise ValueError(f"the fused block takes a batch-1 f32 or bf16 input "
                         f"and a square kernel in {KERNEL_SIZES}, with w, "
                         f"gamma and beta of its dtype, got x "
                         f"{tuple(x.shape)} {x.dtype}, w {tuple(w.shape)} "
                         f"{w.dtype}, gamma {gamma.dtype}, beta {beta.dtype}")
    p = (k - 1) // 2
    if p:
        x = (pad.reflection_pad(x, p) if pad_mode == "reflection"
             else F.pad(x, (p,) * 4))
    return conv_bn_lrelu(x[0], w, gamma, beta, slope, eps)[None]
