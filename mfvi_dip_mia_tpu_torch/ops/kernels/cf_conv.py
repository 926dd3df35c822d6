"""Channels-first VALID convolution on a hand-written CUDA kernel.

Counterpart of ``mfvi_dip_mia_tpu/ops/pallas/cf_conv.py``. Two kernels
(``csrc/cf_conv.cu``):

* ``cf_conv_fwd`` replaces ``_conv_call``: a VALID stride-1 conv, batch 1,
  square k in {1, 2, 3, 5}, (I, Hp, Wp) x (O, I, k, k) -> (O, H, W), f32 or
  bf16 storage with f32 accumulation, output in the input's dtype. The
  backward's dx runs on the same kernel in its FULL form: a full correlation
  of the unpadded cotangent, read with a virtual (k-1) zero halo, with the
  forward weight flipped and I/O-transposed by indexing.
* ``cf_conv_dw`` replaces ``_dw_call``: the all-tap weight gradient
  dw[o, i, ky, kx] = sum_{y,x} g[o, y, x] * xp[i, y + ky, x + kx] in one pass
  over input and cotangent, f32.

Bound on the card: arithmetic (the sites' FLOPs per byte are far above the
H100's balance), and at the deep sites the number of blocks. Both kernels
are tensor-core GEMMs on csrc/conv_mma.cuh (bf16 mma.sync, f32 as 3xTF32)
over the input staged channels-last in shared memory: ``cf_conv_fwd`` an
implicit GEMM whose tile and cluster split of K ``tile_plan`` picks per
launch, ``cf_conv_dw`` a GEMM over pixels whose tile and split of the
pixels ``dw_plan`` picks, so that every site launches about one block per SM
or more. See the source notes in csrc/.

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
import dataclasses
import functools
import threading

import torch
import torch.nn.functional as F

from .. import pad
from . import build

FWD = build.Kernel("cf_conv_fwd", "mfvi_dip_mia_tpu_torch/csrc/cf_conv.cu",
                   "mfvi_dip_mia_tpu/ops/pallas/cf_conv.py:104 (_conv_call)")
DW = build.Kernel("cf_conv_dw", "mfvi_dip_mia_tpu_torch/csrc/cf_conv.cu",
                  "mfvi_dip_mia_tpu/ops/pallas/cf_conv.py:239 (_dw_call)")

_DTYPES = (torch.float32, torch.bfloat16)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_SIZES = (1, 2, 3, 5)


# -- the tile plan of the tensor-core kernels (csrc/conv_mma.cuh) -------------

SMS = 132                 # the H100's streaming multiprocessors
MAX_SPLIT = 8             # blocks of a cluster (the portable maximum)
TILE_W = 16               # output columns of a tile row (one m16 fragment)
# (M pixels, N channels) of conv_mma::with_tile's tiles, by index
TILES = ((128, 64), (64, 64), (128, 32), (64, 32), (256, 16), (128, 16),
         (64, 16))
CHUNK_BYTES = 32          # input channels per K chunk: 16 bf16 or 8 f32
# The plan's cost model (constants fitted to sweep_conv_plans.py's device
# times; see its --fit). An SM that runs k blocks of a launch does k times
# a block's warp instructions -- per chunk of its busiest rank, a staged
# 32-byte row (slab position or weight row) and a (16 pixels x 8 channels x
# tap) product in bf16 (mma.sync + ldmatrix) or as 3xTF32 (three MMAs and
# the operand splits); per block the leader's reads of the other ranks'
# partial values -- issued by at most 4 warps at once
# (its schedulers), and waits out a chunk's copies once per chunk of each
# round of co-resident blocks.
_CHUNK_LATENCY = 100.0
_ROW_COST = 1.0
_MMA_COST = {2: 3.0, 4: 1.0}
_REMOTE_COST = 4.0
_SMEM_PER_SM = 232448
_REGS_PER_SM = 65536


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """One launch of the implicit GEMM: output tiles of ``rows`` x TILE_W
    pixels x ``bn`` channels on a (split, m_tiles, n_tiles) grid; the
    ``split`` blocks of a cluster share an output tile and take K chunks
    rank, rank + split, ... of ``chunks``."""
    tile: int
    split: int
    rows: int
    bn: int
    m_tiles: int
    n_tiles: int
    chunks: int

    @property
    def ctas(self) -> int:
        return self.split * self.m_tiles * self.n_tiles

    def chunks_of(self, rank: int) -> range:
        return range(rank, self.chunks, self.split)


def chunk_channels(dtype: torch.dtype) -> int:
    return CHUNK_BYTES // dtype.itemsize


def _plan(tile: int, split: int, h_out: int, w_out: int, n: int,
          chunks: int) -> TilePlan:
    bm, bn = TILES[tile]
    rows = bm // TILE_W
    return TilePlan(tile, split, rows, bn,
                    -(-h_out // rows) * -(-w_out // TILE_W), -(-n // bn),
                    chunks)


def _cost(p: TilePlan, k: int, n_weights: int, itemsize: int) -> float:
    """Estimated time of the launch in the cost model's units."""
    bm = p.rows * TILE_W
    nf = 4 if p.bn >= 32 else 2
    warps = (bm // 32) * (p.bn // (8 * nf))
    rows = ((p.rows + k - 1) * (TILE_W + k - 1) + n_weights * p.bn * k * k)
    mma = n_weights * (bm // 16) * (p.bn // 8) * k * k
    stage = rows * CHUNK_BYTES
    ring = 2 if itemsize == 2 else max(2, min(4, 100 * 1024 // stage))
    smem = max(ring * stage, n_weights * bm * p.bn * 4 if p.split > 1 else 0)
    regs = 128 if nf == 4 or n_weights == 2 else 96
    per_sm = max(1, min(2048 // (32 * warps), 32, _SMEM_PER_SM // smem,
                        _REGS_PER_SM // (regs * 32 * warps)))
    busiest = -(-p.chunks // p.split)
    block = (busiest * (_ROW_COST * rows + _MMA_COST[itemsize] * mma)
             + _REMOTE_COST * n_weights * bm * p.bn / 32 * (p.split - 1))
    k_sm = -(-p.ctas // SMS)
    issue = min(4, warps * min(k_sm, per_sm))
    return (k_sm * block / issue
            + -(-k_sm // per_sm) * busiest * _CHUNK_LATENCY)


@functools.lru_cache(maxsize=None)
def tile_plan(h_out: int, w_out: int, n: int, i: int, dtype: torch.dtype,
              k: int = 3, n_weights: int = 1) -> TilePlan:
    """The tile and the split of K of one launch: output (n, h_out, w_out)
    from i input channels, k x k taps, ``n_weights`` contractions (2 for the
    LRT double conv). Of the plans that launch at least min(132, the
    smallest tile's blocks) blocks, the one the cost model rates fastest:
    larger tiles stage fewer rows per product, a cluster split of K fills
    the card at the deep sites. Tiles wider than the channels (beyond 16)
    are not taken. Cached: a step asks for the same few shapes every time."""
    chunks = -(-i // chunk_channels(dtype))
    smallest = min(range(len(TILES)), key=lambda t: TILES[t][0] * TILES[t][1])
    floor = min(SMS, _plan(smallest, 1, h_out, w_out, n, chunks).ctas)
    plans = [_plan(t, s, h_out, w_out, n, chunks)
             for t, (_, bn) in enumerate(TILES) if bn <= max(16, n)
             for s in (1, 2, 4, 8) if s <= min(MAX_SPLIT, chunks)]
    return min((p for p in plans if p.ctas >= floor),
               key=lambda p: (_cost(p, k, n_weights, dtype.itemsize),
                              p.split))


# -- the plan of the tensor-core weight gradient (conv_mma.cuh's dw tile) -----

DW_ROWS = 8               # pixel rows of a dw pixel tile (x TILE_W columns)
# (WM, WN, WK) warps of conv_mma::with_dw_tile's tiles, by index: BO = 16 WM
# output channels x BC = 16 WN input channels, WK warps sharing the rows.
# Of six tiles up to 64 x 32 that sweep_conv_plans.py --dw timed, the fitted
# plan took only these two at the nets' sites.
DW_TILES = ((1, 1, 4), (2, 1, 2))
# splits of the pixel tiles: a cluster of min(8, split) blocks, and
# split / 8 groups of clusters beyond 8
DW_SPLITS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512)
# The dw plan's cost model (constants fitted to sweep_conv_plans.py --dw's
# device times; see its --fit), in the shape of tile_plan's: per pixel
# tile of a block's busiest split, a staged 32-byte row and a (16 output
# channels x 8 channels x 16 pixels x tap) product (bf16: one mma.sync and
# its share of ldmatrix; f32: six TF32 MMAs, their operand splits and
# 32-bit B loads); per block the leader's reads of the other ranks' sums
# (32 floats each); a pixel tile's copies waited out once per round of
# co-resident blocks; and, on the critical path, the last leader's reads of
# every group's sum (one round trip to L2 per group).
_DW_LATENCY = 300.0
_DW_MMA_COST = {2: 0.3, 4: 1.0}
_DW_GLOBAL_COST = 300.0


@dataclasses.dataclass(frozen=True)
class DwPlan:
    """One launch of the weight gradient: output tiles of ``bo`` output x
    ``bc`` input channels x ``tap_rows`` rows of taps on a (split, tiles)
    grid; the split = cluster x groups blocks of an output tile take pixel
    tiles s, s + split, ... of ``pixel_tiles`` (DW_ROWS x TILE_W each)."""
    tile: int
    cluster: int
    groups: int
    bo: int
    bc: int
    tap_rows: int
    o_tiles: int
    c_tiles: int
    tap_groups: int
    pixel_tiles: int

    @property
    def split(self) -> int:
        return self.cluster * self.groups

    @property
    def tiles(self) -> int:
        return self.o_tiles * self.c_tiles * self.tap_groups

    @property
    def ctas(self) -> int:
        return self.split * self.tiles

    def pixel_tiles_of(self, s: int) -> range:
        return range(s, self.pixel_tiles, self.split)

    def partial_floats(self, k: int) -> int:
        """The second level's scratch: one sum per group and output tile."""
        if self.groups == 1:
            return 0
        return self.tiles * self.groups * self.bo * self.bc * self.tap_rows * k


def _dw_plan(tile: int, cluster: int, groups: int, h: int, w: int, o: int,
             i: int, k: int) -> DwPlan:
    wm, wn, _ = DW_TILES[tile]
    rows = k if k <= 3 else 1
    return DwPlan(tile, cluster, groups, 16 * wm, 16 * wn, rows,
                  -(-o // (16 * wm)), -(-i // (16 * wn)), k // rows,
                  -(-h // DW_ROWS) * -(-w // TILE_W))


def _dw_cost(p: DwPlan, k: int, itemsize: int) -> float:
    """Estimated time of the launch in the cost model's units."""
    wm, wn, wk = DW_TILES[p.tile]
    warps = wm * wn * wk
    taps = p.tap_rows * k
    rows = (p.bc * itemsize // CHUNK_BYTES * (DW_ROWS + p.tap_rows - 1)
            * (TILE_W + k - 1) + DW_ROWS * p.bo * itemsize // 2)
    mma = DW_ROWS * taps * (p.bo // 16) * (p.bc // 8)
    stage = rows * CHUNK_BYTES
    ring = 2 if itemsize == 2 else max(2, min(4, 100 * 1024 // stage))
    values = p.bo * p.bc * taps
    red = max(wk - 1, 1 if p.cluster > 1 else 0) * values * 4
    smem = max(ring * stage, red)
    regs = 40 + 8 * taps + (16 if itemsize == 4 else 0)
    per_sm = max(1, min(2048 // (32 * warps), 32, _SMEM_PER_SM // smem,
                        _REGS_PER_SM // (regs * 32 * warps)))
    ppb = -(-p.pixel_tiles // p.split)
    block = (ppb * (_ROW_COST * rows + _DW_MMA_COST[itemsize] * mma)
             + _REMOTE_COST * values / 32 * (p.cluster - 1))
    k_sm = -(-p.ctas // SMS)
    issue = min(4, warps * min(k_sm, per_sm))
    tail = _DW_GLOBAL_COST * p.groups if p.groups > 1 else 0.0
    return (k_sm * block / issue + -(-k_sm // per_sm) * ppb * _DW_LATENCY
            + tail)


def dw_candidates(h: int, w: int, o: int, i: int, k: int) -> list[DwPlan]:
    """The plans dw_plan chooses among: the tiles no wider than the channels
    (beyond 16; tile 0 alone for k = 5) at every split up to the pixel
    tiles."""
    n_pt = -(-h // DW_ROWS) * -(-w // TILE_W)
    tiles = [0] if k == 5 else [
        t for t, (wm, wn, _) in enumerate(DW_TILES)
        if 16 * wm <= max(16, -(-o // 16) * 16)
        and 16 * wn <= max(16, -(-i // 16) * 16)]
    return [_dw_plan(t, min(MAX_SPLIT, s), max(1, s // MAX_SPLIT), h, w, o,
                     i, k)
            for t in tiles for s in DW_SPLITS if s <= n_pt]


@functools.lru_cache(maxsize=None)
def dw_plan(h: int, w: int, o: int, i: int, dtype: torch.dtype,
            k: int = 3) -> DwPlan:
    """The tile and the split of one weight-gradient launch: cotangent
    (o, h, w), i input channels, k x k taps. Of the plans that launch at
    least min(132, the most blocks the smallest tile can have) blocks, the
    one the cost model rates fastest: larger tiles stage fewer rows per
    product; splitting the pixels fills the card, by a cluster (at most 8,
    summed through distributed shared memory) and then by groups of 8-block
    clusters (summed by the last to arrive). Tiles wider than the channels
    (beyond 16) are not taken; k = 5 runs tile 0, one row of taps per
    block. Cached."""
    plans = dw_candidates(h, w, o, i, k)
    floor = min(SMS, max(p.ctas for p in plans if p.tile == 0))
    return min((p for p in plans if p.ctas >= floor),
               key=lambda p: (_dw_cost(p, k, dtype.itemsize), p.split))


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
    _launch_fwd(xp, w, out, i_ch, o_ch, kh, full=False)
    return out


def _launch_fwd(x: torch.Tensor, w: torch.Tensor, out: torch.Tensor,
                i_ch: int, o_ch: int, k: int, full: bool) -> None:
    plan = tile_plan(out.shape[1], out.shape[2], o_ch, i_ch, x.dtype, k)
    lib = build.library()
    err = lib.cf_conv_fwd(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                          _DTYPE_CODE[x.dtype], i_ch, x.shape[1], x.shape[2],
                          o_ch, k, int(full), plan.tile, plan.split,
                          ctypes.c_void_p(build.stream_of(x)))
    FWD.count(x)
    build.check(err, FWD.name)


# -- kernel 2: the weight gradient ---------------------------------------------

def conv_dw_plain(xp: torch.Tensor, g: torch.Tensor, kh: int,
                  kw: int) -> torch.Tensor:
    """Plain version of ``cf_conv_dw``: (O, H*W) @ patches^T in f32 ->
    (O, I, kh, kw)."""
    o_ch = g.shape[0]
    dw = g.float().reshape(o_ch, -1) @ _patches(xp.float(), kh, kw).T
    return dw.reshape(o_ch, xp.shape[0], kh, kw)


# (device, stream) -> every ticket buffer made for it, the newest last
_TICKETS: dict = {}
_TICKETS_LOCK = threading.Lock()


def _tickets(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` ticket counters for a launch on ``device``'s current
    stream: zero, and left zero by every launch (the last block of an
    output tile resets its counter), so one buffer serves every launch on
    that stream, in stream order. The buffers are keyed by (device,
    stream): launches on two streams at once never share counters (the dw
    kernels here, fused_block.py's and radon_dense.py's adjoint), and a
    graph captured on a stream, replayed on it, shares them only with that
    stream's work. A buffer is never freed or replaced: a larger one is
    added beside it, since a live graph holds the pointer it was captured
    with. A capture must find its buffer made by the warm-up; it raises
    otherwise."""
    key = (device, build.stream_of_device(device))
    made = _TICKETS.get(key)
    if made is None or made[-1].numel() < n:
        with _TICKETS_LOCK:
            made = _TICKETS.setdefault(key, [])
            if not made or made[-1].numel() < n:
                if torch.cuda.is_current_stream_capturing():
                    raise RuntimeError(
                        f"a capture needs {n} dw tickets on {key}, which no "
                        "warm-up made: run the captured work eagerly on the "
                        "capture stream first")
                made.append(torch.zeros(max(4096, n), dtype=torch.int32,
                                        device=device))
    return made[-1]


def conv_dw(xp: torch.Tensor, g: torch.Tensor, kh: int,
            kw: int) -> torch.Tensor:
    """Weight gradient of the VALID conv: xp (I, Hp, Wp), g (O, H, W) ->
    (O, I, kh, kw) f32. CUDA tensors launch ``cf_conv_dw`` (one launch);
    CPU tensors take the plain version."""
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
    plan = dw_plan(h, wd, o_ch, i_ch, xp.dtype, kh)
    out = torch.empty((o_ch, i_ch, kh, kw), dtype=torch.float32,
                      device=xp.device)
    partial = (torch.empty(plan.partial_floats(kh), dtype=torch.float32,
                           device=xp.device) if plan.groups > 1 else out)
    ticket = _tickets(xp.device, plan.tiles)
    lib = build.library()
    err = lib.cf_conv_dw(xp.data_ptr(), g.data_ptr(), partial.data_ptr(),
                         ticket.data_ptr(), out.data_ptr(),
                         _DTYPE_CODE[xp.dtype], i_ch, hp, wp, o_ch, kh,
                         plan.tile, plan.cluster, plan.groups,
                         ctypes.c_void_p(build.stream_of(xp)))
    DW.count(xp)
    build.check(err, DW.name)
    return out


# -- autograd ------------------------------------------------------------------

def _dx_operands(g: torch.Tensor, w: torch.Tensor):
    """The input gradient of the VALID conv is a full correlation: the VALID
    conv of the cotangent zero-padded by (kh-1, kw-1) with the flipped,
    I/O-transposed weight (cf_conv.py::_bwd), as the plain version forms it.
    Row and column pads are separate, so the square-tap assumption lives in
    the kernel's wrapper alone."""
    kh, kw = w.shape[2], w.shape[3]
    gp = F.pad(g, (kw - 1, kw - 1, kh - 1, kh - 1))
    return gp, w.flip(2, 3).transpose(0, 1).contiguous()


def conv_dx(g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Input gradient of the VALID conv: g (O, H, W), w (O, I, k, k) ->
    (I, H+k-1, W+k-1). CUDA tensors launch ``cf_conv_fwd``'s FULL form on g
    and w as they are (no padded or flipped copy); CPU tensors take the
    plain version."""
    if not g.is_cuda:
        return conv_dx_plain(g, w)
    build.require_cuda(g, "cf_conv_fwd g", _DTYPES)
    build.require_cuda(w, "cf_conv_fwd w", (g.dtype,))
    o_ch, i_ch, kh, kw = w.shape
    if g.dim() != 3 or g.shape[0] != o_ch:
        raise ValueError(f"cotangent {tuple(g.shape)} does not match w "
                         f"{tuple(w.shape)}")
    if kh != kw or kh not in _KERNEL_SIZES:
        raise ValueError(f"square kernel in {_KERNEL_SIZES} expected, got "
                         f"{kh}x{kw}")
    out = torch.empty((i_ch, g.shape[1] + kh - 1, g.shape[2] + kw - 1),
                      dtype=g.dtype, device=g.device)
    _launch_fwd(g, w, out, o_ch, i_ch, kh, full=True)
    return out


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
    ``pad_mode='reflection'`` is torch ReflectionPad2d (``ops/pad.py``, with
    a deterministic adjoint), applied outside the kernel as in the JAX
    default (its merged one-pad path is off); else zeros."""
    if x.dim() != 4 or x.shape[0] != 1:
        raise ValueError(f"batch-1 NCHW input expected, got {tuple(x.shape)}")
    xs = x[0]
    if padding:
        xs = (pad.reflection_pad(xs, padding) if pad_mode == "reflection"
              else F.pad(xs, (padding,) * 4))
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
