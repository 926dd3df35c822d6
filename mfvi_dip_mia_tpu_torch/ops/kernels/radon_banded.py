"""Block-banded Radon operator on hand-written CUDA kernels.

Counterpart of ``mfvi_dip_mia_tpu/ops/pallas/radon_banded.py``. The dense
projection matrix A (T*W, H*W) is ~98% zeros; with the image reordered
patch-major, its nonzeros fit one jwin-row window per (angle, patch), so the
operator streams only a (G, T_pad/tchunk, tchunk*jwin, pp) band plus a row
offset ``jlo[t*G + g]`` per block. Two kernels (``csrc/radon_banded.cu``):

* ``radon_banded_fwd`` replaces ``_fwd_call``:
  sino[t*W + jlo + r, c] += sum_p B[g, t, r, p] * v[c, g*pp + p]
* ``radon_banded_adj`` replaces ``_bwd_call``:
  grad[c, g*pp + p] += sum_{t, r} B[g, t, r, p] * gs[t*W + jlo + r, c]

Bound on the card: bytes. Both stream the whole band once per call (188.7 MB
bf16 / 377.5 MB f32 at 256^2, 45 angles, patch 16) at two FLOPs per element;
see the source note in csrc/radon_banded.cu for how they avoid atomics.

The band builder is this package's own numpy copy of
``prepare_banded_direct`` and produces the same bytes. Beside each kernel is
its plain PyTorch version (an explicit band contraction plus an index_add /
gather of the windows); a wrapper takes it only for a tensor on the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from . import build
from ...utils.device import resolve_device

FWD = build.Kernel(
    "radon_banded_fwd", "mfvi_dip_mia_tpu_torch/csrc/radon_banded.cu",
    "mfvi_dip_mia_tpu/ops/pallas/radon_banded.py:287 (_fwd_call)")
ADJ = build.Kernel(
    "radon_banded_adj", "mfvi_dip_mia_tpu_torch/csrc/radon_banded.cu",
    "mfvi_dip_mia_tpu/ops/pallas/radon_banded.py:356 (_bwd_call)")

PATCH = 16            # image patch side (radon_banded.py:50)
TCHUNK = 12           # fallback angle fusion (radon_banded.py:52)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
GCHUNK = 16           # patches per forward block


def auto_jwin(patch: int) -> int:
    """Tightest 8-aligned sinogram window covering a patch's projection
    (radon_banded.py::auto_jwin)."""
    need = int(np.ceil((patch - 1) * np.sqrt(2.0))) + 3 + 7
    return -(-need // 8) * 8


def auto_tchunk(n_angles: int, jwin: int, pp: int, itemsize: int) -> int:
    """Angles per band chunk (radon_banded.py::auto_tchunk); it fixes the
    band's layout, so the port keeps the TPU's choice."""
    best = None
    for tc in range(1, n_angles + 1):
        t_pad = -(-n_angles // tc) * tc
        blk = tc * jwin * pp * itemsize
        if blk < 512 * 1024 or blk > 4 * 1024 * 1024:
            continue
        score = (t_pad, blk < 1024 * 1024, -tc)
        if best is None or score < best[0]:
            best = (score, tc)
    return best[1] if best else min(TCHUNK, n_angles)


@dataclasses.dataclass
class BandedRadonState:
    """``blocks`` (G, T_pad/tchunk, tchunk*jwin, patch*patch) in f32 or bf16;
    ``jlo`` (T_pad*G,) int32 row offsets indexed [t*G + g]."""
    blocks: torch.Tensor
    jlo: torch.Tensor
    n_angles: int
    w: int
    patch: int
    tchunk: int

    @property
    def jwin(self) -> int:
        return self.blocks.shape[2] // self.tchunk

    @property
    def t_pad(self) -> int:
        return self.blocks.shape[1] * self.tchunk


def prepare_banded_numpy(theta_deg, h: int, w: int, itemsize: int = 4):
    """The band straight from the angles, in numpy: same corner and weight
    math as the dense builder (torch affine_grid / grid_sample,
    align_corners=False). Returns (blocks f32, jlo int32, patch, tchunk);
    ``itemsize`` is the storage dtype's, which picks tchunk."""
    theta_rad = np.deg2rad(np.asarray(theta_deg, np.float64))
    n_angles = len(theta_rad)
    patch = PATCH
    jwin = auto_jwin(patch)
    pp = patch * patch
    tchunk = auto_tchunk(n_angles, jwin, pp, itemsize)
    if w < jwin:
        raise ValueError(f"banded mode needs W >= {jwin}, got {w}")
    if h != w or h % patch:
        raise ValueError(f"banded mode needs a square image divisible by "
                         f"{patch}, got {h}x{w}")
    gside = w // patch
    g_count = gside * gside
    t_pad = -(-n_angles // tchunk) * tchunk

    jj = (2.0 * np.arange(w) + 1.0) / w - 1.0
    ii = (2.0 * np.arange(h) + 1.0) / h - 1.0
    x = np.broadcast_to(jj[None, :], (h, w))
    y = np.broadcast_to(ii[:, None], (h, w))
    out_j = np.broadcast_to(np.arange(w)[None, :], (h, w)).ravel()

    blocks = np.zeros((t_pad, g_count, jwin, pp), np.float32)
    jlo = np.zeros((t_pad, g_count), np.int32)

    for t, th in enumerate(theta_rad):
        c, s = np.cos(th), np.sin(th)
        ix = (((c * x - s * y) + 1.0) * w - 1.0) / 2.0
        iy = (((s * x + c * y) + 1.0) * h - 1.0) / 2.0
        x0 = np.floor(ix)
        y0 = np.floor(iy)
        fx = (ix - x0).ravel()
        fy = (iy - y0).ravel()
        x0 = x0.ravel().astype(np.int64)
        y0 = y0.ravel().astype(np.int64)

        gs, js, locs, ws = [], [], [], []
        for dy, dx, wgt in ((0, 0, (1 - fx) * (1 - fy)),
                            (0, 1, fx * (1 - fy)),
                            (1, 0, (1 - fx) * fy),
                            (1, 1, fx * fy)):
            xc, yc = x0 + dx, y0 + dy
            valid = ((xc >= 0) & (xc <= w - 1) & (yc >= 0) & (yc <= h - 1)
                     & (wgt > 0))
            xc, yc, wv = xc[valid], yc[valid], wgt[valid]
            gs.append((yc // patch) * gside + xc // patch)
            js.append(out_j[valid])
            locs.append((yc % patch) * patch + xc % patch)
            ws.append(wv.astype(np.float32))
        g = np.concatenate(gs)
        j = np.concatenate(js)
        loc = np.concatenate(locs)
        wv = np.concatenate(ws)

        jmin = np.full(g_count, w, np.int64)
        jmax = np.full(g_count, -1, np.int64)
        np.minimum.at(jmin, g, j)
        np.maximum.at(jmax, g, j)
        lo = np.clip((jmin // 8) * 8, 0, w - jwin)
        if not (jmax < lo + jwin).all():
            raise AssertionError(f"band wider than jwin at angle {t}")
        jlo[t] = np.where(jmax >= 0, lo, 0)
        np.add.at(blocks[t].reshape(-1),
                  (g * jwin + (j - lo[g])) * pp + loc, wv)

    blocks = (blocks.transpose(1, 0, 2, 3)
              .reshape(g_count, t_pad // tchunk, tchunk * jwin, pp))
    return blocks, jlo.reshape(-1), patch, tchunk


def prepare_banded_direct(theta_deg, h: int, w: int,
                          dtype=torch.float32,
                          device=None) -> BandedRadonState:
    """Device-resident band state (radon_banded.py::prepare_banded_direct)
    on ``device``, the card unless the caller asks for the CPU; a bf16 band
    is the f32 band rounded to nearest even."""
    device = resolve_device(device)
    itemsize = torch.empty((), dtype=dtype).element_size()
    blocks, jlo, patch, tchunk = prepare_banded_numpy(
        theta_deg, h, w, itemsize)
    return BandedRadonState(
        torch.from_numpy(blocks).to(dtype).to(device),
        torch.from_numpy(jlo).to(device), len(theta_deg), w, patch, tchunk)


def patchify(image: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, C, H, W) -> (B*C, G*PP) patch-major pixel matrix (the JAX module's
    cols-leading layout)."""
    b, c, h, w = image.shape
    gside = w // patch
    x = image.reshape(b, c, gside, patch, gside, patch)
    x = x.permute(0, 1, 2, 4, 3, 5)               # (b, c, gy, gx, yl, xl)
    return x.reshape(b * c, gside * gside * patch * patch)


def unpatchify(flat: torch.Tensor, b: int, c: int, h: int, w: int,
               patch: int) -> torch.Tensor:
    """(B*C, G*PP) -> (B, C, H, W); inverse of patchify."""
    gside = w // patch
    x = flat.reshape(b, c, gside, gside, patch, patch)
    x = x.permute(0, 1, 2, 4, 3, 5)               # (b, c, gy, yl, gx, xl)
    return x.reshape(b, c, h, w)


def _window_rows(state: BandedRadonState) -> torch.Tensor:
    """(T_pad, G, jwin) sinogram row of every band row."""
    g_count = state.blocks.shape[0]
    t_pad, jwin, w = state.t_pad, state.jwin, state.w
    jlo = state.jlo.reshape(t_pad, g_count).long()
    t = torch.arange(t_pad, device=jlo.device)[:, None, None]
    r = torch.arange(jwin, device=jlo.device)[None, None, :]
    return t * w + jlo[:, :, None] + r


def _band4(state: BandedRadonState) -> torch.Tensor:
    g_count, _, _, pp = state.blocks.shape
    return state.blocks.float().reshape(g_count, state.t_pad, state.jwin, pp)


# -- kernel 3: the forward -----------------------------------------------------

def radon_fwd_plain(state: BandedRadonState, v: torch.Tensor) -> torch.Tensor:
    """Plain version of ``radon_banded_fwd``: v (cols, G*pp) f32 ->
    (T_pad*W, cols) f32."""
    g_count, _, _, pp = state.blocks.shape
    cols = v.shape[0]
    contrib = torch.einsum("gtrp,cgp->tgrc", _band4(state),
                           v.reshape(cols, g_count, pp))
    sino = torch.zeros(state.t_pad * state.w, cols, dtype=torch.float32,
                       device=v.device)
    return sino.index_add_(0, _window_rows(state).reshape(-1),
                           contrib.reshape(-1, cols))


def _check_band(state: BandedRadonState, what: str) -> None:
    build.require_cuda(state.blocks, f"{what} blocks", tuple(_DTYPE_CODE))
    build.require_cuda(state.jlo, f"{what} jlo", (torch.int32,))
    if state.blocks.shape[3] % 8:
        raise ValueError("patch*patch must be a multiple of 8")


def radon_fwd(state: BandedRadonState, v: torch.Tensor) -> torch.Tensor:
    """Band matvec: v (cols, G*pp) f32 -> (T_pad*W, cols) f32. CUDA tensors
    launch ``radon_banded_fwd``; CPU tensors take the plain version."""
    if not v.is_cuda:
        return radon_fwd_plain(state, v)
    _check_band(state, "radon_banded_fwd")
    build.require_cuda(v, "radon_banded_fwd v", (torch.float32,))
    g_count, _, _, pp = state.blocks.shape
    cols, t_pad, w = v.shape[0], state.t_pad, state.w
    if v.shape[1] != g_count * pp:
        raise ValueError(f"v {tuple(v.shape)} does not match the band")
    n_gc = -(-g_count // GCHUNK)
    partial = torch.empty((cols, n_gc, t_pad * w), dtype=torch.float32,
                          device=v.device)
    out = torch.empty((t_pad * w, cols), dtype=torch.float32, device=v.device)
    lib = build.library()
    err = lib.radon_banded_fwd(
        state.blocks.data_ptr(), state.jlo.data_ptr(), v.data_ptr(),
        partial.data_ptr(), out.data_ptr(), _DTYPE_CODE[state.blocks.dtype],
        g_count, t_pad, state.jwin, pp, w, cols, GCHUNK,
        ctypes.c_void_p(build.stream_of(v)))
    FWD.count(v)
    build.check(err, FWD.name)
    return out


# -- kernel 4: the adjoint -----------------------------------------------------

def radon_adj_plain(state: BandedRadonState,
                    gsino: torch.Tensor) -> torch.Tensor:
    """Plain version of ``radon_banded_adj``: gsino (T_pad*W, cols) f32 ->
    (cols, G*pp) f32."""
    g_count, _, _, pp = state.blocks.shape
    win = gsino[_window_rows(state)]               # (T_pad, G, jwin, cols)
    grad = torch.einsum("gtrp,tgrc->cgp", _band4(state), win)
    return grad.reshape(gsino.shape[1], g_count * pp)


def radon_adj(state: BandedRadonState, gsino: torch.Tensor) -> torch.Tensor:
    """Band adjoint: gsino (T_pad*W, cols) f32 -> (cols, G*pp) f32. CUDA
    tensors launch ``radon_banded_adj``; CPU tensors take the plain
    version."""
    if not gsino.is_cuda:
        return radon_adj_plain(state, gsino)
    _check_band(state, "radon_banded_adj")
    build.require_cuda(gsino, "radon_banded_adj gsino", (torch.float32,))
    g_count, _, _, pp = state.blocks.shape
    t_pad, w = state.t_pad, state.w
    if gsino.shape[0] != t_pad * w:
        raise ValueError(f"gsino {tuple(gsino.shape)} does not match the band")
    cols = gsino.shape[1]
    out = torch.empty((cols, g_count * pp), dtype=torch.float32,
                      device=gsino.device)
    lib = build.library()
    err = lib.radon_banded_adj(
        state.blocks.data_ptr(), state.jlo.data_ptr(), gsino.data_ptr(),
        out.data_ptr(), _DTYPE_CODE[state.blocks.dtype], g_count, t_pad,
        state.jwin, pp, w, cols, ctypes.c_void_p(build.stream_of(gsino)))
    ADJ.count(gsino)
    build.check(err, ADJ.name)
    return out


class _BandedMatvec(torch.autograd.Function):
    """The forward kernel with the adjoint kernel as its backward
    (radon_banded.py::_banded_matvec)."""

    @staticmethod
    def forward(ctx, v, state):
        ctx.state = state
        return radon_fwd(state, v)

    @staticmethod
    def backward(ctx, g):
        return radon_adj(ctx.state, g.contiguous()), None


def radon_apply_banded(image: torch.Tensor,
                       state: BandedRadonState) -> torch.Tensor:
    """(B, C, H, W) image -> (B, C, T, W) sinogram. The image is cast to f32
    before the operator; a bf16 band is promoted to f32 inside the kernel."""
    b, c, h, w = image.shape
    if w != state.w:
        raise ValueError(f"image width {w} != band width {state.w}")
    v = patchify(image.float(), state.patch).contiguous()
    sino = _BandedMatvec.apply(v, state)          # (T_pad*W, B*C)
    sino = sino.reshape(state.t_pad, w, b * c)[:state.n_angles]
    return sino.reshape(state.n_angles, w, b, c).permute(2, 3, 0, 1)
