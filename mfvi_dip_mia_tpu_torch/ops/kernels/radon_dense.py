"""Dense-matrix Radon operator on hand-written CUDA kernels.

Counterpart of ``mfvi_dip_mia_tpu/ops/pallas/radon_kernel.py``: the dense
projection matrix A (T*W, H*W) stored in bf16 (half the bytes of f32) with
f32 accumulation, and a VJP whose backward streams the same row-major A (a
transpose is never formed). Two kernels (``csrc/radon_dense.cu``):

* ``radon_dense_fwd`` replaces ``_fwd_call``: out[c, p] = sum_q A[p, q] v[c, q]
* ``radon_dense_adj`` replaces ``_bwd_call``: out[c, q] = sum_p A[p, q] g[c, p]

Bound on the card: bytes (A once per call: 1.51 GB at 256^2 / 45 angles).
Both kernels are persistent (two blocks per SM of the card) and stream A
through a shared-memory ring filled by bulk copies; see the source note in
csrc/radon_dense.cu. :func:`dense_plan` cuts A into the blocks'
equal shares (the forward's row ranges, the adjoint's row-range x
column-strip tiles); the kernels receive only those bounds. The TPU module
pads A to its (256, 2048) tiles; that is the TPU's tiling, not semantics,
so A keeps its own shape here (the kernels need H*W % 8 == 0 for their
16-byte copies).

Image columns (batch times channels) lead: v (cols, H*W) and the sinogram
(cols, T*W), so a one-channel image is one contiguous row. Beside each
kernel is its plain PyTorch version (A promoted to f32 in row chunks, one
matmul per chunk); a wrapper takes it only for a tensor on the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import build
from .cf_conv import _tickets
from ...utils.device import device_cache, resolve_device

FWD = build.Kernel(
    "radon_dense_fwd", "mfvi_dip_mia_tpu_torch/csrc/radon_dense.cu",
    "mfvi_dip_mia_tpu/ops/pallas/radon_kernel.py:75 (_fwd_call)")
ADJ = build.Kernel(
    "radon_dense_adj", "mfvi_dip_mia_tpu_torch/csrc/radon_dense.cu",
    "mfvi_dip_mia_tpu/ops/pallas/radon_kernel.py:102 (_bwd_call)")

_CHUNK_BYTES = 256 * 1024 ** 2     # f32 rows of A promoted at a time

# Persistent blocks per SM of both kernels (csrc/radon_dense.cu is compiled
# for two resident blocks): the forward streamed ~1 % faster with two than
# with one, the adjoint the same (sweep_dense_radon.py --grids, PERF.md §6).
BLOCKS_PER_SM = 2
_COLS = 1024                       # columns of A per ring stage (.cu kCols)


def _chunk_rows(a: torch.Tensor) -> int:
    return max(1, _CHUNK_BYTES // (4 * a.shape[1]))


def prepare_matrix_bf16(a_f32, device=None) -> torch.Tensor:
    """The f32 matrix (numpy or tensor) cast to bf16 on ``device`` (the card
    unless the caller asks for the CPU), rounded to nearest even as
    ``jnp.astype`` rounds (radon_kernel.py::prepare_matrix_bf16 without its
    tile padding), a row chunk at a time so the f32 matrix never sits on the
    card whole."""
    device = resolve_device(device)
    a = torch.as_tensor(a_f32)
    out = torch.empty(a.shape, dtype=torch.bfloat16, device=device)
    step = _chunk_rows(a)
    for r in range(0, a.shape[0], step):
        out[r:r + step] = a[r:r + step].to(device).to(torch.bfloat16)
    return out


def _check(a: torch.Tensor, x: torch.Tensor, n: int, what: str) -> None:
    if a.dim() != 2 or x.dim() != 2 or x.shape[1] != n:
        raise ValueError(f"{what}: A {tuple(a.shape)} and operand "
                         f"{tuple(x.shape)} do not match")


def _require(a: torch.Tensor, x: torch.Tensor, what: str) -> None:
    build.require_cuda(a, f"{what} A", (torch.bfloat16,))
    build.require_cuda(x, f"{what} operand", (torch.float32,))
    if a.shape[1] % 8 or a.data_ptr() % 16 or x.data_ptr() % 16:
        raise ValueError(f"{what}: H*W must be a multiple of 8 and the "
                         "operands 16-byte aligned")


# -- the plan: each block's equal share of A ----------------------------------

@dataclasses.dataclass(frozen=True)
class DensePlan:
    """How the two kernels' persistent blocks share A (P, Q).

    Forward: block b owns rows ``rows[b]`` to ``rows[b + 1]`` (whole rows).
    Adjoint: Q is cut into ``n_strips`` column strips of ``strip`` columns
    (the last one narrower); the (strip, row) units, strip-major, are cut
    into ``adj_blocks`` runs of equal length, and each run into tiles at
    strip boundaries. ``tiles[t] = (strip, p0, p1, split, n_split)``: rows
    p0..p1 of the strip, its split-th of n_split tiles in row order; block
    b owns tiles ``tile_ptr[b]`` to ``tile_ptr[b + 1]``. Both kernels walk
    their share once per image column."""
    rows: tuple
    strip: int
    n_strips: int
    tiles: tuple
    tile_ptr: tuple

    @property
    def fwd_blocks(self) -> int:
        return len(self.rows) - 1

    @property
    def adj_blocks(self) -> int:
        return len(self.tile_ptr) - 1


@functools.lru_cache(maxsize=64)
def dense_plan(p: int, q: int, blocks: int) -> DensePlan:
    """The persistent grids of ``radon_dense_fwd`` / ``radon_dense_adj`` for
    A (p, q) on at most ``blocks`` blocks (the wrappers pass BLOCKS_PER_SM
    per SM of the card): each block an equal share of A's bytes, to within
    one row (forward) or one row of a strip (adjoint)."""
    if min(p, q, blocks) < 1 or q % 8:
        raise ValueError(f"no dense plan for A ({p}, {q}) on {blocks} blocks")
    nf = min(p, blocks)
    rows = tuple(b * p // nf for b in range(nf + 1))

    n_strips = -(-q // _COLS)
    strip = -(-q // (8 * n_strips)) * 8          # <= _COLS, a multiple of 8
    units = p * n_strips
    na = min(units, blocks)
    tiles, tile_ptr = [], [0]
    for b in range(na):
        u, end = b * units // na, (b + 1) * units // na
        while u < end:
            s, p0 = divmod(u, p)
            p1 = min(p, p0 + end - u)
            tiles.append([s, p0, p1])
            u += p1 - p0
        tile_ptr.append(len(tiles))
    n_split = [0] * n_strips
    for t in tiles:
        t.append(n_split[t[0]])
        n_split[t[0]] += 1
    return DensePlan(rows, strip, n_strips,
                     tuple(tuple(t) + (n_split[t[0]],) for t in tiles),
                     tuple(tile_ptr))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@device_cache
def _device_plan(p: int, q: int, device: torch.device, blocks: int):
    """The plan with its bounds as int32 tensors on ``device`` (made once):
    the forward's row bounds, and the adjoint's tile_ptr followed by its
    tiles."""
    plan = dense_plan(p, q, blocks)
    adj = list(plan.tile_ptr) + [v for t in plan.tiles for v in t]
    return plan, (torch.tensor(plan.rows, dtype=torch.int32, device=device),
                  torch.tensor(adj, dtype=torch.int32, device=device))


def _card_plan(a: torch.Tensor, x: torch.Tensor):
    """The plan for A on ``x``'s card: BLOCKS_PER_SM blocks per SM."""
    return _device_plan(a.shape[0], a.shape[1], x.device,
                        BLOCKS_PER_SM * _sm_count(x.device))


# -- kernel 10: the forward ----------------------------------------------------

def radon_dense_fwd_plain(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Plain version of ``radon_dense_fwd``: v (cols, Q) f32 -> (cols, P)
    f32, A promoted to f32 a row chunk at a time."""
    _check(a, v, a.shape[1], "radon_dense_fwd")
    out = torch.empty((v.shape[0], a.shape[0]), dtype=torch.float32,
                      device=v.device)
    step = _chunk_rows(a)
    for r in range(0, a.shape[0], step):
        out[:, r:r + step] = v.float() @ a[r:r + step].float().T
    return out


def radon_dense_fwd(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Dense matvec: A (P, Q) bf16, v (cols, Q) f32 -> (cols, P) f32. CUDA
    tensors launch ``radon_dense_fwd`` (BLOCKS_PER_SM blocks per SM); CPU
    tensors take the plain version."""
    _check(a, v, a.shape[1], "radon_dense_fwd")
    if not v.is_cuda:
        return radon_dense_fwd_plain(a, v)
    _require(a, v, "radon_dense_fwd")
    return _launch_fwd(a, v, *_card_plan(a, v))


def _launch_fwd(a, v, plan, tables):
    p, q = a.shape
    out = torch.empty((v.shape[0], p), dtype=torch.float32, device=v.device)
    lib = build.library()
    err = lib.radon_dense_fwd(a.data_ptr(), v.data_ptr(), out.data_ptr(),
                              tables[0].data_ptr(), p, q, v.shape[0],
                              plan.fwd_blocks,
                              ctypes.c_void_p(build.stream_of(v)))
    FWD.count(v)
    build.check(err, FWD.name)
    return out


# -- kernel 11: the adjoint ----------------------------------------------------

def radon_dense_adj_plain(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of ``radon_dense_adj``: g (cols, P) f32 -> (cols, Q)
    f32, summed over row chunks of A promoted to f32."""
    _check(a, g, a.shape[0], "radon_dense_adj")
    out = torch.zeros((g.shape[0], a.shape[1]), dtype=torch.float32,
                      device=g.device)
    step = _chunk_rows(a)
    for r in range(0, a.shape[0], step):
        out += g[:, r:r + step].float() @ a[r:r + step].float()
    return out


def radon_dense_adj(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Dense adjoint: A (P, Q) bf16, g (cols, P) f32 -> (cols, Q) f32,
    streaming the row-major A. CUDA tensors launch ``radon_dense_adj`` (one
    launch, the forward's number of blocks); CPU tensors take the plain
    version."""
    _check(a, g, a.shape[0], "radon_dense_adj")
    if not g.is_cuda:
        return radon_dense_adj_plain(a, g)
    _require(a, g, "radon_dense_adj")
    return _launch_adj(a, g, *_card_plan(a, g))


def _launch_adj(a, g, plan, tables):
    p, q = a.shape
    cols, n_tiles = g.shape[0], len(plan.tiles)
    partial = torch.empty(cols * n_tiles * plan.strip, dtype=torch.float32,
                          device=g.device)
    ticket = _tickets(g.device, cols * plan.n_strips)
    out = torch.empty((cols, q), dtype=torch.float32, device=g.device)
    if g.numel() % 4:
        # the kernel copies g in 16-byte windows: round it up to 4 floats
        g = torch.cat([g.reshape(-1), g.new_zeros(4 - g.numel() % 4)])
    lib = build.library()
    err = lib.radon_dense_adj(a.data_ptr(), g.data_ptr(), partial.data_ptr(),
                              ticket.data_ptr(), out.data_ptr(),
                              tables[1].data_ptr(), p, q, cols,
                              plan.adj_blocks, plan.strip, n_tiles,
                              plan.n_strips,
                              ctypes.c_void_p(build.stream_of(g)))
    ADJ.count(g)
    build.check(err, ADJ.name)
    return out


class _DenseMatvec(torch.autograd.Function):
    """The forward kernel with the adjoint kernel as its backward
    (radon_kernel.py::radon_matmul_pallas and its custom VJP)."""

    @staticmethod
    def forward(ctx, v, a):
        ctx.a = a
        return radon_dense_fwd(a, v)

    @staticmethod
    def backward(ctx, g):
        return radon_dense_adj(ctx.a, g.contiguous()), None


def radon_apply_dense(image: torch.Tensor, a: torch.Tensor,
                      n_angles: int) -> torch.Tensor:
    """(B, C, H, W) image -> (B, C, T, W) sinogram through the bf16 matrix
    (radon_kernel.py::radon_apply_pallas). The image is cast to f32."""
    b, c, h, w = image.shape
    if a.shape != (n_angles * w, h * w):
        raise ValueError(f"matrix {tuple(a.shape)} does not fit a {h}x{w} "
                         f"image and {n_angles} angles")
    v = image.float().reshape(b * c, h * w).contiguous()
    return _DenseMatvec.apply(v, a).reshape(b, c, n_angles, w)
