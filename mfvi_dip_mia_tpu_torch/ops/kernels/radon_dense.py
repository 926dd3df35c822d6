"""Dense-matrix Radon operator on hand-written CUDA kernels.

Counterpart of ``mfvi_dip_mia_tpu/ops/pallas/radon_kernel.py``: the dense
projection matrix A (T*W, H*W) stored in bf16 (half the bytes of f32) with
f32 accumulation, and a VJP whose backward streams the same row-major A (a
transpose is never formed). Two kernels (``csrc/radon_dense.cu``):

* ``radon_dense_fwd`` replaces ``_fwd_call``: out[c, p] = sum_q A[p, q] v[c, q]
* ``radon_dense_adj`` replaces ``_bwd_call``: out[c, q] = sum_p A[p, q] g[c, p]

Bound on the card: bytes (A once per call: 1.51 GB at 256^2 / 45 angles);
see the source note in csrc/radon_dense.cu. The TPU module pads A to its
(256, 2048) tiles; that is the TPU's tiling, not semantics, so A keeps its
own shape here (the kernels need H*W % 8 == 0 for their 16-byte loads).

Image columns (batch times channels) lead: v (cols, H*W) and the sinogram
(cols, T*W), so a one-channel image is one contiguous row. Beside each
kernel is its plain PyTorch version (A promoted to f32 in row chunks, one
matmul per chunk); a wrapper takes it only for a tensor on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import build
from ...utils.device import resolve_device

FWD = build.Kernel(
    "radon_dense_fwd", "mfvi_dip_mia_tpu_torch/csrc/radon_dense.cu",
    "mfvi_dip_mia_tpu/ops/pallas/radon_kernel.py:75 (_fwd_call)")
ADJ = build.Kernel(
    "radon_dense_adj", "mfvi_dip_mia_tpu_torch/csrc/radon_dense.cu",
    "mfvi_dip_mia_tpu/ops/pallas/radon_kernel.py:102 (_bwd_call)")

_CHUNK_BYTES = 256 * 1024 ** 2     # f32 rows of A promoted at a time
_STRIP = 256 * 8                   # q columns per adjoint block (.cu kStrip)


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
    tensors launch ``radon_dense_fwd``; CPU tensors take the plain
    version."""
    _check(a, v, a.shape[1], "radon_dense_fwd")
    if not v.is_cuda:
        return radon_dense_fwd_plain(a, v)
    _require(a, v, "radon_dense_fwd")
    p, q = a.shape
    cols = v.shape[0]
    out = torch.empty((cols, p), dtype=torch.float32, device=v.device)
    lib = build.library()
    err = lib.radon_dense_fwd(a.data_ptr(), v.data_ptr(), out.data_ptr(), p,
                              q, cols, ctypes.c_void_p(build.stream_of(v)))
    FWD.launches += 1
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


def _adj_splits(p: int, q: int) -> tuple[int, int]:
    """Split the P reduction so the grid holds ~4 blocks per SM of the
    H100's 132. Returns (n_split, rows_per_split)."""
    strips = -(-q // _STRIP)
    want = max(1, min(p, -(-528 // strips)))
    per = -(-p // want)
    return -(-p // per), per


def radon_dense_adj(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Dense adjoint: A (P, Q) bf16, g (cols, P) f32 -> (cols, Q) f32,
    streaming the row-major A. CUDA tensors launch ``radon_dense_adj``; CPU
    tensors take the plain version."""
    _check(a, g, a.shape[0], "radon_dense_adj")
    if not g.is_cuda:
        return radon_dense_adj_plain(a, g)
    _require(a, g, "radon_dense_adj")
    p, q = a.shape
    cols = g.shape[0]
    n_split, per = _adj_splits(p, q)
    partial = torch.empty((cols, n_split, q), dtype=torch.float32,
                          device=g.device)
    out = torch.empty((cols, q), dtype=torch.float32, device=g.device)
    lib = build.library()
    err = lib.radon_dense_adj(a.data_ptr(), g.data_ptr(), partial.data_ptr(),
                              out.data_ptr(), p, q, cols, n_split, per,
                              ctypes.c_void_p(build.stream_of(g)))
    ADJ.launches += 1
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
