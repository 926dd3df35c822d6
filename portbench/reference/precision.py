"""The control's lower precisions, as a rounding of each conv's operands
with float32 sums, the way tensor cores take them: the forward rounds the
activations and the drawn kernels, the backward the incoming gradient (so
the input and weight gradients are products of rounded operands too).
'tf32' keeps 10 mantissa bits (rounded to nearest), 'bf16' 7, 'fp8' is e4m3
with one scale per tensor (its largest magnitude at 448). ``turn_off_tf32``
holds PyTorch's own matmuls and convs to float32 while the reference runs."""

from __future__ import annotations

import contextlib

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().max().clamp(min=1e-30)
    scale = 448.0 / amax
    return (x * scale).to(torch.float8_e4m3fn).float() / scale


QUANT = {"tf32": round_tf32, "bf16": round_bf16, "fp8": round_fp8}


class _Operand(torch.autograd.Function):
    """Rounded going forward; the gradient passes as it is."""

    @staticmethod
    def forward(ctx, x, q):
        return q(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GradOut(torch.autograd.Function):
    """Unchanged going forward; the gradient is rounded."""

    @staticmethod
    def forward(ctx, y, q):
        ctx.q = q
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return ctx.q(g), None


class Rounding:
    """A lower precision for a conv: ``operand(t)`` for its inputs,
    ``output(y)`` for its result."""

    def __init__(self, q):
        self.q = q

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        return _Operand.apply(t, self.q)

    def output(self, y: torch.Tensor) -> torch.Tensor:
        return _GradOut.apply(y, self.q)


def rounding(name: str | None):
    """The rounding ``name`` names, or None for float32."""
    return None if name in (None, "f32") else Rounding(QUANT[name])


@contextlib.contextmanager
def turn_off_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
