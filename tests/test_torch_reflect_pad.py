"""The conv sites' reflection pad (mfvi_dip_mia_tpu_torch/ops/pad.py) and its
deterministic adjoint, against ``F.pad(mode="reflect")`` and its own
gradient, and against the JAX package's ``nn/layers.py::reflection_pad``
(``jnp.pad(..., mode="reflect")``, NHWC) and its ``jax.vjp``, on the same
numpy inputs; the three conv sites that pad by reflection go through it."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode
import jax
import jax.numpy as jnp

from mfvi_dip_mia_tpu.nn import layers as jlayers
from mfvi_dip_mia_tpu_torch.ops import pad
from mfvi_dip_mia_tpu_torch.ops.kernels import cf_conv as tcf
from mfvi_dip_mia_tpu_torch.ops.kernels import fused_block as tfb
from mfvi_dip_mia_tpu_torch.ops.kernels import lrt_conv as tlrt

torch.set_num_threads(1)

# (C, H, W, p): square and ragged, the smallest input p = 1 takes
CASES = [(3, 8, 8, 1), (3, 8, 8, 2), (4, 9, 7, 1), (4, 9, 7, 2),
         (2, 2, 2, 1)]
# f32: sums of <= 4 terms in another order, as a share of the largest value
F32_REL = 1e-6


def _case(c, h, w, p, dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((c, h, w)).astype(np.float32)
    g = rng.standard_normal((c, h + 2 * p, w + 2 * p)).astype(np.float32)
    return (torch.from_numpy(x).to(dtype), torch.from_numpy(g).to(dtype))


def _port_grad(x, g, p, batch):
    xt = (x[None] if batch else x).clone().requires_grad_(True)
    y = pad.reflection_pad(xt, p)
    (gx,) = torch.autograd.grad(y, xt, g[None] if batch else g)
    y = y.detach()
    return (y[0], gx[0]) if batch else (y, gx)


def _jax_grad(x, g, p):
    """jax.vjp of the NHWC reflection pad on the (C, H, W) inputs."""
    dt = jnp.bfloat16 if x.dtype == torch.bfloat16 else jnp.float32
    xj = jnp.asarray(x.float().numpy().transpose(1, 2, 0)[None], dt)
    y, vjp = jax.vjp(lambda a: jlayers.reflection_pad(a, p), xj)
    (gx,) = vjp(jnp.asarray(g.float().numpy().transpose(1, 2, 0)[None], dt))
    to_cf = lambda a: np.asarray(a, np.float32)[0].transpose(2, 0, 1)
    return to_cf(y), to_cf(gx)


def _bf16_ulp(v: float) -> float:
    """One bf16 ulp (8 significant bits) at the magnitude of v."""
    return 2.0 ** (np.floor(np.log2(abs(v))) - 7)


@pytest.mark.parametrize("batch", [False, True], ids=["CHW", "1CHW"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_forward_and_gradient_against_f_pad_and_jax(case, dtype, batch):
    c, h, w, p = case
    x, g = _case(c, h, w, p, dtype, seed=c * 100 + h * 10 + w + p)
    y, gx = _port_grad(x, g, p, batch)
    assert torch.equal(y, F.pad(x, (p,) * 4, mode="reflect"))
    xr = x.clone().requires_grad_(True)
    (gx_torch,) = torch.autograd.grad(F.pad(xr, (p,) * 4, mode="reflect"),
                                      xr, g)
    y_j, gx_j = _jax_grad(x, g, p)
    np.testing.assert_array_equal(y.float().numpy(), y_j)
    got = gx.float().numpy()
    for ref in (gx_torch.float().numpy(), gx_j):
        scale = np.abs(ref).max()
        if dtype == torch.float32:
            assert np.abs(got - ref).max() <= F32_REL * scale
        else:
            # each side rounds its <= 3 bf16 sums in its own order
            assert np.abs(got - ref).max() <= _bf16_ulp(scale)


def test_gradcheck_in_f64():
    x = torch.randn((2, 5, 6), dtype=torch.float64, requires_grad=True,
                    generator=torch.Generator().manual_seed(0))
    for p in (1, 2):
        assert torch.autograd.gradcheck(lambda t: pad.reflection_pad(t, p),
                                        (x,))
    x3 = torch.randn((1, 2, 3, 4), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda t: pad.reflection_pad(t, 2), (x3,))


@pytest.mark.parametrize("shape,p", [((3, 2, 5), 2), ((3, 5, 2), 2),
                                     ((1, 3, 4, 1), 1), ((2, 3, 4, 4), 1)])
def test_a_pad_the_input_cannot_take_raises(shape, p):
    with pytest.raises(ValueError):
        pad.reflection_pad(torch.zeros(shape), p)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket.__name__))
        return func(*args, **(kwargs or {}))


# ops that only view their input: no kernel launch on the card
_VIEWS = {"view", "reshape", "_reshape_alias", "select", "slice",
          "alias", "unsqueeze", "squeeze", "expand", "detach", "t",
          "transpose", "as_strided", "_unsafe_view"}


@pytest.mark.parametrize("shape,p", [((16, 64, 64), 1), ((1, 36, 32, 32), 1),
                                     ((8, 9, 7), 2)])
def test_the_adjoint_is_one_gather_and_two_masked_adds(shape, p):
    """Three kernels per backward call, none of them a scatter, an index
    add / put or a matrix product (PyTorch's own CUDA backward is a zero
    fill and one atomic kernel)."""
    g = torch.randn(shape[:-2] + (shape[-2] + 2 * p, shape[-1] + 2 * p))
    pad._tables.cache_clear()
    pad.reflection_pad_adjoint(g, p)        # the index tables, built once
    with _Ops() as mode:
        pad.reflection_pad_adjoint(g, p)
    kernels = [op for op in mode.ops if op not in _VIEWS]
    assert kernels == ["index_select", "addcmul", "addcmul"], mode.ops


def test_the_three_conv_sites_pad_through_it(monkeypatch):
    """conv2d_cf, apply_fused and the LRT site with pad_mode='reflection'
    call ops/pad.py's reflection_pad (zero padding does not)."""
    calls = []
    real = pad.reflection_pad

    def spy(x, p):
        calls.append((tuple(x.shape), p))
        return real(x, p)

    monkeypatch.setattr(pad, "reflection_pad", spy)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((1, 4, 8, 8), generator=gen, requires_grad=True)
    w3 = torch.randn((5, 4, 3, 3), generator=gen)
    gamma, beta = torch.ones(5), torch.zeros(5)
    outs = [tcf.conv2d_cf(x, w3, padding=1, pad_mode="reflection"),
            tfb.apply_fused(x, w3, gamma, beta, pad_mode="reflection"),
            tlrt.lrt_conv(x, w3, torch.full_like(w3, -3.0), None, None, 1, 1,
                          "reflection", torch.randn((1, 5, 8, 8),
                                                    generator=gen))]
    assert calls == [((4, 8, 8), 1), ((1, 4, 8, 8), 1), ((4, 8, 8), 1)]
    tcf.conv2d_cf(x, w3, padding=1, pad_mode="zero")
    tfb.apply_fused(x, w3, gamma, beta, pad_mode="zero")
    assert len(calls) == 3
    # every site's input gradient comes through the adjoint
    folds = []
    adjoint = pad.reflection_pad_adjoint

    def fold(g, p):
        folds.append(tuple(g.shape))
        return adjoint(g, p)

    monkeypatch.setattr(pad, "reflection_pad_adjoint", fold)
    sum(o.sum() for o in outs).backward()
    assert len(folds) == 3
