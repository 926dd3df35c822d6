"""The port's conv (mfvi_dip_mia_tpu_torch/ops/kernels/cf_conv.py) against the
JAX Pallas conv (ops/pallas/cf_conv.py, run in interpret mode on the CPU).

On the CPU the port's wrappers take their plain versions (f32 im2col +
matmul), so this pins the conv-site dispatch (padding, stride-2 parity
planes, 1x1 subsample), the dx/dw backward and the plain arithmetic that
chip_smoke.py holds the CUDA kernels against."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mfvi_dip_mia_tpu.ops.pallas import cf_conv as jcf
from mfvi_dip_mia_tpu_torch.ops.kernels import cf_conv as tcf

torch.set_num_threads(1)

# f32, summation order only: the port sums each output in one matmul, the
# Pallas kernel per row tile in its own order
FWD_REL = 1e-5
# gradients add the backward's reordered sums (full correlation, H*W
# reduction) on top of the forward's
GRAD_REL = 1e-4

# I, O, H, W: W = 64 keeps the Pallas kernel (not its XLA fallback) on the
# JAX side of every stride-1 site
CASES = [(k, s, mode) for k in (1, 3, 5) for s in (1, 2)
         for mode in ("zero", "reflection")]


def _inputs(k, seed=0, i_ch=6, o_ch=5, h=16, w=64):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, i_ch, h, w)).astype(np.float32)
    w_hwio = (rng.standard_normal((k, k, i_ch, o_ch)) * 0.2).astype(np.float32)
    b = rng.standard_normal((o_ch,)).astype(np.float32)
    return x, w_hwio, b


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def _rel(got, ref):
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("k,stride,mode", CASES)
def test_conv_site_forward_matches_pallas(k, stride, mode):
    x, w, b = _inputs(k)
    pad = (k - 1) // 2
    ref = np.asarray(jcf.conv2d_cf_pallas(jnp.asarray(x), jnp.asarray(w),
                                          jnp.asarray(b), stride, pad,
                                          pad_mode=mode))
    got = tcf.conv2d_cf(torch.from_numpy(x), _oihw(w), torch.from_numpy(b),
                        stride, pad, pad_mode=mode).numpy()
    assert got.shape == ref.shape
    assert _rel(got, ref) < FWD_REL


@pytest.mark.parametrize("k,stride,mode", [(1, 1, "zero"), (3, 1, "reflection"),
                                           (3, 2, "reflection"), (5, 1, "zero"),
                                           (1, 2, "zero")])
def test_conv_site_grads_match_pallas_vjp(k, stride, mode):
    x, w, _ = _inputs(k, seed=1)
    pad = (k - 1) // 2

    def f(xx, ww):
        return jcf.conv2d_cf_pallas(xx, ww, None, stride, pad, pad_mode=mode)

    out, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    ct = np.random.default_rng(2).standard_normal(out.shape).astype(np.float32)
    dx_ref, dw_ref = (np.asarray(a) for a in vjp(jnp.asarray(ct)))

    xt = torch.from_numpy(x).requires_grad_(True)
    wt = _oihw(w).requires_grad_(True)
    tcf.conv2d_cf(xt, wt, None, stride, pad, pad_mode=mode).backward(
        torch.from_numpy(ct))
    assert _rel(xt.grad.numpy(), dx_ref) < GRAD_REL
    assert _rel(wt.grad.numpy().transpose(2, 3, 1, 0), dw_ref) < GRAD_REL


@pytest.mark.parametrize("k", [1, 3, 5])
def test_valid_conv_dw_matches_pallas_dw(k):
    """The weight-gradient kernel's plain version against dw_valid_cf."""
    rng = np.random.default_rng(3)
    xp = rng.standard_normal((4, 12 + k - 1, 64 + k - 1)).astype(np.float32)
    g = rng.standard_normal((3, 12, 64)).astype(np.float32)
    ref = np.asarray(jcf.dw_valid_cf(jnp.asarray(xp), jnp.asarray(g), (k, k)))
    got = tcf.conv_dw(torch.from_numpy(xp), torch.from_numpy(g), k, k)
    assert got.dtype == torch.float32
    assert _rel(got.numpy().transpose(2, 3, 1, 0), ref) < GRAD_REL


@pytest.mark.parametrize("k", [3, 5])
def test_s2_plane_weight_matches_the_jax_rearrangement(k):
    """cf_conv.py::_conv_s2_planes builds the plane kernel tap by tap; the
    port's reshape/permute must place every tap in the same slot."""
    _, w, _ = _inputs(k, seed=4)
    kh, kw, c, o = w.shape
    k2 = (kh + 1) // 2
    ref = np.zeros((k2, k2, 4 * c, o), np.float32)     # HWIO plane kernel
    for dy in range(k2):
        for dx in range(k2):
            for p in range(2):
                for q in range(2):
                    oy, ox = 2 * dy + p, 2 * dx + q
                    if oy < kh and ox < kw:
                        blk = (p * 2 + q) * c
                        ref[dy, dx, blk:blk + c] = w[oy, ox]
    got = tcf.s2_plane_weight(_oihw(w)).numpy()
    np.testing.assert_array_equal(got, ref.transpose(3, 2, 0, 1))


@pytest.mark.parametrize("k", [3, 5])
def test_s2_planes_conv_matches_jax(k):
    x, w, _ = _inputs(k, seed=5, h=18, w=66)
    ref = np.asarray(jcf._conv_s2_planes(jnp.asarray(x[0]), jnp.asarray(w)))
    got = tcf.conv_s2_planes(torch.from_numpy(x[0]), _oihw(w)).numpy()
    assert got.shape == ref.shape
    assert _rel(got, ref) < FWD_REL


def test_bf16_forward_rounds_like_a_cast_of_the_f32_result():
    """Output in the input's dtype, f32 accumulation (cf_conv.py:182)."""
    x, w, _ = _inputs(3, seed=6)
    xb = torch.from_numpy(x[0]).to(torch.bfloat16)
    wb = _oihw(w).to(torch.bfloat16)
    got = tcf.conv_valid(xb, wb)
    ref = tcf.conv_valid(xb.float(), wb.float()).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, ref, rtol=0, atol=0)


def test_dx_pads_rows_and_columns_separately():
    """A non-square kernel is refused by the kernel's square-tap check, and
    the dx helper pads kh-1 rows and kw-1 columns."""
    xp = torch.randn(2, 8, 9)
    with pytest.raises(ValueError, match="square"):
        tcf.conv_valid_fwd(xp, torch.randn(3, 2, 1, 3))
    g = torch.randn(3, 6, 7)
    w = torch.randn(3, 2, 3, 3)
    assert tcf.conv_dx(g, w).shape == (2, 8, 9)
