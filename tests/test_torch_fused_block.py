"""The port's fused conv + BN + LeakyReLU block (mfvi_dip_mia_tpu_torch/ops/
kernels/fused_block.py, its plain versions on the CPU) against the JAX block
(ops/pallas/fused_block.py in interpret mode) on the same numpy inputs: the
forward and all four gradients at the shapes JAX fuses, and at a narrow
shape, which JAX does not fuse, against its unfused chain."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mfvi_dip_mia_tpu.nn import cf as jcf
from mfvi_dip_mia_tpu.ops.pallas import fused_block as jfb
from mfvi_dip_mia_tpu_torch.ops import kernels
from mfvi_dip_mia_tpu_torch.ops.kernels import fused_block as tfb

torch.set_num_threads(1)

# forward and gradients, as a share of the JAX result's largest magnitude:
# the same f32 arithmetic in another summation order (sums of up to
# 9 * 16 * 128^2 terms for dw)
TOL = 1e-4


def _inputs(ci, h, w, k, co=16, seed=0, gamma=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((1, ci, h, w)).astype(np.float32)
    wk = (rng.standard_normal((k, k, ci, co)) * 0.1).astype(np.float32)
    g = (rng.random(co) + 0.5).astype(np.float32) if gamma is None else gamma
    b = rng.standard_normal(co).astype(np.float32)
    tgt = rng.standard_normal((1, co, h, w)).astype(np.float32)
    return x, wk, g, b, tgt


def _oihw(w_hwio):
    return np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1))


def _port_block(x, wk, g, b, tgt, pad_mode):
    """Output and (dx, dw HWIO, dgamma, dbeta) of the port's block under the
    loss sum((out - tgt)^2) + sum(sin(out))."""
    ts = [torch.from_numpy(a).requires_grad_(True)
          for a in (x, _oihw(wk), g, b)]
    out = tfb.apply_fused(*ts, pad_mode=pad_mode)
    (((out - torch.from_numpy(tgt)) ** 2).sum() + torch.sin(out).sum()
     ).backward()
    grads = [t.grad.numpy() for t in ts]
    grads[1] = grads[1].transpose(2, 3, 1, 0)
    return out.detach().numpy(), grads


def _jax_block(fn, x, wk, g, b, tgt):
    def loss(*a):
        out = fn(*a)
        return jnp.sum((out - tgt) ** 2) + jnp.sum(jnp.sin(out))

    args = [jnp.asarray(a) for a in (x, wk, g, b)]
    out = fn(*args)
    grads = jax.grad(loss, argnums=(0, 1, 2, 3))(*args)
    return np.asarray(out), [np.asarray(a) for a in grads]


def _assert_close(got, ref, name):
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got - ref).max())
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    assert err <= TOL * scale, (name, err, scale)


@pytest.mark.parametrize("shape,pad_mode", [
    ((16, 128, 128, 3), "reflection"), ((16, 128, 128, 1), "reflection"),
    ((4, 128, 128, 3), "reflection"), ((16, 128, 128, 3), "zero")])
def test_fused_block_against_jax_apply_fused(shape, pad_mode):
    ci, h, w, k = shape
    x, wk, g, b, tgt = _inputs(ci, h, w, k, seed=ci + k)
    assert jfb.supported(ci, 16, h, w, k)
    out_j, grads_j = _jax_block(
        lambda *a: jfb.apply_fused(*a, pad_mode=pad_mode), x, wk, g, b, tgt)
    out_t, grads_t = _port_block(x, wk, g, b, tgt, pad_mode)
    _assert_close(out_t, out_j, "out")
    for got, ref, name in zip(grads_t, grads_j,
                              ("dx", "dw", "dgamma", "dbeta")):
        _assert_close(got, ref, name)


def _jax_unfused(x, wk, g, b, pad_mode="reflection"):
    """JAX's unfused channels-first chain (tests/test_fused_block.py::
    _ref_block): pad, conv, shifted one-pass BN, LeakyReLU."""
    p = (wk.shape[0] - 1) // 2
    h = (jcf.reflection_pad(x, p) if pad_mode == "reflection"
         else jnp.pad(x, ((0, 0), (0, 0), (p, p), (p, p))))
    h = jcf.batch_norm_train(jcf.conv2d(h, wk, None, 1, 0), g, b)
    return jax.nn.leaky_relu(h, 0.2)


def test_narrow_shape_against_the_jax_unfused_chain():
    """(8, 64, 64, k3): JAX does not fuse below 128 lanes; the port does."""
    x, wk, g, b, tgt = _inputs(8, 64, 64, 3, co=12, seed=3)
    assert not jfb.supported(8, 12, 64, 64, 3)
    out_j, grads_j = _jax_block(_jax_unfused, x, wk, g, b, tgt)
    out_t, grads_t = _port_block(x, wk, g, b, tgt, "reflection")
    _assert_close(out_t, out_j, "out")
    for got, ref, name in zip(grads_t, grads_j,
                              ("dx", "dw", "dgamma", "dbeta")):
        _assert_close(got, ref, name)


def test_bwd_dc_with_gamma_near_zero_against_the_jax_kernel():
    """gamma within 1e-20 of 0 takes the safe reciprocal
    (fused_block.py:224-226) on both sides."""
    co, h, w = 8, 16, 128
    gamma = np.array([1e-25, -1e-30, 0.0, 1e-21, -3e-20, 0.5, -0.7, 1.2],
                     np.float32)
    x, wk, g, b, _ = _inputs(4, h, w, 3, co=co, seed=5, gamma=gamma)
    xp = np.pad(x[0], ((0, 0), (1, 1), (1, 1)), mode="reflect")
    out_t, stats_t = tfb.fwd(torch.from_numpy(xp),
                             torch.from_numpy(_oihw(wk)),
                             torch.from_numpy(gamma), torch.from_numpy(b))
    cot = np.random.default_rng(6).standard_normal((co, h, w)).astype(
        np.float32)
    ref = jfb._bwd_dc_call(jnp.asarray(cot), jnp.asarray(out_t.numpy()),
                           jnp.asarray(stats_t.numpy()), jnp.asarray(gamma),
                           jnp.asarray(b), k=3, h=h, w=w, slope=0.2,
                           eps=1e-5)
    got = tfb.bwd_dc(torch.from_numpy(cot), out_t, stats_t,
                     torch.from_numpy(gamma), torch.from_numpy(b))
    for a, r, name in zip(got, ref, ("dconv", "dgamma", "dbeta")):
        assert np.isfinite(a.numpy()).all(), name
        _assert_close(a.numpy(), np.asarray(r), name)
    # the forward's statistics against the JAX kernel's on the same input
    xpj = np.zeros((4, h + jfb.TH, 256), np.float32)
    xpj[:, :h + 2, :w + 2] = xp
    _, stats_j = jfb._fwd_call(jnp.asarray(xpj), jfb._wmat(jnp.asarray(wk)),
                               jnp.asarray(gamma), jnp.asarray(b), k=3, h=h,
                               w=w, slope=0.2, eps=1e-5)
    _assert_close(stats_t.numpy(), np.asarray(stats_j), "stats")


def test_wrappers_take_the_plain_versions_on_the_cpu():
    kernels.reset_launches()
    x, wk, g, b, _ = _inputs(3, 8, 12, 3, co=5, seed=7)
    xp = torch.from_numpy(np.pad(x[0], ((0, 0), (1, 1), (1, 1))))
    w, gam, bet = (torch.from_numpy(a) for a in (_oihw(wk), g, b))
    out, stats = tfb.fwd(xp, w, gam, bet)
    out_p, stats_p = tfb.fwd_plain(xp, w, gam, bet)
    assert torch.equal(out, out_p) and torch.equal(stats, stats_p)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    for got, ref in zip(tfb.bwd_dc(cot, out, stats, gam, bet),
                        tfb.bwd_dc_plain(cot, out, stats, gam, bet)):
        assert torch.equal(got, ref)
    assert torch.equal(tfb.bwd_dw(cot, xp, 3), tfb.bwd_dw_plain(cot, xp, 3))
    assert torch.equal(tfb.bwd_dx(cot, w), tfb.bwd_dx_plain(cot, w))
    assert [k.launches for k in kernels.KERNELS] == [0] * len(kernels.KERNELS)
    # the two-pass variance: a channel mean of 1e3 over a spread of 1e-2
    # leaves the statistics exact, where E[x^2] - mu^2 would cancel in f32
    c = (1e3 + 1e-2 * torch.randn(
        (1, 6, 6), generator=torch.Generator().manual_seed(1))).float()
    _, st = tfb.fwd_plain(c, torch.ones((1, 1, 1, 1)), torch.ones(1),
                          torch.zeros(1))
    inv64 = 1.0 / torch.sqrt(c.double().var(unbiased=False) + 1e-5)
    assert abs(float(st[0, 1]) - float(inv64)) <= 1e-3 * float(inv64)


def test_only_eligible_inputs_fuse():
    """Batch 1, f32 or bf16, k in {1, 3}; an input and parameters of two
    dtypes raise."""
    x = torch.zeros((1, 4, 8, 8))
    assert tfb.supported(x, 3) and tfb.supported(x, 1)
    assert not tfb.supported(x, 5)
    assert tfb.supported(x.to(torch.bfloat16), 3)
    assert not tfb.supported(x.to(torch.float16), 3)
    assert not tfb.supported(torch.zeros((2, 4, 8, 8)), 3)
    with pytest.raises(ValueError, match="batch-1 f32 or bf16"):
        tfb.apply_fused(x.to(torch.bfloat16), torch.zeros((2, 4, 3, 3)),
                        torch.ones(2), torch.zeros(2))
