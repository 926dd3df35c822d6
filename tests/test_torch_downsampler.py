"""The port's downsampler and pools (mfvi_dip_mia_tpu_torch/ops/downsampler.py,
nn/layers.py avg_pool / max_pool) against the JAX package's: the kernels bit
for bit, the Downsampler's forward and VJP (the port's two matrix products
against JAX's depthwise strided conv), the pools and their gradients."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mfvi_dip_mia_tpu.nn import layers as jlayers
from mfvi_dip_mia_tpu.ops import downsampler as jds
from mfvi_dip_mia_tpu_torch.nn import layers as tlayers
from mfvi_dip_mia_tpu_torch.ops import downsampler as tds

torch.set_num_threads(1)

# the same f32 function in another summation order (the port folds the
# edge pad into its matrices and sums rows, then columns)
ATOL = 1e-6

# (kind, phase, kernel_width) of every family the Downsampler takes
KINDS = (("lanczos2", 0.5, None), ("lanczos3", 0.5, None),
         ("gauss12", 0.0, None), ("gauss1sq2", 0.0, None), ("box", 0.5, 2),
         ("box", 0.5, 4), ("lanczos", 0.5, 9))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("factor", [2, 4])
@pytest.mark.parametrize("preset", sorted(jds._PRESETS))
def test_get_kernel_equals_jax_exactly(factor, preset):
    p = jds._PRESETS[preset]
    phase = 0.0 if preset.startswith("gauss") else 0.5
    args = (factor, p["kernel_type"], phase, p["width"](factor))
    kw = dict(support=p.get("support"), sigma=p.get("sigma"))
    k_t = tds.get_kernel(*args, **kw)
    assert k_t.dtype == np.float32
    np.testing.assert_array_equal(k_t, jds.get_kernel(*args, **kw))
    assert set(tds._PRESETS) == set(jds._PRESETS)


@pytest.mark.parametrize("width", [2, 3, 4])
def test_box_kernel_equals_jax_exactly(width):
    np.testing.assert_array_equal(tds.get_kernel(2, "box", 0.5, width),
                                  jds.get_kernel(2, "box", 0.5, width))


@pytest.mark.parametrize("preserve_size", [True, False])
@pytest.mark.parametrize("kind,phase,width", KINDS)
def test_downsampler_forward_and_vjp_against_jax(kind, phase, width,
                                                 preserve_size):
    kw = dict(phase=phase, kernel_width=width, preserve_size=preserve_size)
    if kind == "lanczos":
        kw["support"] = 2
    ds_j = jds.Downsampler(3, 2, kind, **kw)
    ds_t = tds.Downsampler(3, 2, kind, **kw)
    assert ds_t.pad == ds_j.pad
    np.testing.assert_array_equal(ds_t.kernel, ds_j.kernel)
    rng = np.random.default_rng(7)
    x = rng.uniform(size=(2, 30, 37, 3)).astype(np.float32)
    out_j, vjp = jax.vjp(ds_j, jnp.asarray(x))
    g = rng.standard_normal(out_j.shape).astype(np.float32)
    (dx_j,) = vjp(jnp.asarray(g))
    xt = _nchw(x).requires_grad_(True)
    out_t = ds_t(xt)
    out_t.backward(_nchw(g))
    assert out_t.shape == _nchw(np.asarray(out_j)).shape
    np.testing.assert_allclose(_nhwc(out_t), np.asarray(out_j), atol=ATOL)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(dx_j), atol=ATOL)


def test_preserve_size_halves_exactly():
    for kind, phase, width in KINDS[:3] + KINDS[4:5]:
        ds = tds.Downsampler(1, 2, kind, phase=phase, kernel_width=width,
                             preserve_size=True)
        assert ds(torch.ones(1, 1, 16, 16)).shape == (1, 1, 8, 8), kind
        # the normalized kernel keeps a constant image constant
        np.testing.assert_allclose(ds(torch.ones(1, 1, 16, 16)).numpy(), 1.0,
                                   rtol=1e-6)


def test_matrices_are_built_once_per_shape_and_device():
    ds = tds.Downsampler(4, 2, "lanczos2", phase=0.5, preserve_size=True)
    a = ds.matrices(32, 24, "cpu")
    b = ds.matrices(32, 24, torch.device("cpu"))
    assert all(u is v for u, v in zip(a, b))
    assert a[0].shape == (16, 32) and a[1].shape == (12, 24)


@pytest.mark.parametrize("kind", ["lanczos4", "bicubic", "stride"])
def test_unknown_kinds_raise_as_jax(kind):
    with pytest.raises(ValueError, match="wrong kernel name") as e_t:
        tds.Downsampler(3, 2, kind)
    with pytest.raises(ValueError, match="wrong kernel name") as e_j:
        jds.Downsampler(3, 2, kind)
    assert str(e_t.value) == str(e_j.value)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("pool", ["avg_pool", "max_pool"])
def test_pools_and_gradients_against_jax(pool, k):
    rng = np.random.default_rng(11 + k)
    x = rng.standard_normal((2, 24, 20, 5)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda a: getattr(jlayers, pool)(a, k),
                         jnp.asarray(x))
    g = rng.standard_normal(out_j.shape).astype(np.float32)
    (dx_j,) = vjp(jnp.asarray(g))
    xt = _nchw(x).requires_grad_(True)
    out_t = getattr(tlayers, pool)(xt, k)
    out_t.backward(_nchw(g))
    np.testing.assert_allclose(_nhwc(out_t), np.asarray(out_j), atol=ATOL)
    np.testing.assert_allclose(_nhwc(xt.grad), np.asarray(dx_j), atol=ATOL)


def test_max_pool_gradient_goes_to_the_first_maximum():
    """The tie rule: a window whose maximum appears twice sends the whole
    gradient to the first in row-major order, on both sides."""
    x = np.zeros((1, 2, 2, 1), np.float32)
    x[0, 0, 1, 0] = x[0, 1, 0, 0] = 1.0
    _, vjp = jax.vjp(lambda a: jlayers.max_pool(a, 2), jnp.asarray(x))
    (dx_j,) = vjp(jnp.ones((1, 1, 1, 1), jnp.float32))
    xt = _nchw(x).requires_grad_(True)
    tlayers.max_pool(xt, 2).sum().backward()
    np.testing.assert_array_equal(_nhwc(xt.grad), np.asarray(dx_j))
    assert float(xt.grad[0, 0, 0, 1]) == 1.0


def test_gen_noise_shape_and_draw():
    x = torch.zeros(2, 3, 5, 7)
    gen = torch.Generator().manual_seed(0)
    n = tlayers.gen_noise(x, 4, gen)
    assert n.shape == (2, 4, 5, 7) and n.dtype == x.dtype
    j = jlayers.gen_noise(jnp.zeros((2, 5, 7, 3)), 4, jax.random.PRNGKey(0))
    assert j.shape == (2, 5, 7, 4)
    assert abs(float(n.mean())) < 0.3 and 0.7 < float(n.std()) < 1.3
