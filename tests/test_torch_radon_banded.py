"""The port's banded Radon (mfvi_dip_mia_tpu_torch/ops/kernels/radon_banded.py,
ops/radon.py) against the JAX Pallas operator (ops/pallas/radon_banded.py,
interpret mode on the CPU): the port's numpy band builder is byte-equal to
prepare_banded_direct, and the plain forward / adjoint agree with
radon_apply_banded and its VJP."""

import ml_dtypes
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mfvi_dip_mia_tpu.ops.pallas import radon_banded as jrb
from mfvi_dip_mia_tpu_torch.ops import radon as tradon
from mfvi_dip_mia_tpu_torch.ops.kernels import radon_banded as trb

torch.set_num_threads(1)

S = 64
THETA = np.arange(0.0, 180.0, 24.0).astype(np.float32)   # 8 angles
# f32 band, summation order only (both sum the same band products)
REL = 1e-5


@pytest.fixture(scope="module")
def states():
    return {dt: (jrb.prepare_banded_direct(THETA, S, S, dtype=jdt),
                 trb.prepare_banded_direct(THETA, S, S, dtype=dt,
                                           device="cpu"))
            for dt, jdt in ((torch.float32, jnp.float32),
                            (torch.bfloat16, jnp.bfloat16))}


@pytest.fixture(scope="module")
def img():
    rng = np.random.default_rng(0)
    return rng.uniform(size=(1, S, S, 1)).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def test_band_builder_is_byte_equal_in_f32(states):
    js, ts = states[torch.float32]
    assert ts.blocks.shape == js.blocks.shape
    assert (ts.patch, ts.tchunk, ts.n_angles, ts.w) == (
        js.patch, js.tchunk, js.n_angles, js.w)
    assert np.asarray(js.blocks).tobytes() == ts.blocks.numpy().tobytes()
    assert np.asarray(js.jlo).tobytes() == ts.jlo.numpy().tobytes()


def test_band_builder_is_byte_equal_in_bf16(states):
    js, ts = states[torch.bfloat16]
    ref = np.asarray(js.blocks).astype(ml_dtypes.bfloat16).view(np.uint16)
    got = ts.blocks.view(torch.int16).numpy().view(np.uint16)
    assert ts.tchunk == js.tchunk
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(ts.jlo.numpy(), np.asarray(js.jlo))


def test_auto_geometry_matches_jax():
    assert trb.auto_jwin(16) == jrb.auto_jwin(16) == 32
    for n, itemsize in ((45, 2), (45, 4), (8, 4), (180, 2)):
        assert trb.auto_tchunk(n, 32, 256, itemsize) == jrb.auto_tchunk(
            n, 32, 256, itemsize)


def test_patchify_roundtrip_matches_jax(img):
    ref = np.asarray(jrb.patchify(jnp.asarray(img), 16))
    got = trb.patchify(_nchw(img), 16)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        trb.unpatchify(got, 1, 1, S, S, 16).numpy(), _nchw(img).numpy())


def test_forward_matches_pallas(states, img):
    js, ts = states[torch.float32]
    ref = np.asarray(jrb.radon_apply_banded(jnp.asarray(img), js))  # (B,T,W,C)
    got = trb.radon_apply_banded(_nchw(img), ts).numpy()             # (B,C,T,W)
    got = got.transpose(0, 2, 3, 1)
    assert got.shape == ref.shape == (1, len(THETA), S, 1)
    assert np.max(np.abs(got - ref)) < REL * np.max(np.abs(ref))


def test_adjoint_matches_pallas_vjp(states, img):
    js, ts = states[torch.float32]
    ct = np.random.default_rng(1).standard_normal(
        (1, len(THETA), S, 1)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jrb.radon_apply_banded(x, js), jnp.asarray(img))
    ref = np.asarray(vjp(jnp.asarray(ct))[0]).transpose(0, 3, 1, 2)
    x = _nchw(img).requires_grad_(True)
    trb.radon_apply_banded(x, ts).backward(
        torch.from_numpy(ct.transpose(0, 3, 1, 2).copy()))
    assert np.max(np.abs(x.grad.numpy() - ref)) < REL * np.max(np.abs(ref))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adjoint_dot_product_identity(states, dtype):
    """<A x, y> = <x, A^T y> for the plain forward and adjoint."""
    _, ts = states[dtype]
    rng = np.random.default_rng(2)
    g = ts.blocks.shape[0]
    pp = ts.blocks.shape[3]
    x = torch.from_numpy(rng.standard_normal((1, g * pp)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal(
        (ts.t_pad * S, 1)).astype(np.float32))
    lhs = float((trb.radon_fwd(ts, x) * y).double().sum())
    rhs = float((x * trb.radon_adj(ts, y)).double().sum())
    assert abs(lhs - rhs) <= 1e-5 * max(abs(lhs), 1.0)


def test_banded_operator_matches_dense_matrix(img):
    """ops/radon.py: the banded and matmul modes are one operator."""
    ob = tradon.FastRadonTransform((1, 1, S, S), THETA, mode="banded",
                                 device="cpu")
    om = tradon.FastRadonTransform((1, 1, S, S), THETA, mode="matmul",
                                 device="cpu")
    x = _nchw(img)
    sb, sm = ob(x), om(x)
    assert sb.shape == sm.shape == (1, 1, len(THETA), S)
    assert float((sb - sm).abs().max()) < REL * float(sm.abs().max())


def test_auto_mode_picks_the_dense_matrix_on_the_cpu():
    op = tradon.FastRadonTransform((1, 1, S, S), THETA, mode="auto",
                                 device="cpu")
    assert op.mode == "matmul"
