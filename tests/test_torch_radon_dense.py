"""The port's dense Radon operator (mfvi_dip_mia_tpu_torch/ops/kernels/
radon_dense.py) and the rest of ops/radon.py against the JAX package: the
bf16 projection matrix is bit-equal to prepare_matrix_bf16's (without its
TPU tile padding), the plain forward and adjoint agree with
radon_apply_pallas (interpret mode) and its VJP, and the 'dense-bf16' and
'gather' modes, ``adjoint`` and ``fbp`` agree with their JAX counterparts."""

import ml_dtypes
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import mfvi_dip_mia_tpu.ops.radon as jradon
import mfvi_dip_mia_tpu.tasks.data as JD
import mfvi_dip_mia_tpu.tasks.problems as JP
from mfvi_dip_mia_tpu.ops.pallas import radon_kernel as jrk
import mfvi_dip_mia_tpu_torch.ops.radon as tradon
import mfvi_dip_mia_tpu_torch.tasks.data as TD
import mfvi_dip_mia_tpu_torch.tasks.problems as TP
from mfvi_dip_mia_tpu_torch.ops.kernels import radon_dense as trd

torch.set_num_threads(1)

# H*W a multiple of 2048 and T*W of 256: the JAX VJP (radon_kernel.py:
# 144-149) returns H*W rows for its tile-padded input and raises otherwise
S = 64
THETA = np.arange(0.0, 180.0, 22.5).astype(np.float32)     # 8 angles
# f32 accumulations of the same bf16 (or f32) products in another order, as
# a share of the JAX result's largest magnitude
REL = 1e-5
# fbp: the same f32 FFT filter and 8-angle backprojection; FFT
# implementations differ in rounding (pocketfft in both, other plans)
REL_FBP = 1e-4


@pytest.fixture(scope="module")
def matrices():
    a_j = jrk.prepare_matrix_bf16(jradon._build_projection_matrix(THETA, S, S))
    a_t = tradon.dense_matrix_bf16(THETA, S, S, "cpu")
    return a_j, a_t


@pytest.fixture(scope="module")
def img():
    return np.random.default_rng(0).uniform(size=(1, S, S, 1)).astype(
        np.float32)


def _nchw(a):
    return torch.from_numpy(np.array(a.transpose(0, 3, 1, 2)))


def _close(got, ref, rel=REL):
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.max(np.abs(got - ref)))
    assert err <= rel * float(np.max(np.abs(ref))), err


@pytest.mark.parametrize("size", [40, S])
def test_matrices_are_bit_equal_to_jax(size):
    """The f32 host matrix, and the bf16 one against JAX's after removing
    its (256, 2048) tile padding (40^2: both axes padded; 64^2: none)."""
    a32 = tradon._build_projection_matrix(THETA, size, size)
    np.testing.assert_array_equal(
        a32, jradon._build_projection_matrix(THETA, size, size))
    a_j = np.asarray(jrk.prepare_matrix_bf16(a32))
    a_t = tradon.dense_matrix_bf16(THETA, size, size, "cpu")
    p, q = len(THETA) * size, size * size
    assert a_t.shape == (p, q) and a_t.dtype == torch.bfloat16
    assert a_j.shape == (-(-p // 256) * 256, -(-q // 2048) * 2048)
    ref = a_j[:p, :q].astype(ml_dtypes.bfloat16).view(np.uint16)
    got = a_t.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, ref)
    assert not a_j[p:].any() and not a_j[:, q:].any()


def test_dense_forward_matches_pallas(matrices, img):
    a_j, a_t = matrices
    ref = jrk.radon_apply_pallas(jnp.asarray(img), a_j, len(THETA))
    got = trd.radon_apply_dense(_nchw(img), a_t, len(THETA))
    _close(got.numpy().transpose(0, 2, 3, 1), ref)


def test_dense_adjoint_matches_pallas_vjp(matrices, img):
    a_j, a_t = matrices
    ct = np.random.default_rng(1).standard_normal(
        (1, len(THETA), S, 1)).astype(np.float32)
    _, vjp = jax.vjp(lambda x: jrk.radon_apply_pallas(x, a_j, len(THETA)),
                     jnp.asarray(img))
    ref = np.asarray(vjp(jnp.asarray(ct))[0]).transpose(0, 3, 1, 2)
    x = _nchw(img).requires_grad_(True)
    trd.radon_apply_dense(x, a_t, len(THETA)).backward(_nchw(ct))
    _close(x.grad.numpy(), ref)


def test_plain_kernels_over_row_chunks(matrices, monkeypatch):
    """The plain versions promote A a row chunk at a time; several image
    columns (batch x channels) share one pass."""
    _, a_t = matrices
    rng = np.random.default_rng(2)
    v = torch.from_numpy(rng.standard_normal((3, S * S)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(
        (3, a_t.shape[0])).astype(np.float32))
    whole = (trd.radon_dense_fwd(a_t, v), trd.radon_dense_adj(a_t, g))
    monkeypatch.setattr(trd, "_CHUNK_BYTES", 40 * 4 * S * S)   # 40 rows
    chunked = (trd.radon_dense_fwd(a_t, v), trd.radon_dense_adj(a_t, g))
    a64 = a_t.double()
    exact = (v.double() @ a64.T, g.double() @ a64)
    for w, c, e in zip(whole, chunked, exact):
        assert torch.allclose(w.double(), e, rtol=0, atol=1e-5)
        assert torch.allclose(c.double(), e, rtol=0, atol=1e-5)
    # the kernels' grid at the path's shape (256^2, 45 angles, 132 SMs)
    plan = trd.dense_plan(11520, 65536, 2 * 132)
    assert (plan.fwd_blocks, plan.adj_blocks, plan.n_strips) == (264, 264, 64)


@pytest.mark.parametrize("mode_t,mode_j", [("dense-bf16", "pallas"),
                                           ("gather", "gather")])
def test_operator_modes_and_adjoint_match_jax(mode_t, mode_j, img):
    op_j = jradon.FastRadonTransform((1, S, S, 1), THETA, mode=mode_j)
    op_t = tradon.FastRadonTransform((1, 1, S, S), THETA, mode=mode_t,
                                     device="cpu")
    assert op_t.mode == mode_t
    _close(op_t(_nchw(img)).numpy().transpose(0, 2, 3, 1), op_j(
        jnp.asarray(img)))
    sino = np.random.default_rng(3).standard_normal(
        (1, len(THETA), S, 1)).astype(np.float32)
    ref = np.asarray(op_j.adjoint(jnp.asarray(sino))).transpose(0, 3, 1, 2)
    _close(op_t.adjoint(_nchw(sino)).numpy(), ref)


def test_gather_mode_is_the_dense_matrix(img):
    """The gather and the f32 matmul modes are one operator (the JAX
    package's test_matmul_mode_matches_gather, here in the port)."""
    x = _nchw(img)
    og = tradon.FastRadonTransform((1, 1, S, S), THETA, mode="gather",
                                 device="cpu")
    om = tradon.FastRadonTransform((1, 1, S, S), THETA, mode="matmul",
                                 device="cpu")
    _close(og(x).numpy(), om(x).numpy())


def test_fbp_matches_jax(img):
    theta = np.arange(0.0, 180.0, 10.0)
    op = jradon.FastRadonTransform((1, S, S, 1), theta, mode="gather")
    sino = np.asarray(op(jnp.asarray(img)))                     # (1, T, W, 1)
    ref = np.asarray(jradon.fbp(jnp.asarray(sino), theta, S))   # (1, S, S, 1)
    got = tradon.fbp(_nchw(sino), theta, S)
    _close(got.numpy().transpose(0, 2, 3, 1), ref, REL_FBP)


def test_ct_problem_builds_its_target_through_the_dense_operator(monkeypatch):
    """radon_mode='dense-bf16' reaches FastRadonTransform, and the target
    sinogram is made by the same operator, as the JAX problem makes it in
    its 'pallas' mode."""
    for D in (JD, TD):
        monkeypatch.setattr(D, "get_img_ct", lambda i, D=D: (
            D.synthetic_ct(i, S), (S, S)))
    monkeypatch.setenv("MFVI_DIP_RADON", "pallas")
    prob_j = JP.build_problem("ct", "mfvi", 0, input_depth=16)
    prob_t = TP.build_problem("ct", "mfvi", 0, input_depth=16, device="cpu",
                              radon_mode="dense-bf16")
    assert prob_t.operator.mode == "dense-bf16"
    _close(prob_t.target.numpy().transpose(0, 2, 3, 1), prob_j.target)
    assert prob_t.operator.state is tradon.dense_matrix_bf16(
        JP._CT_THETA, S, S, "cpu")
