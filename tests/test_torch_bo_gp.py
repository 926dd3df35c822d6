"""The port's BO surrogate (mfvi_dip_mia_tpu_torch/bo/{normalize,gp,
acquisition}.py) against the JAX package's on the same seeded numpy inputs:
normalization, the trained GP's hyperparameters and posterior, EI / UCB and
the candidate search on one GP carried across by utils/bridge.py::
gp_from_jax, and the peak finder.

Tolerances: both sides run the same float64 arithmetic in another order
(the Cholesky factor, Adam's moment updates), so the trained
hyperparameters and the posterior on the grid agree to 1e-6 relative (they
land near 1e-13). The candidate search runs L-BFGS-B from the same starts
on acquisition values and gradients that agree to ~1e-14, so its
candidates agree to 1e-6 in normalized coordinates."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mfvi_dip_mia_tpu.bo import acquisition as jacq
from mfvi_dip_mia_tpu.bo import gp as jgp
from mfvi_dip_mia_tpu.bo import normalize as jnorm
from mfvi_dip_mia_tpu_torch.bo import acquisition as tacq
from mfvi_dip_mia_tpu_torch.bo import gp as tgp
from mfvi_dip_mia_tpu_torch.bo import normalize as tnorm
from mfvi_dip_mia_tpu_torch.utils.bridge import gp_from_jax

torch.set_num_threads(1)

GP_RTOL = 1e-6
CAND_ATOL = 1e-6


def _grid():
    return np.stack(np.meshgrid(np.linspace(0, 1, 100),
                                np.linspace(0, 1, 100),
                                indexing="ij"), -1).reshape(-1, 2)


def _data(n, seed=0, fn="smooth"):
    rng = np.random.default_rng(seed)
    x = rng.random((n, 2))
    if fn == "smooth":
        y = 20 + 5 * np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1])
    else:   # one clear peak: every refined start collapses onto it
        y = 30.0 - 8.0 * ((x[:, 0] - 0.55) ** 2 + (x[:, 1] - 0.45) ** 2)
    return x, y


def _carried(gp_j, x, y):
    return gp_from_jax([np.asarray(p) for p in gp_j.params], x, y)


def _rel(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / max(
        np.abs(np.asarray(b)).max(), 1e-300)


def test_normalize_against_jax():
    rng = np.random.default_rng(1)
    x = 10 ** (rng.random((9, 2)) * -8)
    b1, b2 = [-12.0, -2.0], [-10.0, 0.0]
    n_t = tnorm.normalize_X(x, b1, b2)
    np.testing.assert_array_equal(n_t, jnorm.normalize_X(x, b1, b2))
    np.testing.assert_array_equal(tnorm.unnormalize_X(n_t, b1, b2),
                                  jnorm.unnormalize_X(n_t, b1, b2))
    np.testing.assert_allclose(tnorm.unnormalize_X(n_t, b1, b2), x,
                               rtol=1e-10)


@pytest.mark.parametrize("n,iters", [(8, 300), (20, 2000)])
def test_train_gp_against_jax(n, iters):
    x, y = _data(n, seed=n)
    gp_j = jgp.train_gp(x, y, iter_max=iters)
    gp_t = tgp.train_gp(x, y, iter_max=iters)
    h_j, h_t = gp_j.hyperparams, gp_t.hyperparams
    assert set(h_t) == set(h_j)
    for k in h_j:
        assert h_t[k] == pytest.approx(h_j[k], rel=GP_RTOL), k
    g = _grid()
    mean_j, var_j = (np.asarray(a) for a in gp_j.predict(g))
    mean_t, var_t = (a.numpy() for a in gp_t.predict(g))
    assert _rel(mean_t, mean_j) < GP_RTOL
    assert _rel(var_t, var_j) < GP_RTOL
    assert (var_t >= 0).all()


def test_gp_stays_float64():
    x, y = _data(6)
    gp = tgp.train_gp(x.astype(np.float32), y.astype(np.float32),
                      iter_max=50)
    for t in (*gp.params, gp.x_train, gp.y_train, gp.chol, gp.alpha):
        assert t.dtype == torch.float64 and t.device.type == "cpu"
    mu, var = gp.predict(np.random.default_rng(0).random((3, 2),
                                                         np.float32))
    assert mu.dtype == var.dtype == torch.float64
    with pytest.raises(TypeError, match="float64"):
        tgp._neg_mll(gp.params, gp.x_train.float(), gp.y_train)
    assert all(np.isfinite(v) for v in gp.hyperparams.values())


def test_ei_and_ucb_on_a_carried_gp_against_jax():
    x, y = _data(12, seed=3)
    gp_j = jgp.train_gp(x, y, iter_max=300)
    gp_t = _carried(gp_j, x, y)
    g = _grid()
    mean_j, var_j = (np.asarray(a) for a in gp_j.predict(g))
    mean_t, var_t = (a.numpy() for a in gp_t.predict(g))
    assert _rel(mean_t, mean_j) < 1e-12 and _rel(var_t, var_j) < 1e-10
    with jax.enable_x64():
        ei_j = np.asarray(jacq.expected_improvement(gp_j, g, x))
        ucb_j = np.asarray(jacq.upper_confidence_bound(gp_j, g, 2.0))
    ei_t = tacq.expected_improvement(gp_t, g, x).numpy()
    ucb_t = tacq.upper_confidence_bound(gp_t, g, 2.0).numpy()
    assert _rel(ei_t, ei_j) < GP_RTOL and (ei_t >= 0).all()
    assert _rel(ucb_t, ucb_j) < GP_RTOL
    np.testing.assert_array_equal(
        tacq.acquisition_fun(gp_t, g, x, "ucb").numpy(), ucb_t)
    with pytest.raises(ValueError):
        tacq.acquisition_fun(gp_t, g, x, "pi")


def test_peak_local_max_against_jax():
    rng = np.random.default_rng(4)
    img = np.zeros((100, 100))
    img[20, 30], img[70, 80], img[50, 50] = 1.0, 0.8, 0.05
    images = [img, np.zeros((100, 100))] + [
        rng.random((100, 100)) for _ in range(3)]
    for im in images:
        for kw in (dict(), dict(min_distance=2, num_peaks=10),
                   dict(min_distance=0, threshold_rel=0.5)):
            got = tacq.peak_local_max(im, **kw)
            np.testing.assert_array_equal(got, jacq.peak_local_max(im, **kw))
    got = tacq.peak_local_max(img)
    assert (got[0] == [20, 30]).all() and len(got) == 2


@pytest.mark.parametrize("fn,n", [("smooth", 10), ("peak", 25)])
def test_find_candidates_on_a_carried_gp_against_jax(fn, n):
    x, y = _data(n, seed=5, fn=fn)
    gp_j = jgp.train_gp(x, y, iter_max=400)
    gp_t = _carried(gp_j, x, y)
    g = _grid()
    c_j, e_j, a_j = jacq.find_candidates(gp_j, g, x)
    c_t, e_t, a_t = tacq.find_candidates(gp_t, g, x)
    assert a_t.shape == (10000,) and _rel(a_t, np.asarray(a_j)) < GP_RTOL
    assert c_t.shape == c_j.shape
    np.testing.assert_allclose(c_t, c_j, rtol=0, atol=CAND_ATOL)
    np.testing.assert_allclose(e_t, e_j, rtol=GP_RTOL, atol=1e-12)
    # after the dedup each EI still belongs to its candidate
    assert len(c_t) == len(e_t)
    for c, e in zip(c_t, e_t):
        want = float(tacq.expected_improvement(gp_t, c.reshape(1, -1), x)[0])
        assert e == pytest.approx(want, rel=1e-12, abs=1e-15)
    assert max(e_t) >= a_t.max() - 1e-6
