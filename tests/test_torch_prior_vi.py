"""The port's posterior mean, closed-form KL (reverse and forward), the
scale-mixture MC KL and the priors (mfvi_dip_mia_tpu_torch/bayes/{vi,
priors}.py) against the JAX package's bayes/vi.py and bayes/priors.py, on
the same parameters (carried across by utils/bridge.py) and, for the MC
estimates, one fixed mixture draw on both sides."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mfvi_dip_mia_tpu.bayes import priors as jpriors
from mfvi_dip_mia_tpu.bayes import vi as jvi
from mfvi_dip_mia_tpu.nn import build_skip_net as jbuild
from mfvi_dip_mia_tpu_torch.bayes import priors as tpriors
from mfvi_dip_mia_tpu_torch.bayes import vi as tvi
from mfvi_dip_mia_tpu_torch.utils import bridge

from torch_port_helpers import SMALL_NET, MixtureTable

torch.set_num_threads(1)

# the closed-form KL: the same elementwise f32 terms (all >= 0) summed in
# another order
KL_REL = 1e-6
# the MC KL: per-element terms of mixed sign, summed per leaf in JAX and over
# the flat segment in the port
MC_REL = 1e-5
# its gradient, as a share of the largest: elementwise, no sums
GRAD_REL = 1e-6
# JAX tests/test_vi.py:209: the reference's mixture prior schema
MIXTURE = {"mu": [0.0, 0.0], "sigma": [0.1, 0.0005], "pi": [0.75, 0.25]}


@pytest.fixture(scope="module")
def trees():
    net = jbuild(16, n_channels=2, **SMALL_NET)
    k1, k2 = jax.random.split(jax.random.PRNGKey(31))
    params_j = jax.jit(lambda a, b: jvi.to_mfvi(net.init(a), b))(k1, k2)
    flat = tvi.flatten(bridge.params_from_jax(
        jax.tree.map(np.asarray, params_j)))
    return params_j, flat


def _mixture_args(spec):
    loc = tuple(float(v) for v in spec["mu"])
    scale = tuple(float(v) + 1e-6 for v in spec["sigma"])
    return loc, scale, tuple(float(v) for v in spec["pi"])


def test_posterior_mean_params_against_jax(trees):
    params_j, flat = trees
    got = tvi.posterior_mean_params(bridge.params_from_jax(
        jax.tree.map(np.asarray, params_j)))
    ref = bridge.params_from_jax(jax.tree.map(
        np.asarray, jvi.posterior_mean_params(params_j)))
    assert list(got) == list(ref)
    assert not any(k.endswith(("_mu", "_rho")) for k in got)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.parametrize("kl_type", ["reverse", "forward"])
@pytest.mark.parametrize("prior_sigma", [1e-3 * 0.01, 0.1])
def test_kl_mfvi_both_directions_against_jax(trees, kl_type, prior_sigma):
    params_j, flat = trees
    ref = float(jvi.kl_mfvi(params_j, 0.0, prior_sigma, kl_type=kl_type))
    got = float(tvi.kl_mfvi(flat, 0.0, prior_sigma, kl_type=kl_type))
    assert np.isfinite(got) and abs(got - ref) <= KL_REL * abs(ref), (got,
                                                                      ref)


def test_kl_mfvi_rejects_an_unknown_direction(trees):
    with pytest.raises(ValueError, match="kl_type"):
        tvi.kl_mfvi(trees[1], 0.0, 0.1, kl_type="sideways")


def test_kl_mfvi_mc_and_its_gradient_against_jax(trees, monkeypatch):
    """The reverse MC KL against JAX's with one fixed mixture draw (JAX's
    _mixture_sample and the port's mixture_draw substituted), and its
    autograd gradient in mu and rho against jax.grad of JAX's."""
    params_j, flat = trees
    loc, scale, pi = _mixture_args(MIXTURE)
    table = MixtureTable(params_j, flat, seed=32, pi=pi)
    monkeypatch.setattr(jvi, "_mixture_sample", table.jax_sample)
    monkeypatch.setattr(tvi, "mixture_draw", table.port_draw)

    def kl_j(p):
        return jvi.kl_mfvi_mc(p, jax.random.PRNGKey(0), jnp.asarray(loc),
                              jnp.asarray(scale), jnp.asarray(pi))

    ref, g_j = jax.jit(jax.value_and_grad(kl_j))(params_j)
    p = flat.flat.clone().requires_grad_(True)
    got = tvi.kl_mfvi_mc(flat.with_flat(p), None,
                         tvi.Mixture.of(loc, scale, pi))
    got.backward()
    assert abs(got.item() - float(ref)) <= MC_REL * abs(float(ref))
    g_ref = tvi.flatten(bridge.params_from_jax(
        jax.tree.map(np.asarray, g_j))).flat
    scale_g = float(g_ref.abs().max())
    err = float((p.grad - g_ref).abs().max())
    assert err <= GRAD_REL * scale_g, (err, scale_g)
    # only the variational segments have a KL gradient
    assert not p.grad[2 * flat.n_var:].any()


def test_kl_mfvi_mc_forward_is_the_posterior_draw(trees, monkeypatch):
    """'forward' scores posterior minus prior at mu + softplus(rho) * z,
    with the table's normals as z: the same numbers in numpy float64."""
    _, flat = trees
    loc, scale, pi = _mixture_args(MIXTURE)
    z = np.random.default_rng(33).standard_normal(flat.n_var).astype(
        np.float32)
    monkeypatch.setattr(tvi, "mixture_draw", lambda n, cum, g: (
        torch.zeros(n, dtype=torch.long), torch.from_numpy(z)))
    got = float(tvi.kl_mfvi_mc(flat, None, tvi.Mixture.of(loc, scale, pi),
                               kl_type="forward"))
    mu = flat.mu.double().numpy()
    sig = np.log1p(np.exp(flat.rho.double().numpy()))
    s = mu + sig * z

    def lp(x, m, sd):
        return -(x - m) ** 2 / (2 * sd ** 2) - np.log(sd) - 0.5 * np.log(
            2 * np.pi)

    mix = np.logaddexp(*(lp(s, m, sd) + np.log(w)
                         for m, sd, w in zip(loc, scale, pi)))
    ref = float(np.sum(lp(s, mu, sig) - mix))
    assert abs(got - ref) <= MC_REL * abs(ref)


def test_kl_mfvi_mc_degenerate_mixture_matches_closed_form():
    """Two identical components are a Normal prior, so the MC estimate,
    averaged over draws, approaches the closed-form KL (JAX
    tests/test_vi.py:180)."""
    params = {"conv.w_mu": 0.3 * torch.ones(4, 4, 3, 3),
              "conv.w_rho": -2.0 * torch.ones(4, 4, 3, 3)}
    flat = tvi.flatten(params)
    sigma = 0.5
    exact = float(tvi.kl_mfvi(flat, 0.0, sigma))
    mix = tvi.Mixture.of((0.0, 0.0), (sigma + 1e-6,) * 2, (0.5, 0.5))
    gen = torch.Generator().manual_seed(0)
    ests = [float(tvi.kl_mfvi_mc(flat, gen, mix)) for _ in range(30)]
    assert np.mean(ests) == pytest.approx(exact, rel=0.08)


def test_mixture_draw_follows_the_weights():
    mix = tvi.Mixture.of((0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (0.2, 0.5, 0.3))
    comp, z = tvi.mixture_draw(200_000, mix.cum,
                               torch.Generator().manual_seed(1))
    share = np.bincount(comp.numpy(), minlength=3) / comp.numel()
    np.testing.assert_allclose(share, [0.2, 0.5, 0.3], atol=5e-3)
    assert abs(float(z.mean())) < 1e-2 and abs(float(z.std()) - 1) < 1e-2


def test_priors_against_jax(monkeypatch):
    """make_prior's two schemas, log_prob on one grid, and the MC KL with
    the same samples on both sides (``sample`` substituted)."""
    for spec in (MIXTURE, {"mu": 0.1, "sigma": 0.3}):
        p_j, p_t = jpriors.make_prior(spec), tpriors.make_prior(spec)
        assert type(p_j).__name__ == type(p_t).__name__
        for f in ("loc", "scale") + (("pi",) if "pi" in spec else ()):
            assert getattr(p_j, f) == getattr(p_t, f), f
        x = np.linspace(-0.4, 0.4, 41).astype(np.float32)
        np.testing.assert_allclose(p_t.log_prob(torch.from_numpy(x)).numpy(),
                                   np.asarray(p_j.log_prob(jnp.asarray(x))),
                                   rtol=1e-6, atol=1e-5)

    samples = np.random.default_rng(34).normal(0, 0.05, (3, 50)).astype(
        np.float32)
    p_j, q_j = jpriors.make_prior(MIXTURE), jpriors.NormalPrior(0.0, 0.1)
    p_t, q_t = tpriors.make_prior(MIXTURE), tpriors.NormalPrior(0.0, 0.1)
    calls = {"j": 0, "t": 0}

    def fixed(side, wrap):
        def sample(self, key, shape):
            calls[side] += 1
            return wrap(samples[calls[side] - 1].reshape(shape))
        return sample

    monkeypatch.setattr(jpriors.MixtureNormalPrior, "sample",
                        fixed("j", jnp.asarray))
    monkeypatch.setattr(tpriors.MixtureNormalPrior, "sample",
                        fixed("t", torch.from_numpy))
    ref = jpriors.mc_kl_divergence(jax.random.PRNGKey(0), p_j, q_j, (50,),
                                   n_samples=3)
    got = tpriors.mc_kl_divergence(None, p_t, q_t, (50,), n_samples=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_prior_samples_have_the_prior_moments():
    gen = torch.Generator().manual_seed(2)
    s = tpriors.make_prior(MIXTURE).sample(gen, (400, 500))
    assert s.shape == (400, 500)
    # Var = 0.75 * 0.1^2 + 0.25 * 0.0005^2
    assert abs(float(s.var()) - 0.75 * 0.1 ** 2) < 2e-4
    n = tpriors.NormalPrior(1.0, 2.0).sample(gen, (100_000,))
    assert abs(float(n.mean()) - 1.0) < 0.03 and abs(float(n.std()) - 2) < 0.03
