"""The trainer's tail (mfvi_dip_mia_tpu_torch/tasks/trainer.py) against the
JAX package's: the scale-mixture prior's step, checkpoint / resume, early
stop, and the ELU / Swish nets (nn/skip.py, nn/layers.py).

The locksteps reuse tests/test_torch_trainer.py's: both packages' den/MFVI
fit at 64^2 on the 2-scale net, from the same parameters, input and RT eps,
with the input jitter off; under the mixture prior both sides also take one
fixed mixture draw (tests/torch_port_helpers.py::MixtureTable)."""

import os
import types

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import mfvi_dip_mia_tpu.bayes.vi as jvi
import mfvi_dip_mia_tpu.tasks.problems as JP
import mfvi_dip_mia_tpu.tasks.trainer as JT
from mfvi_dip_mia_tpu.nn import build_skip_net as jbuild
import mfvi_dip_mia_tpu_torch.bayes.vi as tvi
import mfvi_dip_mia_tpu_torch.tasks.problems as TP
import mfvi_dip_mia_tpu_torch.tasks.trainer as TT
from mfvi_dip_mia_tpu_torch.nn import build_skip_net as tbuild
from mfvi_dip_mia_tpu_torch.ops.kernels import fused_block as tfb
from mfvi_dip_mia_tpu_torch.utils import bridge

from torch_port_helpers import SMALL_NET, MixtureTable, jax_eps_order
from test_torch_trainer import LR, PRIORS, SIZE, _lockstep, _patch_problems

torch.set_num_threads(1)

MIXTURE = {"mu": [0.0, 0.0], "sigma": [0.1, 0.0005], "pi": [0.75, 0.25]}
N_STEPS = 4
# the transplant golden's tolerance (tests/test_torch_skip.py)
GOLDEN = dict(atol=2e-4, rtol=1e-3)


def _psnr_tol(i):
    return 2e-3 * (1 + i)


def _hold_psnrs(res_t, res_j, n):
    assert res_t.psnrs.shape == res_j.psnrs.shape
    for i in range(n):
        for col in range(3):
            assert abs(res_t.psnrs[i, col] - res_j.psnrs[i, col]) < \
                _psnr_tol(i), (i, col, res_t.psnrs[i], res_j.psnrs[i])


# -- the scale-mixture prior ---------------------------------------------------

@pytest.mark.parametrize("temp", [PRIORS["den"][0], 1e-3])
def test_mixture_prior_lockstep_against_jax(monkeypatch, temp):
    """den/MFVI with the reference's mixture prior: one mixture table on
    both sides. At temp 1e-3 the KL's gradient outweighs the data's, so a
    KL gradient added twice (by autograd and by the fused AdamW) would
    part the two fits."""
    prob_j, prob_t = _lockstep(monkeypatch, SIZE, jax_fused=False)("den")
    # the JAX init the lockstep substituted, as the JAX step will see it
    params_j = JT._get_init_fn(prob_j, "mfvi",
                               types.SimpleNamespace(init=lambda p: None),
                               None)()[0]
    flat = tvi.flatten(TT.init_params(prob_t, TT.Method("mfvi"), 0))
    table = MixtureTable(params_j, flat, seed=41, pi=MIXTURE["pi"])
    monkeypatch.setattr(jvi, "_mixture_sample", table.jax_sample)
    monkeypatch.setattr(tvi, "mixture_draw", table.port_draw)
    sigma = PRIORS["den"][1]
    kw = dict(num_iter=N_STEPS - 1, lr=LR, seed=1, show_every=N_STEPS)
    res_t = TT.fit(prob_t, TT.Method("mfvi", temp=temp, sigma=sigma,
                                     prior=MIXTURE), device="cpu", **kw)
    res_j = JT.fit(prob_j, JT.Method("mfvi", temp=temp, sigma=sigma,
                                     prior=MIXTURE), layout="auto", **kw)
    assert table.jax_calls >= len(jax_eps_order(params_j))
    _hold_psnrs(res_t, res_j, N_STEPS)
    assert abs(res_t.psnrs[-1, 1] - res_t.psnrs[0, 1]) > 10 * _psnr_tol(
        N_STEPS)
    np.testing.assert_allclose(res_t.ssims, res_j.ssims, atol=1e-4)


def test_hyperparams_of_a_mixture_prior_against_jax():
    m_t = TT.Method("mfvi", temp=1e-6, sigma=0.01, prior=MIXTURE)
    hp_t = TT.HyperParams.of(m_t, 1e-3)
    hp_j = JT.HyperParams.of(JT.Method("mfvi", temp=1e-6, sigma=0.01,
                                       prior=MIXTURE), 1e-3)
    for f in ("prior_loc", "prior_scale", "prior_pi"):
        np.testing.assert_allclose(np.asarray(getattr(hp_t, f), np.float32),
                                   np.asarray(getattr(hp_j, f)), rtol=1e-6)
    # no 'pi': the scalar prior, as JAX's K = 0
    for prior in (None, {"mu": 0.0, "sigma": 0.1}):
        hp = TT.HyperParams.of(TT.Method("mfvi", prior=prior), 1e-3)
        assert hp.prior_loc == hp.prior_scale == hp.prior_pi == ()


def test_mixture_step_adds_no_analytic_kl_gradient(small_problems,
                                                   monkeypatch):
    """The mixture step's AdamW is called with use_kl=False and the MC KL's
    gradient arrives in its grad; the scalar prior's keeps use_kl=True."""
    import mfvi_dip_mia_tpu_torch.optim.fused_adamw as FA
    seen = []
    update = FA.flat_adamw_update

    def spy(p, g, *args, **kw):
        seen.append((kw["use_kl"], g.clone()))
        return update(p, g, *args, **kw)

    monkeypatch.setattr(TT, "flat_adamw_update", spy)
    prob = TP.build_problem("den", "mfvi", 0, device="cpu")
    kw = dict(num_iter=0, lr=LR, seed=2, show_every=1, device="cpu",
              collect_snapshots=False)
    for temp in (0.0, 1.0):
        TT.fit(prob, TT.Method("mfvi", temp=temp, sigma=0.1, prior=MIXTURE),
               **kw)
    TT.fit(prob, TT.Method("mfvi", temp=1.0, sigma=0.1), **kw)
    (kl0, g0), (kl1, g1), (kl2, _) = seen
    assert (kl0, kl1, kl2) == (False, False, True)
    n = TT.vi.flatten(TT.init_params(prob, TT.Method("mfvi"), 2)).n_var
    # the KL moves the variational gradient only, and at temp 1 dominates it
    assert not torch.equal(g0[:2 * n], g1[:2 * n])
    assert torch.equal(g0[2 * n:], g1[2 * n:])


@pytest.fixture
def small_problems(monkeypatch):
    _patch_problems(monkeypatch, SIZE)


# -- checkpoint / resume -------------------------------------------------------

RESUME_METHODS = {
    "mfvi mixture": TT.Method("mfvi", *PRIORS["den"], prior=MIXTURE),
    "sgld": TT.Method("sgld", weight_decay=3e-4, gamma=0.99),
    "mcd": TT.Method("mcd", dropout_p=0.3, weight_decay=3e-4),
}


@pytest.mark.parametrize("name", list(RESUME_METHODS))
def test_resumed_fit_is_the_uninterrupted_one(small_problems, tmp_path,
                                              name):
    """20 iterations in chunks of 5 with a checkpoint every 2 chunks: the
    file holds chunk 2; a fit resumed from it gives the uninterrupted fit's
    bits in every row, snapshot and parameter (sgld's decayed lr and the
    generator's stream included)."""
    method = RESUME_METHODS[name]
    prob = TP.build_problem("den", method.name, 0, device="cpu")
    ckpt = str(tmp_path / "fit.npz")
    kw = dict(num_iter=19, lr=LR, seed=5, show_every=5, device="cpu")
    full = TT.fit(prob, method, **kw)
    saved = []
    save = TT.save_fit_checkpoint
    with pytest.MonkeyPatch.context() as m:
        m.setattr(TT, "save_fit_checkpoint",
                  lambda path, state, gen, chunk, host:
                  (saved.append(chunk), save(path, state, gen, chunk, host)))
        again = TT.fit(prob, method, checkpoint_path=ckpt,
                       checkpoint_every_chunks=2, **kw)
    assert saved == [2]
    with np.load(ckpt) as z:
        assert int(z["chunk"]) == 2
        assert int(z["state_it"][0]) == 10
        assert np.isnan(z["host_rows"][10:]).all()
    resumed = TT.fit(prob, method, checkpoint_path=ckpt, resume=True, **kw)
    for res in (again, resumed):
        for f in ("mse_corrupted", "mse_gt", "psnrs", "ssims", "recons",
                  "uncerts_epi", "uncerts_ale"):
            np.testing.assert_array_equal(getattr(res, f), getattr(full, f),
                                          err_msg=f)
        for k in full.params:
            np.testing.assert_array_equal(res.params[k], full.params[k],
                                          err_msg=k)
    assert resumed.executed == full.executed == 20
    assert resumed.final_psnr == full.final_psnr


def test_resume_without_a_file_starts_afresh(small_problems, tmp_path):
    prob = TP.build_problem("den", "dip", 0, device="cpu")
    kw = dict(num_iter=5, lr=LR, seed=6, show_every=3, device="cpu")
    a = TT.fit(prob, TT.Method("dip"), **kw)
    b = TT.fit(prob, TT.Method("dip"), resume=True,
               checkpoint_path=str(tmp_path / "none.npz"), **kw)
    np.testing.assert_array_equal(a.psnrs, b.psnrs)


@pytest.mark.parametrize("num_iter,show,every", [(40, 10, 2), (45, 10, 1)])
def test_checkpoint_chunks_are_jax_s(small_problems, tmp_path, num_iter,
                                     show, every):
    """The port writes its checkpoints after the same chunks as JAX's fit
    (JAX tests/test_aux.py:118)."""
    chunks = {"j": [], "t": []}
    for side, T in (("j", JT), ("t", TT)):
        save = T.save_fit_checkpoint

        def spy(path, state, *rest, side=side, save=save):
            chunks[side].append(rest[-2])
            return save(path, state, *rest)

        with pytest.MonkeyPatch.context() as m:
            m.setattr(T, "save_fit_checkpoint", spy)
            kw = dict(num_iter=num_iter, lr=2e-3, seed=3, show_every=show,
                      checkpoint_path=str(tmp_path / f"{side}.npz"),
                      checkpoint_every_chunks=every)
            if side == "j":
                JT.fit(JP.build_problem("den", "dip", 0, input_depth=16),
                       JT.Method("dip"), **kw)
            else:
                TT.fit(TP.build_problem("den", "dip", 0, device="cpu"),
                       TT.Method("dip"), device="cpu", **kw)
    n_chunks = -(-(num_iter + 1) // show)
    assert chunks["t"] == chunks["j"] == [
        c for c in range(1, n_chunks) if c % every == 0]


# -- early stop ----------------------------------------------------------------

def test_early_stop_executed_against_jax(monkeypatch):
    """On the lockstep an impossible min_delta stops both fits after the
    same chunk: with chunks of 5 and patience 10 the best row of chunk 0
    (iteration 0-4) is 10 iterations old at the end of chunk 2, wherever it
    lies in chunk 0, so the stop does not hang on a PSNR difference."""
    prob_j, prob_t = _lockstep(monkeypatch, SIZE, jax_fused=False)("den")
    temp, sigma = PRIORS["den"]
    kw = dict(num_iter=39, lr=LR, seed=1, show_every=5,
              early_stop={"patience": 10, "min_delta": 100.0})
    res_t = TT.fit(prob_t, TT.Method("mfvi", temp=temp, sigma=sigma),
                   device="cpu", **kw)
    res_j = JT.fit(prob_j, JT.Method("mfvi", temp=temp, sigma=sigma),
                   layout="auto", **kw)
    assert res_t.executed == res_j.executed == 15
    assert np.isfinite(res_t.psnrs[:15]).all()
    assert np.isnan(res_t.psnrs[15:]).all() and np.isnan(
        res_t.mse_gt[15:]).all()
    _hold_psnrs(res_t, res_j, 15)
    assert res_t.final_psnr == res_t.psnrs[14, 2]
    assert abs(res_t.final_psnr - res_j.final_psnr) < _psnr_tol(15)


@pytest.mark.parametrize("seed", range(4))
def test_early_stop_decisions_against_jax(seed):
    """The port's _EarlyStop against JAX's on random smoothed-PSNR rows with
    NaN gaps (metrics_every > 1) and plateaus."""
    rng = np.random.default_rng(seed)
    spec = {"patience": int(rng.integers(5, 40)),
            "min_delta": float(rng.choice([0.0, 0.05, 0.5]))}
    col = np.cumsum(rng.normal(0.05, 0.3, 400))
    col[rng.random(400) < 0.3] = np.nan
    col[200:] = col[199] if np.isfinite(col[199]) else 1.0
    es_t, es_j = TT._EarlyStop(spec), JT._EarlyStop(spec)
    chunk = int(rng.integers(3, 17))
    for start in range(0, 400, chunk):
        rows = col[start:start + chunk]
        assert es_t.should_stop(rows, start) == es_j.should_stop(rows, start)
        assert (es_t.best, es_t.best_iter) == (es_j.best, es_j.best_iter)


def test_early_stopped_runner_writes_its_rows(small_problems, tmp_path):
    import mfvi_dip_mia_tpu_torch.tasks.runners as TR
    psnr = TR.run_den_dip(device="cpu", num_iter=60, show_every=5, lr=LR,
                          seed=1, plot=False, save=True,
                          save_path=str(tmp_path),
                          early_stop={"patience": 5, "min_delta": 100.0})
    (run,) = os.listdir(tmp_path)
    z = np.load(tmp_path / run / "save.npz", allow_pickle=True)
    p = z["psnrs"].item()["dip"]
    n = int(np.isfinite(p[:, 2]).sum())
    assert 5 < n < 61 and np.isnan(p[n:]).all()
    assert psnr == p[n - 1, 2]


# -- ELU and Swish nets --------------------------------------------------------

def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("act", ["ELU", "Swish"])
def test_activation_net_golden_against_jax(act, monkeypatch):
    """The same deterministic weights through both nets: the forward within
    the transplant golden's tolerance, and no site of the port's net on the
    fused block (each runs the conv kernel and the BN chain with its
    activation)."""
    monkeypatch.setenv("MFVI_DIP_FUSED_BLOCK", "0")
    fused = []
    fwd = tfb.fwd
    monkeypatch.setattr(tfb, "fwd", lambda *a: fused.append(a[0].shape)
                        or fwd(*a))
    net_j = jbuild(16, n_channels=2, act_fun=act, **SMALL_NET)
    params_j = jax.jit(net_j.init)(jax.random.PRNGKey(42))
    x = (np.random.default_rng(43).uniform(size=(1, 32, 48, 16)) * 0.5
         ).astype(np.float32)
    out_j = jax.jit(lambda p: net_j.apply(p, jnp.asarray(x), key=None,
                                          training=True,
                                          layout="auto"))(params_j)
    net_t = tbuild(16, n_channels=2, act_fun=act, **SMALL_NET)
    leaves = bridge.params_from_jax(jax.tree.map(np.asarray, params_j))
    with torch.no_grad():
        out_t = net_t(leaves, _nchw(x))
    assert fused == []
    np.testing.assert_allclose(out_t.numpy().transpose(0, 2, 3, 1),
                               np.asarray(out_j), **GOLDEN)
    # the LeakyReLU net on the same weights does fuse
    with torch.no_grad():
        tbuild(16, n_channels=2, **SMALL_NET)(leaves, _nchw(x))
    assert len(fused) == 8


def test_activations_against_jax():
    from mfvi_dip_mia_tpu.nn import layers as jl
    from mfvi_dip_mia_tpu_torch.nn import layers as tl
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    for name in ("LeakyReLU", "ELU", "Swish", "none"):
        got = tl.activation(name)(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, np.asarray(jl.activation(name)(
            jnp.asarray(x))), rtol=1e-6, atol=1e-7, err_msg=name)
    with pytest.raises(ValueError, match="unknown activation"):
        tl.activation("GELU")


@pytest.mark.parametrize("act", ["ELU", "Swish"])
def test_activation_net_lockstep_against_jax(monkeypatch, act):
    setup = _lockstep(monkeypatch, SIZE, jax_fused=False)
    monkeypatch.setattr(JP, "_standard_net", lambda n, m, dp, input_depth=16:
                        jbuild(input_depth, n_channels=n, act_fun=act,
                               **SMALL_NET))
    monkeypatch.setattr(TP, "_standard_net", lambda n, m, dp, input_depth=16:
                        tbuild(input_depth, n_channels=n, act_fun=act,
                               **SMALL_NET))
    prob_j, prob_t = setup("den")
    temp, sigma = PRIORS["den"]
    kw = dict(num_iter=N_STEPS - 1, lr=LR, seed=1, show_every=N_STEPS)
    res_t = TT.fit(prob_t, TT.Method("mfvi", temp=temp, sigma=sigma),
                   device="cpu", **kw)
    res_j = JT.fit(prob_j, JT.Method("mfvi", temp=temp, sigma=sigma),
                   layout="auto", **kw)
    _hold_psnrs(res_t, res_j, N_STEPS)
    assert abs(res_t.psnrs[-1, 1] - res_t.psnrs[0, 1]) > 10 * _psnr_tol(
        N_STEPS)
