"""The pieces of dip / mcd / sgld in the port against the JAX package's:
dropout and dropout2d on the same keep mask, MC dropout at a function's
output, the mcd skip net (its dropout sites keep their bias and leave the
fused block; a forward golden on one mask table), SGLD's floored lr decay,
its parameter noise on the conv kernels, the static step of each method,
mcd's MC summary against JAX's mc_predict on the same mask tables, and the
six runners' save.npz keys and snapshots."""

import glob
import importlib
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import mfvi_dip_mia_tpu.nn.layers as JLY
import mfvi_dip_mia_tpu.nn.skip as JS
import mfvi_dip_mia_tpu.tasks.problems as JP
import mfvi_dip_mia_tpu.tasks.runners as JR
import mfvi_dip_mia_tpu.tasks.trainer as JT
from mfvi_dip_mia_tpu.bayes import dropout as JD
from mfvi_dip_mia_tpu.bayes import uncertainty as JU
from mfvi_dip_mia_tpu.nn import build_skip_net as jbuild
from mfvi_dip_mia_tpu.ops.metrics import psnr as jpsnr
import mfvi_dip_mia_tpu_torch.nn.layers as TL
import mfvi_dip_mia_tpu_torch.nn.var_conv as tvc
import mfvi_dip_mia_tpu_torch.optim.sgld as TS
import mfvi_dip_mia_tpu_torch.tasks.problems as TP
import mfvi_dip_mia_tpu_torch.tasks.runners as TR
import mfvi_dip_mia_tpu_torch.tasks.trainer as TT
from mfvi_dip_mia_tpu_torch.bayes import dropout as TD
from mfvi_dip_mia_tpu_torch.bayes import vi as tvi
from mfvi_dip_mia_tpu_torch.nn import build_skip_net as tbuild
from mfvi_dip_mia_tpu_torch.ops.kernels import cf_conv as tcf
from mfvi_dip_mia_tpu_torch.ops.kernels import fused_block as tfb
from mfvi_dip_mia_tpu_torch.utils import bridge

from test_torch_trainer import _patch_problems
from torch_port_helpers import SMALL_NET, MaskTable, dropout_kwargs

# the JAX package's optim/__init__.py exports the function sgld by that name
JSG = importlib.import_module("mfvi_dip_mia_tpu.optim.sgld")

torch.set_num_threads(1)

SIZE = 64
# forward: the tolerance of test_skip.py's torch-transplant golden
GOLDEN = dict(atol=2e-4, rtol=1e-3)
MC_KEYS = {"mc_mean_recon", "mc_mean_psnr", "mc_mean_ssim", "mc_ale",
           "mc_epi"}
FIVE_SCALES = dict(pad="reflection", skip_n33d=[16, 32, 64, 128, 128],
                   skip_n33u=[16, 32, 64, 128, 128], skip_n11=4,
                   num_scales=5, upsample_mode="bilinear")


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


# -- dropout -------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["dropout", "dropout2d"])
def test_dropout_against_jax_on_the_same_mask(monkeypatch, kind):
    p = 0.3
    x = np.random.default_rng(0).standard_normal((1, 8, 16, 16)).astype(
        np.float32)
    key = jax.random.PRNGKey(4)
    out_j = np.asarray(getattr(JLY, kind)(jnp.asarray(x.transpose(
        0, 2, 3, 1)), p, key)).transpose(0, 3, 1, 2)
    shape = (1, 16, 16, 8) if kind == "dropout" else (1, 1, 1, 8)
    keep = np.array(jax.random.bernoulli(key, 1.0 - p, shape)).transpose(
        0, 3, 1, 2).copy()
    seen = []

    def fixed(shape, keep_prob, generator):
        seen.append((tuple(shape), keep_prob))
        return torch.from_numpy(keep)

    monkeypatch.setattr(TL, "dropout_keep", fixed)
    out_t = getattr(TL, kind)(torch.from_numpy(x), p, torch.Generator())
    assert seen == [(keep.shape, 1.0 - p)]
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=1e-6, atol=0)
    assert (out_t.numpy() == 0).any() and (out_t.numpy() != 0).any()


def test_dropout_masks_from_the_generator():
    x = torch.ones(1, 64, 32, 32)
    out = TL.dropout2d(x, 0.25, torch.Generator().manual_seed(1))
    per_channel = out[0].reshape(64, -1)
    # whole channels are dropped or kept, the kept ones scaled by 1/(1-p)
    assert ((per_channel == 0).all(1) | (per_channel == 1 / 0.75).all(1)).all()
    again = TL.dropout2d(x, 0.25, torch.Generator().manual_seed(1))
    assert torch.equal(out, again)
    elems = TL.dropout(torch.ones(200_000), 0.25,
                       torch.Generator().manual_seed(2))
    assert abs(float((elems == 0).float().mean()) - 0.25) < 0.01
    assert torch.equal(TL.dropout2d(x, 0.0, torch.Generator()), x)


@pytest.mark.parametrize("mode", ["2d", "1d"])
def test_mc_dropout_apply_against_jax(monkeypatch, mode):
    """An apply function with dropout at its output: the same output on the
    same mask, and no dropout without a generator (JAX: without a key)."""
    w = np.random.default_rng(1).standard_normal((4, 3)).astype(np.float32)
    x = np.random.default_rng(2).standard_normal((1, 8, 8, 3)).astype(
        np.float32)
    p = 0.4
    apply_j = JD.mc_dropout_apply(lambda prm, x, key=None: x @ prm, p, mode)
    key = jax.random.PRNGKey(5)
    out_j = np.asarray(apply_j(jnp.asarray(w.T), jnp.asarray(x), key=key))
    dkey = jax.random.fold_in(key, 0xD0)
    shape = (1, 1, 1, 4) if mode == "2d" else (1, 8, 8, 4)
    keep = np.array(jax.random.bernoulli(dkey, 1.0 - p, shape)).transpose(
        0, 3, 1, 2).copy()
    monkeypatch.setattr(TL, "dropout_keep", lambda s, k, g:
                        torch.from_numpy(keep))
    apply_t = TD.mc_dropout_apply(
        lambda prm, x, generator: torch.einsum("oi,nihw->nohw", prm, x),
        p, mode)
    got = apply_t(torch.from_numpy(w), _nchw(x), torch.Generator())
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), out_j,
                               rtol=1e-5, atol=1e-6)
    plain = apply_t(torch.from_numpy(w), _nchw(x))
    np.testing.assert_allclose(
        plain.numpy().transpose(0, 2, 3, 1),
        np.asarray(apply_j(jnp.asarray(w.T), jnp.asarray(x))), rtol=1e-5,
        atol=1e-6)


# -- the mcd skip net ------------------------------------------------------------

@pytest.mark.parametrize("method,n_fused,n_bias", [("dip", 20, 1),
                                                   ("mcd", 5, 21)])
def test_mcd_dropout_sites_keep_their_bias_and_do_not_fuse(
        monkeypatch, method, n_fused, n_bias):
    """The 5-scale net: under dip the 20 stride-1 sites fuse and only the
    output conv adds its bias; under mcd the 20 dropout sites (down1, down2,
    up, up1x1 at each level) run the conv kernel with their bias, and only
    the 5 skip sites fuse (skip.py:322-343)."""
    fused, biased, drops = [], [], []
    fwd, conv = tfb.fwd, tcf.conv2d_cf
    monkeypatch.setattr(tfb, "fwd", lambda *a: fused.append(1) or fwd(*a))

    def conv_spy(x, w, b=None, *args):
        biased.append(b is not None)
        return conv(x, w, b, *args)

    monkeypatch.setattr(tvc, "conv2d_cf", conv_spy)
    keep = TL.dropout_keep
    monkeypatch.setattr(TL, "dropout_keep", lambda s, k, g: drops.append(k)
                        or keep(s, k, g))
    net = tbuild(16, n_channels=2, **FIVE_SCALES,
                 **dropout_kwargs(method, 0.2))
    params = net.init_params(torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = net(params, torch.rand(1, 16, SIZE, SIZE) * 0.1,
                  torch.Generator().manual_seed(1), dropout_p=0.4)
    assert out.shape == (1, 2, SIZE, SIZE) and torch.isfinite(out).all()
    assert len(fused) == n_fused
    assert sum(biased) == n_bias and len(biased) == 26 - n_fused
    # dropout_p overrides every site's rate
    assert drops == ([] if method == "dip" else [pytest.approx(0.6)] * 20)
    if method == "mcd":
        with pytest.raises(ValueError, match="generator"):
            net(params, torch.rand(1, 16, SIZE, SIZE))
        with torch.no_grad():
            evals = [net(params, torch.ones(1, 16, SIZE, SIZE) * 0.05,
                         training=False) for _ in range(2)]
        assert torch.equal(*evals)


def test_mcd_forward_golden_against_jax(monkeypatch):
    """The 2-scale mcd net on JAX's weights and one mask table: the
    transplant golden of test_skip.py (2e-4)."""
    kw = dropout_kwargs("mcd", 0.3)
    net_j = jbuild(16, n_channels=2, **SMALL_NET, **kw)
    params_j = jax.tree.map(jnp.asarray, net_j.init(jax.random.PRNGKey(3)))
    params_t = bridge.params_from_jax(jax.tree.map(np.asarray, params_j))
    x = (np.random.default_rng(10).uniform(size=(1, 32, 64, 16)) * 0.1
         ).astype(np.float32)
    table = MaskTable(7, 8)
    monkeypatch.setattr(TL, "dropout_keep", table.port_keep)
    monkeypatch.setattr(JS._NHWCOps, "dropout2d",
                        staticmethod(table.jax_dropout2d()))
    with torch.no_grad():
        out_t = tbuild(16, n_channels=2, **SMALL_NET, **kw)(
            params_t, _nchw(x), torch.Generator())
    out_j = jax.jit(lambda prm: net_j.apply(
        prm, jnp.asarray(x), key=jax.random.PRNGKey(0), training=True))(
        params_j)
    assert table.port_calls == 8
    np.testing.assert_allclose(out_t.numpy().transpose(0, 2, 3, 1),
                               np.asarray(out_j), **GOLDEN)


# -- SGLD ----------------------------------------------------------------------

def _ulps(a, b):
    a, b = np.float32(a), np.float32(b)
    if a == b:                  # also both infinite (gamma > 1, far out)
        return 0.0
    return abs(float(a) - float(b)) / float(np.spacing(max(abs(a), abs(b))))


def _n_stop(lr, gamma):
    """The iteration where JAX's _sgld_lr stops decaying (its formula in
    jnp, trainer.py:138-139); None when it never stops."""
    hp = JT.HyperParams.of(JT.Method("sgld", gamma=gamma), lr)
    n = jnp.ceil(jnp.log(1e-8 / hp.lr) / jnp.log(hp.gamma))
    return None if gamma >= 1.0 else int(max(float(n), 0.0))


@pytest.mark.parametrize("lr,gamma", [
    (0.004, 0.9995), (0.004, 0.99993), (0.004, 0.999999),
    (0.004, 0.9998853994046778), (0.004, 0.01), (0.001, 0.5),
    (0.004, 1.0), (0.004, 1.0001), (1e-9, 0.9)])
def test_sgld_decayed_lr_against_jax(lr, gamma):
    """The port's DecayedLR (the trainer's sgld lr) against JAX's _sgld_lr
    around the iteration where the decay stops (and at 0, 1, far past it):
    equal or within one float32 ulp."""
    hp = JT.HyperParams.of(JT.Method("sgld", gamma=gamma), lr)
    decay = TS.DecayedLR(lr, gamma, "cpu")
    n = _n_stop(lr, gamma)
    its = {0, 1, 2, 10 ** 7}
    if n is not None:
        its |= {max(n + d, 0) for d in (-2, -1, 0, 1, 2)}
    got = [float(decay.at(torch.tensor([it]))[0]) for it in sorted(its)]
    ref = [float(JT._sgld_lr(hp, it)) for it in sorted(its)]
    assert all(_ulps(g, r) <= 1 for g, r in zip(got, ref)), (got, ref)
    if n is not None:
        # the decay holds from n_stop on
        assert got[-1] == float(decay.at(torch.tensor([n]))[0])
        assert float(decay.n_stop) == n
    sched_t = TS.exponential_decay_floored(lr, gamma)
    sched_j = JSG.exponential_decay_floored(lr, gamma)
    for it in sorted(its):
        assert _ulps(sched_t(it), sched_j(it)) <= 1, it


def test_sgld_noise_on_the_conv_kernels_only():
    net = tbuild(16, n_channels=2, **SMALL_NET)
    params = tvi.flatten(net.init_params(torch.Generator().manual_seed(0)))
    idx = TS.kernel_index(params)
    kernels = [n for n, s in zip(params.names, params.shapes) if len(s) == 4]
    assert len(kernels) == net.num_conv_sites
    assert idx.numel() == len(set(idx.tolist())) == sum(
        params.leaves()[n].numel() for n in kernels)
    before = params.flat.clone()
    TS.add_param_noise(params.flat, idx, torch.Generator().manual_seed(3),
                       2.0, 1e-3)
    moved = params.flat != before
    for name, t in params.leaves().items():
        changed = bool(moved[params.offsets[params.names.index(name)]:][
            :t.numel()].any())
        assert changed == (t.dim() == 4), name
    eps = TS.param_noise_eps(idx.numel(), torch.Generator().manual_seed(3))
    assert torch.equal(params.flat[idx], before[idx] + eps * 2.0 * 1e-3)


# -- the static step of each method ------------------------------------------------

@pytest.fixture
def small(monkeypatch):
    _patch_problems(monkeypatch, SIZE)


@pytest.mark.parametrize("task,name", [("den", "dip"), ("ct", "mcd"),
                                       ("den", "sgld"), ("ct", "sgld")])
def test_the_step_of_each_method_reads_nothing_back(small, monkeypatch,
                                                    task, name):
    """No host reads in a step (they would stall a capture), the state
    keeps its storage, and sgld's lr is read from the device iteration: on
    den two steps from one state at iterations 0 and 10 differ by the
    decayed lr alone; ct keeps the constant lr."""
    prob = TP.build_problem(task, name, 0, device="cpu")
    method = TT.Method(name, dropout_p=0.2, weight_decay=1e-3, gamma=0.5)
    prep = TT.prepare_fit(prob, method, iterations=4, lr=1e-3, seed=3,
                          device="cpu")
    ptrs = [t.data_ptr() for t in prep.state.tensors()]
    start = prep.state.clone()
    gen_start = prep.generator.get_state()
    reads = ("item", "cpu", "numpy", "tolist", "__bool__", "__int__",
             "__float__", "__index__")

    def refuse(attr):
        def read(*args, **kw):
            raise AssertionError(f"the step called Tensor.{attr}")
        return read

    with monkeypatch.context() as m:
        for attr in reads:
            m.setattr(torch.Tensor, attr, refuse(attr))
        for it in range(4):
            prep.step(prep.state, it % 2 == 0)
    assert [t.data_ptr() for t in prep.state.tensors()] == ptrs
    assert prep.state.it.tolist() == [4]
    assert np.isfinite(prep.state.rows.numpy()[[0, 2]]).all()
    if name == "sgld":
        moves = []
        for it in (0, 10):
            s = start.clone()
            s.it.fill_(it)
            prep.generator.set_state(gen_start)
            prep.step(s, False)
            moves.append(s.flat)
        assert torch.equal(moves[0], moves[1]) == (task == "ct")


def test_sgld_noise_persists_when_the_guard_skips_the_update(small,
                                                             monkeypatch):
    """A non-finite loss keeps the optimizer state and the parameters as
    they were after the noise, not before it (trainer.py:298-300)."""
    prob = TP.build_problem("den", "sgld", 0, device="cpu")
    init = TT.init_params(prob, TT.Method("sgld"), 4)
    eps = []
    draw = TS.param_noise_eps
    monkeypatch.setattr(TS, "param_noise_eps", lambda n, g: eps.append(
        draw(n, g)) or eps[-1])
    real_loss = prob.data_loss
    monkeypatch.setattr(prob, "data_loss",
                        lambda out: real_loss(out) * float("nan"))
    res = TT.fit(prob, TT.Method("sgld", weight_decay=0.1), num_iter=1,
                 lr=1e-3, seed=4, show_every=3, device="cpu")
    flat = tvi.flatten(init)
    idx = TS.kernel_index(flat)
    expect = flat.flat.clone()
    for e in eps:
        expect.index_add_(0, idx, e * 2.0 * 1e-3)
    assert len(eps) == 2
    got = tvi.flatten({k: torch.from_numpy(v) for k, v in res.params.items()})
    assert got.names == flat.names
    assert torch.equal(got.flat, expect)


def test_init_is_the_torch_default_outside_mfvi(small):
    prob = TP.build_problem("den", "dip", 0, device="cpu")
    det = TT.init_params(prob, TT.Method("dip"), 5)
    assert set(det) == set(prob.net.init_params(torch.Generator()))
    assert not any(k.endswith(("_mu", "_rho")) for k in det)
    var = TT.init_params(prob, TT.Method("mfvi"), 5)
    assert any(k.endswith("_rho") for k in var)


# -- the MC summary ------------------------------------------------------------

def test_mcd_mc_summary_against_jax_mc_predict(small, monkeypatch):
    """mcd's summary: three samples, each on its own mask table; JAX's
    mc_predict draws one sample per table (its forward is traced once per
    call), stacked and decomposed as JAX's runner does."""
    p = 0.3
    prob_t = TP.build_problem("den", "mcd", 0, device="cpu", dropout_p=p)
    prob_j = JP.build_problem("den", "mcd", 0, dropout_p=p)
    params_j = jax.tree.map(jnp.asarray,
                            prob_j.net.init(jax.random.PRNGKey(8)))
    params_np = {k: v.numpy() for k, v in bridge.params_from_jax(
        jax.tree.map(np.asarray, params_j)).items()}
    z = (np.random.default_rng(9).uniform(size=(1, SIZE, SIZE, 16)) * 0.1
         ).astype(np.float32)
    n = 3
    table = MaskTable(11, 8, n_tables=n)
    monkeypatch.setattr(TL, "dropout_keep", table.port_keep)
    got = TR.mc_summary(prob_t, params_np, z, seed=3, n_samples=n,
                        dropout_p=p)
    assert table.port_calls == 8 * n
    outs = []
    for k in range(n):
        monkeypatch.setattr(JS._NHWCOps, "dropout2d",
                            staticmethod(table.jax_dropout2d(table=k)))
        outs.append(JU.mc_predict(
            lambda prm, x, key: prob_j.net.apply(prm, x, key=key,
                                                 training=True, dropout_p=p),
            params_j, jnp.asarray(z), jax.random.PRNGKey(k), n_samples=1))
    outs = prob_j.transform(jnp.concatenate(outs))
    mean, ale, epi = JU.uncert_regression_gal(outs, 1)
    mean_c = jnp.clip(mean, 0, 1)
    for key, ref in (("mc_mean_recon", mean_c), ("mc_ale", ale),
                     ("mc_epi", epi)):
        np.testing.assert_allclose(
            got[key], np.asarray(ref)[0].transpose(2, 0, 1), rtol=1e-3,
            atol=2e-5, err_msg=key)
    assert got["mc_epi"].max() > 1e-4
    assert abs(got["mc_mean_psnr"] - float(jpsnr(prob_j.gt, mean_c))) < 2e-3


def test_sgld_mc_summary_has_no_epistemic_spread(small):
    prob = TP.build_problem("den", "sgld", 0, device="cpu")
    params = {k: v.numpy() for k, v in
              TT.init_params(prob, TT.Method("sgld"), 2).items()}
    z = (np.random.default_rng(3).uniform(size=(1, SIZE, SIZE, 16)) * 0.1
         ).astype(np.float32)
    got = TR.mc_summary(prob, params, z, seed=4, n_samples=5)
    assert got["mc_epi"].max() < 1e-10 and got["mc_ale"].max() > 0


# -- the runners ------------------------------------------------------------------

@pytest.fixture
def spied(small, monkeypatch):
    seen = {}
    fit, summary = TR.fit, TR.mc_summary

    def fit_spy(problem, method, **kw):
        seen.update(problem=problem, method=method,
                    res=fit(problem, method, **kw))
        return seen["res"]

    def summary_spy(*a, **kw):
        seen["summary_kw"] = kw
        return summary(*a, **kw)

    monkeypatch.setattr(TR, "fit", fit_spy)
    monkeypatch.setattr(TR, "mc_summary", summary_spy)
    return seen


@pytest.mark.parametrize("task", ["den", "ct"])
@pytest.mark.parametrize("name", ["dip", "mcd", "sgld"])
def test_runner_artifacts_against_jax(spied, tmp_path, task, name):
    runner = TR.ALL_RUNNERS[f"run_{task}_{name}"]
    psnr = runner(device="cpu", num_iter=2, lr=1e-3, dropout_p=0.2,
                  weight_decay=0.5, gamma=0.9, seed=3, show_every=2,
                  plot=False, save=True, save_path=str(tmp_path))
    (path,) = glob.glob(os.path.join(str(tmp_path), "*", "save.npz"))
    z = np.load(path, allow_pickle=True)
    prob, res = spied["problem"], spied["res"]
    assert psnr == res.final_psnr and np.isfinite(psnr)
    assert (prob.task, prob.method) == (task, name)
    # the JAX runner's key schema; dip takes no MC summary (runners.py:179)
    keys = set(JR._npz_payload(task, prob, res, name))
    assert set(z.files) == (keys if name == "dip" else keys | MC_KEYS)
    assert ("summary_kw" in spied) == (name != "dip")
    if name != "dip":
        assert spied["summary_kw"]["dropout_p"] == (0.2 if name == "mcd"
                                                    else None)
    method = spied["method"]
    ref = JR.method_for(task, name, dict(dropout_p=0.2, weight_decay=0.5,
                                         gamma=0.9))
    for f in ("name", "dropout_p", "weight_decay", "gamma"):
        assert getattr(method, f) == getattr(ref, f), f
    assert method.param_noise_sigma == ref.param_noise_sigma
    uncerts = z["uncerts"].item()[name]
    assert (np.abs(uncerts).max() == 0) == (name == "dip")
    for k in z.files:
        v = z[k].item() if z[k].dtype == object else z[k]
        for a in (v.values() if isinstance(v, dict) else [v]):
            assert np.isfinite(np.asarray(a, np.float64)).all(), k


def test_dip_run_plots_only_the_reconstruction(small, tmp_path):
    TR.run_den_dip(device="cpu", num_iter=2, lr=1e-3, seed=1, show_every=2,
                   plot=True, save=False, save_path=str(tmp_path))
    (out_dir,) = glob.glob(os.path.join(str(tmp_path), "*"))
    assert sorted(os.listdir(out_dir)) == [
        "input.png", "locals.txt", "loss_dip.png", "mse_gt.png",
        "mse_noisy.png", "out_avg.png", "psnrs.png", "ssims.png"]
