"""The port's runners, MC posterior summary and config loading
(mfvi_dip_mia_tpu_torch/tasks/runners.py, bayes/uncertainty.py,
utils/config.py) against the JAX package's: one seeded numpy stream feeds
the problem's noise and then the net input, the save.npz key schema, Gal's
decomposition on the same stacked outputs, and the configs read alike."""

import glob
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import mfvi_dip_mia_tpu.tasks.data as JD
import mfvi_dip_mia_tpu.tasks.problems as JP
import mfvi_dip_mia_tpu.tasks.runners as JR
import mfvi_dip_mia_tpu.utils.images as JI
from mfvi_dip_mia_tpu.bayes import uncertainty as JU
from mfvi_dip_mia_tpu.nn import build_skip_net as jbuild
from mfvi_dip_mia_tpu.utils import config as JC
import mfvi_dip_mia_tpu_torch.tasks.data as TD
import mfvi_dip_mia_tpu_torch.tasks.problems as TP
import mfvi_dip_mia_tpu_torch.tasks.runners as TR
from mfvi_dip_mia_tpu_torch.bayes import uncertainty as TU
from mfvi_dip_mia_tpu_torch.bayes import vi as tvi
from mfvi_dip_mia_tpu_torch.nn import build_skip_net as tbuild
from mfvi_dip_mia_tpu_torch.utils import config as TC
from mfvi_dip_mia_tpu_torch.utils.device import resolve_device

from torch_port_helpers import SMALL_NET, dropout_kwargs

torch.set_num_threads(1)

SIZE = 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MC_KEYS = {"mc_mean_recon", "mc_mean_psnr", "mc_mean_ssim", "mc_ale",
           "mc_epi"}


@pytest.fixture
def small(monkeypatch):
    for D in (JD, TD):
        monkeypatch.setattr(D, "get_image_denoising", lambda i, D=D: (
            D.synthetic_xray(i, SIZE), (SIZE, SIZE)))
        monkeypatch.setattr(D, "get_img_ct", lambda i, D=D: (
            D.synthetic_ct(i, SIZE), (SIZE, SIZE)))
    monkeypatch.setattr(JP, "_standard_net", lambda n, m, dp, input_depth=16:
                        jbuild(input_depth, n_channels=n, **SMALL_NET,
                               **dropout_kwargs(m, dp)))
    monkeypatch.setattr(TP, "_standard_net", lambda n, m, dp, input_depth=16:
                        tbuild(input_depth, n_channels=n, **SMALL_NET,
                               **dropout_kwargs(m, dp)))
    seen = {}
    fit = TR.fit

    def spy(problem, method, **kw):
        seen.update(problem=problem, method=method, kw=kw,
                    res=fit(problem, method, **kw))
        return seen["res"]

    monkeypatch.setattr(TR, "fit", spy)
    return seen


def _artifact(save_path):
    (path,) = glob.glob(os.path.join(save_path, "*", "save.npz"))
    return np.load(path, allow_pickle=True), os.path.dirname(path)


@pytest.mark.parametrize("task", ["den", "ct"])
def test_runner_artifacts_and_host_data_against_jax(small, tmp_path, task):
    runner = {"den": TR.run_den_mfvi, "ct": TR.run_ct_mfvi}[task]
    seed = 3
    psnr = runner(device="cpu", num_iter=2, lr=1e-3, temp=5.66e-7,
                  sigma=1.46e-5, seed=seed, show_every=2, plot=False,
                  save=True, save_path=str(tmp_path), weight_decay=0.5,
                  layout="auto", chunk_iters=2, extra_key=1)
    z, out_dir = _artifact(str(tmp_path))
    prob_t, res_t = small["problem"], small["res"]
    assert psnr == res_t.final_psnr and np.isfinite(psnr)
    assert small["method"].weight_decay == 0.0
    # the JAX runner's key schema, applied to the port's run
    assert set(z.files) == set(JR._npz_payload(task, prob_t, res_t,
                                               "mfvi")) | MC_KEYS
    for k in z.files:
        v = z[k].item() if z[k].dtype == object else z[k]
        for a in (v.values() if isinstance(v, dict) else [v]):
            assert np.isfinite(np.asarray(a, np.float64)).all(), k
    assert z["mc_mean_recon"].shape == z["mc_epi"].shape == (1, SIZE, SIZE)
    locals_txt = open(os.path.join(out_dir, "locals.txt")).read()
    assert "bayes = mfvi" in locals_txt and "extra_key = 1" in locals_txt
    # one numpy stream: the problem's noise, then the net input, as JAX's
    # run_task draws them
    rng = np.random.default_rng(seed)
    prob_j = JP.build_problem(task, "mfvi", 0, rng=rng)
    z_j = JI.get_noise(16, (SIZE, SIZE), rng=rng)
    np.testing.assert_array_equal(res_t.net_input, z_j)
    if task == "den":
        np.testing.assert_array_equal(z["img_gt"], prob_j.gt_np)
        np.testing.assert_array_equal(z["img_noisy"], prob_j.target_np)
    else:
        np.testing.assert_array_equal(z["img_gt"], prob_j.gt_np[None])
        np.testing.assert_allclose(z["img_radon"], prob_j.target_np[None],
                                   rtol=1e-4, atol=1e-4)


def test_den_run_with_plots(small, tmp_path):
    TR.run_den_mfvi(device="cpu", num_iter=2, lr=1e-3, seed=1, show_every=2,
                    plot=True, save=False, save_path=str(tmp_path))
    (out_dir,) = glob.glob(os.path.join(str(tmp_path), "*"))
    assert sorted(os.listdir(out_dir)) == [
        "input.png", "locals.txt", "loss_mfvi.png", "mse_gt.png",
        "mse_noisy.png", "out_ale.png", "out_avg.png", "out_var.png",
        "psnrs.png", "ssims.png"]
    assert "mfvi PSNR_max:" in open(os.path.join(out_dir, "locals.txt")).read()


def test_unported_runners_raise(tmp_path):
    """All 16 runners are ported; each still refuses early_stop (ROADMAP
    Queue 1 item 6) before it writes anything."""
    assert len(TR.ALL_RUNNERS) == 16
    assert set(TR.ALL_RUNNERS) == set(JR.ALL_RUNNERS)
    for name, runner in TR.ALL_RUNNERS.items():
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            runner(device="cpu", early_stop={"patience": 5},
                   save_path=str(tmp_path))
    assert os.listdir(tmp_path) == []


def test_method_for_matches_jax():
    for task, name in (("den", "mfvi"), ("ct", "mcd"), ("den", "mcd")):
        kw = dict(temp=2e-6, weight_decay=0.1, dropout_p=0.2)
        m_t, m_j = TR.method_for(task, name, kw), JR.method_for(task, name, kw)
        for f in ("name", "temp", "sigma", "dropout_p", "weight_decay",
                  "gamma"):
            assert getattr(m_t, f) == getattr(m_j, f), (task, name, f)


def test_device_spellings_of_the_reference():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for dev in (None, 0, 3, "cuda", "cuda:1", "tpu:3"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device(dev)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TR.run_den_mfvi(plot=False, save=False)


def test_uncert_regression_gal_against_jax():
    rng = np.random.default_rng(8)
    outs = rng.standard_normal((25, 1, 2, 16, 24)).astype(np.float32)
    got = TU.uncert_regression_gal(torch.from_numpy(outs), 1)
    ref = JU.uncert_regression_gal(jnp.asarray(outs.transpose(0, 1, 3, 4, 2)),
                                   1)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(),
                                   np.asarray(r).transpose(0, 3, 1, 2),
                                   rtol=1e-5, atol=1e-6)
    mean, ale, epi = TU.uncert_regression_gal(torch.from_numpy(outs[:, :, :1]))
    assert torch.equal(ale, torch.zeros_like(epi))


def test_mc_predict_draws_one_tree_per_sample():
    params = tvi.flatten({"a.w_mu": torch.zeros(3), "a.w_rho": torch.zeros(3),
                          "bn.scale": torch.ones(2)})
    seen = []

    def apply_fn(leaves, x, generator):
        seen.append(torch.is_grad_enabled())
        return (leaves["a.w"].sum() + x)[None, None]

    outs = TU.mc_predict(apply_fn, params, torch.zeros(1, 1),
                         torch.Generator().manual_seed(0), 5)
    assert outs.shape == (5, 1, 1, 1, 1) and seen == [False] * 5
    assert len(set(outs.reshape(-1).tolist())) == 5
    again = TU.mc_predict(apply_fn, params, torch.zeros(1, 1),
                          torch.Generator().manual_seed(0), 5)
    assert torch.equal(outs, again)


def test_configs_load_as_in_jax(tmp_path):
    paths = sorted(glob.glob(os.path.join(REPO, "configs", "*.json")))
    assert len(paths) >= 30
    for p in paths:
        c_t, c_j = TC.load_config(p), JC.load_config(p)
        assert c_t.run_params == c_j.run_params
        assert {k: (v.logbounds, v.candidates)
                for k, v in c_t.bo_params.items()} == {
            k: (v.logbounds, v.candidates) for k, v in c_j.bo_params.items()}
    vals = dict(task="den", lr=1e-3, device=None, shape=(1, 2))
    TC.dump_locals(str(tmp_path / "t.txt"), vals)
    JC.dump_locals(str(tmp_path / "j.txt"), vals)
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
