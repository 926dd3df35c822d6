"""The 8 sr and inp runners of the port (mfvi_dip_mia_tpu_torch/tasks/
runners.py) on the CPU at 64^2 on the small nets of
test_torch_sr_inp_parts.py: each writes save.npz with the JAX runner's key
schema (runners.py::_npz_payload, plus the MC summary's keys for every
method but dip) and the JAX problem's images; the MC summary keeps inp's 3
mean channels; a plotted run writes the JAX runner's files; and
``eval_cli`` runs configs/test_*_{sr,inp}.json's candidates through the
port."""

import glob
import json
import os

import numpy as np
import pytest
import torch

import mfvi_dip_mia_tpu.tasks.problems as JP
import mfvi_dip_mia_tpu.tasks.runners as JR
from mfvi_dip_mia_tpu_torch import eval_cli
import mfvi_dip_mia_tpu_torch.tasks.runners as TR

from test_torch_sr_inp_parts import PAIRS, SIZE, patch_small

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MC_KEYS = {"mc_mean_recon", "mc_mean_psnr", "mc_mean_ssim", "mc_ale",
           "mc_epi"}
# the images both problems hold: the inp ones equal, the sr low-resolution
# image one interpolation rounding apart (test_torch_sr_inp_parts.py)
IMAGE_KEYS = {"sr": ("img_hr", "img_lr"), "inp": ("img_inpainting",
                                                  "img_mask")}


@pytest.fixture
def small(monkeypatch):
    patch_small(monkeypatch)
    seen = {}
    fit = TR.fit

    def spy(problem, method, **kw):
        seen.update(problem=problem, method=method,
                    res=fit(problem, method, **kw))
        return seen["res"]

    monkeypatch.setattr(TR, "fit", spy)
    return seen


def _artifact(save_path):
    (path,) = glob.glob(os.path.join(save_path, "*", "save.npz"))
    return np.load(path, allow_pickle=True), os.path.dirname(path)


@pytest.mark.parametrize("task,name", PAIRS)
def test_runner_save_npz_against_jax(small, tmp_path, task, name):
    psnr = TR.ALL_RUNNERS[f"run_{task}_{name}"](
        device="cpu", num_iter=2, lr=1e-3, seed=3, show_every=2, plot=False,
        save=True, save_path=str(tmp_path), weight_decay=0.5)
    z, _ = _artifact(str(tmp_path))
    prob_t, res_t = small["problem"], small["res"]
    assert psnr == res_t.final_psnr and np.isfinite(psnr)
    # the runners' weight-decay quirk: dip and mfvi zero it
    assert small["method"].weight_decay == (
        0.0 if name in ("dip", "mfvi") else 0.5)
    want = set(JR._npz_payload(task, prob_t, res_t, name))
    assert set(z.files) == (want if name == "dip" else want | MC_KEYS)
    for k in z.files:
        v = z[k].item() if z[k].dtype == object else z[k]
        for a in (v.values() if isinstance(v, dict) else [v]):
            assert np.isfinite(np.asarray(a, np.float64)).all(), k
    prob_j = JP.build_problem(task, name, 0)
    ref = JR._npz_payload(task, prob_j, res_t, name)
    for k in IMAGE_KEYS[task]:
        assert z[k].shape == ref[k].shape, k
        np.testing.assert_allclose(z[k], ref[k], rtol=0, atol=1e-6)
    mc = {"sr": 1, "inp": 3}[task]
    assert z["recons"].item()[name].shape == (2, mc, SIZE, SIZE)
    if name != "dip":
        # the MC summary: inp's 3 mean channels and its one neg-logvar
        assert z["mc_mean_recon"].shape == z["mc_epi"].shape == (
            mc, SIZE, SIZE)
        assert z["mc_ale"].shape == (1, SIZE, SIZE)


def test_inp_run_with_plots(small, tmp_path):
    TR.run_inp_sgld(device="cpu", num_iter=2, lr=1e-3, seed=1, show_every=2,
                    plot=True, save=False, save_path=str(tmp_path))
    (out_dir,) = glob.glob(os.path.join(str(tmp_path), "*"))
    assert sorted(os.listdir(out_dir)) == [
        "input.png", "locals.txt", "loss_sgld.png", "mse_gt.png",
        "mse_noisy.png", "out_ale.png", "out_avg.png", "out_var.png",
        "psnrs.png", "ssims.png"]


@pytest.mark.parametrize("config,task", [
    ("test_mfvi_sr.json", "super-resolution"),
    ("test_mcd_inp.json", "inpainting")])
def test_eval_cli_runs_the_config_on_the_cpu(small, tmp_path, config, task):
    """The config's candidate, lr, seed, img and input depth through
    eval_cli.main, 2 iterations, on the CPU: one finite score and a
    save.npz with the task's keys."""
    with open(os.path.join(REPO, "configs", config)) as f:
        raw = json.load(f)
    raw["run_params"].update(devices=["cpu"], plot=False,
                             save_path=str(tmp_path / "logs"))
    path = tmp_path / config
    path.write_text(json.dumps(raw))
    name = config.split("_")[1]
    kept_c, kept_y = eval_cli.main(["--task", task, "--bayes", name,
                                    "--num-iter", "2", "--config", str(path)])
    assert len(kept_y) == 1 and np.isfinite(kept_y[0])
    assert small["problem"].input_depth == raw["run_params"]["input_depth"]
    z, _ = _artifact(str(tmp_path / "logs"))
    assert set(IMAGE_KEYS[small["problem"].task]) <= set(z.files)
    assert MC_KEYS <= set(z.files)
