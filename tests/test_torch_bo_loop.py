"""The port's BO sweep (mfvi_dip_mia_tpu_torch/bo/loop.py, parallel/fanout.py,
cli.py, eval_cli.py) against the JAX package's, with a mock (analytic)
objective and, for the slice as a whole, one round of real CPU fits; and
mc_predict on the CPU, which the card replays as a CUDA graph.

Tolerances: with equal observations the two loops fit GPs that agree to
~1e-13 and refine candidates from the same starts, so round 0's next
candidates agree to 1e-6 in normalized coordinates; later rounds fit on
observations that already differ in their last bits, held to 1e-4. The
fig_data arrays are held to 1e-6 relative (their largest entry)."""

import glob
import json
import os
import sys
import warnings

import numpy as np
import pytest
import torch

import mfvi_dip_mia_tpu.bo.loop as JL
import mfvi_dip_mia_tpu.cli as jcli
import mfvi_dip_mia_tpu.eval_cli as jeval
import mfvi_dip_mia_tpu.tasks.data as JD
from mfvi_dip_mia_tpu.bo import acquisition as jacq
from mfvi_dip_mia_tpu.bo import gp as jgp
import mfvi_dip_mia_tpu_torch.bo.loop as TL
import mfvi_dip_mia_tpu_torch.cli as tcli
import mfvi_dip_mia_tpu_torch.eval_cli as teval
import mfvi_dip_mia_tpu_torch.tasks.data as TD
import mfvi_dip_mia_tpu_torch.tasks.problems as TP
from mfvi_dip_mia_tpu_torch.bayes import uncertainty as TU
from mfvi_dip_mia_tpu_torch.bayes import vi as tvi
from mfvi_dip_mia_tpu_torch.bo.normalize import normalize_X
from mfvi_dip_mia_tpu_torch.nn import build_skip_net as tbuild
from mfvi_dip_mia_tpu_torch.parallel import fanout as TF
from mfvi_dip_mia_tpu_torch.tasks.trainer import Method, init_params

from torch_port_helpers import SMALL_NET, dropout_kwargs

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BO_PARAMS = {
    "temp": {"logbounds": [-10.0, 0.0], "candidates": [1e-2, 1e-8]},
    "sigma": {"logbounds": [-10.0, 0.0], "candidates": [1e-2, 1e-8]},
}
FIG_KEYS = {"XX_lr", "XX_wd", "pred", "observed_X", "observed_Y",
            "expected_improvement", "confidence", "acq", "candidates"}
ROUND0_ATOL = 1e-6
LATER_ATOL = 1e-4


def analytic_psnr(cand):
    """Peak 30 at temp=1e-5, sigma=1e-4 in log space (test_bo_loop.py's)."""
    lt, ls = np.log10(cand[0]), np.log10(cand[1])
    return 30.0 - 0.5 * ((lt + 5.0) ** 2 + (ls + 4.0) ** 2)


def mock_runner(idx, dev, cand):
    return analytic_psnr(cand)


def _rp(path, **kw):
    return dict({"bo_results_path": str(path), "devices": ["cpu"]}, **kw)


def _norm(c):
    b = [v["logbounds"] for v in BO_PARAMS.values()]
    return normalize_X(np.asarray(c, np.float64), *b)


def _figs(path):
    return sorted(glob.glob(os.path.join(str(path), "*_fig_data.npz")))


def test_bo_converges_on_analytic_objective(tmp_path):
    X, Y = TL.bo("denoising", "mfvi", BO_PARAMS, _rp(tmp_path), n_rounds=4,
                 plot=False, runner=mock_runner, gp_iters=300)
    assert max(Y) > 29.0  # near the optimum (true max 30)
    best = X[int(np.argmax(Y))]
    assert abs(np.log10(best[0]) + 5) < 1.5
    assert abs(np.log10(best[1]) + 4) < 1.5
    files = _figs(tmp_path)
    assert len(files) == 4
    z = np.load(files[-1])
    assert set(z.files) == FIG_KEYS and z["pred"].shape == (100, 100)


def test_bo_against_jax(tmp_path):
    """The same mock runner through both loops, round by round: each
    round's fig_data.npz and next candidates."""
    n_rounds = 3
    for loop, sub in ((TL, "t"), (JL, "j")):
        loop.bo("denoising", "mfvi", BO_PARAMS,
                _rp(tmp_path / sub, devices=None if sub == "j" else ["cpu"]),
                n_rounds=n_rounds, plot=False, runner=mock_runner,
                gp_iters=300)
    ft, fj = _figs(tmp_path / "t"), _figs(tmp_path / "j")
    assert len(ft) == len(fj) == n_rounds
    for k, (a, b) in enumerate(zip(ft, fj)):
        zt, zj = np.load(a), np.load(b)
        assert set(zt.files) == set(zj.files) == FIG_KEYS
        atol = ROUND0_ATOL if k == 0 else LATER_ATOL
        assert zt["candidates"].shape == zj["candidates"].shape, k
        np.testing.assert_allclose(_norm(zt["candidates"]),
                                   _norm(zj["candidates"]), rtol=0,
                                   atol=atol)
        for key in sorted(FIG_KEYS - {"candidates"}):
            assert zt[key].shape == zj[key].shape, (k, key)
            scale = max(np.abs(zj[key]).max(), 1e-12)
            tol = 1e-6 if k == 0 or key in ("XX_lr", "XX_wd") else atol
            assert np.abs(zt[key] - zj[key]).max() <= tol * scale, (k, key)


def test_bo_resume_equals_uninterrupted(tmp_path):
    kw = dict(plot=False, runner=mock_runner, gp_iters=150)
    X, Y = TL.bo("den", "mfvi", BO_PARAMS, _rp(tmp_path / "a"), n_rounds=3,
                 **kw)
    TL.bo("den", "mfvi", BO_PARAMS, _rp(tmp_path / "b"), n_rounds=2, **kw)
    Xr, Yr = TL.bo("den", "mfvi", BO_PARAMS, _rp(tmp_path / "b"),
                   n_rounds=3, resume=True, **kw)
    assert Xr == X and Yr == Y
    for a, b in zip(_figs(tmp_path / "a"), _figs(tmp_path / "b")):
        za, zb = np.load(a), np.load(b)
        for key in FIG_KEYS:
            np.testing.assert_array_equal(za[key], zb[key])
    # resuming a finished sweep runs nothing
    calls = []
    TL.bo("den", "mfvi", BO_PARAMS, _rp(tmp_path / "b"), n_rounds=3,
          resume=True, plot=False, gp_iters=150,
          runner=lambda i, d, c: calls.append(c) or 0.0)
    assert calls == []


def _screened(loop, path, runner, **kw):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        X, Y = loop.bo("denoising", "mfvi", BO_PARAMS,
                       _rp(path, num_iter=1000,
                           devices=None if loop is JL else ["cpu"]),
                       n_rounds=3, plot=False, runner=runner, gp_iters=200,
                       screen_iters=300, **kw)
    return X, Y, w


def test_bo_screen_confirm(tmp_path):
    """Rounds at the screened budget, then ONE confirming fit of the
    winner, recorded in screen_confirm.json and kept out of (X, Y); a
    resume of the finished sweep does not confirm again."""
    calls = []

    def recording_runner(idx, dev, cand):
        calls.append(tuple(cand))
        return analytic_psnr(cand) - 0.25

    X, Y, w = _screened(TL, tmp_path, recording_runner)
    assert any("ranking-stability floor" in str(x.message) for x in w)
    with open(tmp_path / "screen_confirm.json") as f:
        rec = json.load(f)
    assert rec["screen_iters"] == 300 and rec["full_iters"] == 1000
    assert tuple(rec["best_candidate"]) == calls[-1]
    assert len(X) == len(Y) == len(calls) - 1
    assert rec["screened_psnr"] == pytest.approx(max(Y))
    assert rec["confirmed_psnr"] == pytest.approx(
        analytic_psnr(rec["best_candidate"]) - 0.25)

    n_calls = len(calls)
    _screened(TL, tmp_path, recording_runner, resume=True)
    assert len(calls) == n_calls

    with pytest.raises(ValueError):
        TL.bo("denoising", "mfvi", BO_PARAMS, _rp(tmp_path, num_iter=100),
              n_rounds=1, plot=False, runner=recording_runner,
              screen_iters=100)


def test_screen_confirm_recorded_for_another_candidate(tmp_path):
    """A screen_confirm.json left for another candidate: the port confirms
    its own winner anew; the JAX loop skips on the file alone
    (bo/loop.py:224-230, held knowingly)."""
    stale = {"screen_iters": 300, "full_iters": 1000,
             "best_candidate": [0.5, 0.5], "screened_psnr": 0.0,
             "confirmed_psnr": 0.0}
    for loop, sub in ((TL, "t"), (JL, "j")):
        (tmp_path / sub).mkdir()
        with open(tmp_path / sub / "screen_confirm.json", "w") as f:
            json.dump(stale, f)
        calls = []

        def runner(idx, dev, cand):
            calls.append(tuple(cand))
            return analytic_psnr(cand)

        X, Y, _ = _screened(loop, tmp_path / sub, runner)
        with open(tmp_path / sub / "screen_confirm.json") as f:
            rec = json.load(f)
        if loop is TL:
            assert len(calls) == len(X) + 1
            assert rec["best_candidate"] == [float(v) for v in
                                             X[int(np.argmax(Y))]]
            assert rec["confirmed_psnr"] == pytest.approx(max(Y))
        else:
            assert len(calls) == len(X) and rec == stale


def test_evaluate_candidates_table(capsys):
    kept_c, kept_y = TL.evaluate_candidates(
        "denoising", "mfvi", BO_PARAMS, _rp("x"), runner=mock_runner)
    assert len(kept_c) == 4  # 2x2 product
    out = capsys.readouterr().out
    assert "temp      sigma       psnr" in out
    for c, y in zip(kept_c, kept_y):
        assert y == pytest.approx(analytic_psnr(c), abs=1e-6)
        assert "  ".join(f"{v:.6f}" for v in c) + f"  {y:.6f}" in out
    jc, jy = JL.evaluate_candidates("denoising", "mfvi", BO_PARAMS,
                                    {"bo_results_path": "x",
                                     "devices": None}, runner=mock_runner)
    assert kept_c == jc and kept_y == jy


def test_fanout_filters_failures_pairwise_in_candidate_order():
    seen = []

    def flaky(idx, dev, cand):
        seen.append((idx, str(dev)))
        if idx == 0:
            raise RuntimeError("boom")
        if idx in (1, 3):
            return float("nan")
        return 1.0 * idx

    cands = [(10.0 ** -k, 10.0 ** -k) for k in range(1, 6)]
    failures = []
    kept_c, kept_y = TF.run_candidates("denoising", "mfvi", cands, {},
                                       devices=["cpu:0", "cpu:1"],
                                       runner=flaky, failures=failures)
    assert kept_y == [2.0, 4.0] and kept_c == [cands[2], cands[4]]
    assert seen == [(0, "cpu:0"), (1, "cpu:1"), (2, "cpu:0"), (3, "cpu:1"),
                    (4, "cpu:0")]
    assert [(f["index"], f["crashed"]) for f in failures] == [
        (0, True), (1, False), (3, False)]
    assert "boom" in failures[0]["error"] and failures[1]["error"] is None
    c_all, y_all = TF.run_candidates("den", "mfvi", cands, {},
                                     devices=["cpu"], runner=flaky,
                                     keep_nan=True)
    assert len(c_all) == 5 and np.isnan(y_all[:2]).all()
    assert TF.candidate_kwargs("mfvi", (1e-5, 1e-3)) == {
        "temp": 1e-5, "sigma": 1e-3}
    assert TF.candidate_kwargs("dip", ()) == {}


@pytest.mark.parametrize("mode", [dict(use_spmd=True), dict(sp_split=2),
                                  dict(sp_split=True),
                                  dict(interleave=True)])
def test_fanout_modes_not_ported_raise(mode):
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        TF.run_candidates("ct", "mfvi", [(1e-3, 1e-3)], {}, devices=["cpu"],
                          runner=mock_runner, **mode)


def test_plots_without_matplotlib_fail_before_a_fit(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    calls = []

    def runner(idx, dev, cand):
        calls.append(cand)
        return 1.0

    with pytest.raises(RuntimeError, match="matplotlib"):
        TL.bo("ct", "mfvi", BO_PARAMS, _rp(tmp_path), n_rounds=1, plot=True,
              runner=runner)
    for rp in (_rp(tmp_path), _rp(tmp_path, plot=True)):   # run_task plots
        with pytest.raises(RuntimeError, match="matplotlib"):
            TL.bo("ct", "mfvi", BO_PARAMS, rp, n_rounds=1, plot=False)
        with pytest.raises(RuntimeError, match="matplotlib"):
            TL.evaluate_candidates("ct", "mfvi", BO_PARAMS, rp)
    assert calls == [] and _figs(tmp_path) == []
    TL.bo("ct", "mfvi", BO_PARAMS, _rp(tmp_path, plot=True), n_rounds=1,
          plot=False, runner=runner, gp_iters=20)
    assert len(calls) == 4


def _configs(prefix):
    """Every configs/{prefix}_{method}[_{task}].json of the four methods."""
    return sorted(p for m in ("dip", "mfvi", "mcd", "sgld")
                  for p in glob.glob(os.path.join(REPO, "configs",
                                                  f"{prefix}_{m}*.json")))


def _task_of(path):
    stem = os.path.splitext(os.path.basename(path))[0].split("_")
    return {"den": "denoising", "ct": "ct", "sr": "super-resolution",
            "inp": "inpainting"}[stem[2]] if len(stem) > 2 else "denoising"


def _bayes_of(path):
    return os.path.splitext(os.path.basename(path))[0].split("_")[1]


@pytest.mark.parametrize("path", _configs("bo"), ids=os.path.basename)
def test_cli_config_gives_jax_bo_arguments(path, monkeypatch):
    got = {}
    for mod, key in ((tcli, "t"), (jcli, "j")):
        monkeypatch.setattr(mod, "bo", lambda key=key, **kw:
                            got.__setitem__(key, kw))
        mod.main(["--task", _task_of(path), "--bayes", _bayes_of(path),
                  "--config", path, "--num-iter", "200", "--rounds", "2",
                  "--no-plot", "--metrics-every", "10", "--screen-iters",
                  "100"])
    assert got["t"] == got["j"]
    assert got["t"]["run_params"]["num_iter"] == 200
    assert got["t"]["n_rounds"] == 2 and got["t"]["plot"] is False


@pytest.mark.parametrize("path", _configs("test"), ids=os.path.basename)
def test_eval_cli_config_gives_jax_arguments(path, monkeypatch):
    got = {}
    for mod, key in ((teval, "t"), (jeval, "j")):
        monkeypatch.setattr(mod, "evaluate_candidates",
                            lambda *a, key=key: got.__setitem__(key, a))
        mod.main(["--task", _task_of(path), "--bayes", _bayes_of(path),
                  "--config", path, "--num-iter", "200", "--no-save"])
    assert got["t"] == got["j"]
    assert got["t"][3]["num_iter"] == 200
    assert got["t"][3]["save"] is False and got["t"][3]["plot"] is False


SIZE = 64


@pytest.fixture
def small(monkeypatch):
    for D in (JD, TD):
        monkeypatch.setattr(D, "get_image_denoising", lambda i, D=D: (
            D.synthetic_xray(i, SIZE), (SIZE, SIZE)))
        monkeypatch.setattr(D, "get_img_ct", lambda i, D=D: (
            D.synthetic_ct(i, SIZE), (SIZE, SIZE)))
    monkeypatch.setattr(TP, "_standard_net", lambda n, m, dp, input_depth=16:
                        tbuild(input_depth, n_channels=n, **SMALL_NET,
                               **dropout_kwargs(m, dp)))


def test_one_bo_round_of_real_fits_on_cpu(small, tmp_path, capsys):
    """The slice as a whole: one round of the port's bo() through the real
    run_task (fit + the 25-sample MC summary) on the CPU, 2 x 2 candidates;
    then JAX's train_gp + find_candidates on the port's observations give
    the port's next candidates."""
    params = {k: dict(v) for k, v in BO_PARAMS.items()}
    params["temp"]["candidates"] = [1e-4, 1e-7]
    params["sigma"]["candidates"] = [0.1, 1e-6]
    rp = _rp(tmp_path / "bo", img=0, num_iter=2, lr=1e-3, seed=1,
             show_every=2, plot=False, save=False,
             save_path=str(tmp_path / "logs"))
    X, Y = TL.bo("ct", "mfvi", params, rp, n_rounds=1, plot=False)
    assert len(X) == len(Y) == 4 and np.isfinite(Y).all()
    assert "failed" not in capsys.readouterr().out
    (path,) = _figs(tmp_path / "bo")
    z = np.load(path)
    assert set(z.files) == FIG_KEYS
    np.testing.assert_array_equal(z["observed_Y"], Y)

    x_train = normalize_X(np.asarray(X), [-10.0, 0.0], [-10.0, 0.0])
    gp_j = jgp.train_gp(x_train, np.asarray(Y), iter_max=2000)
    g = normalize_X(TL._grid([-10.0, 0.0], [-10.0, 0.0])[2], [-10.0, 0.0],
                    [-10.0, 0.0])
    c_j, _, _ = jacq.find_candidates(gp_j, g, x_train)
    assert _norm(z["candidates"]).shape == c_j.shape
    np.testing.assert_allclose(_norm(z["candidates"]), c_j, rtol=0,
                               atol=ROUND0_ATOL)


@pytest.mark.parametrize("reparam", ["rt", "lrt"])
def test_mc_predict_on_the_cpu_runs_eagerly(reparam):
    """On the CPU mc_predict is the eager loop whatever ``eager`` says: the
    same draws as one forward per sample from the same generator."""
    net = tbuild(4, n_channels=2, **SMALL_NET)
    params = tvi.flatten(init_params(
        type("P", (), {"net": net, "init_normal_std": None})(),
        Method("mfvi"), 0))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 4, 16, 16)).astype(np.float32))
    outs = [TU.mc_predict(net, params, x, torch.Generator().manual_seed(7),
                          3, reparam=reparam, eager=eager)
            for eager in (False, True)]
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        ref = torch.stack([
            net(params.leaves(), x, gen, reparam="lrt") if reparam == "lrt"
            else net(tvi.sample_mfvi_tree(params, gen), x)
            for _ in range(3)])
    assert outs[0].shape == (3, 1, 2, 16, 16)
    assert torch.equal(outs[0], ref) and torch.equal(outs[1], ref)
    assert not torch.equal(outs[0][0], outs[0][1])
