"""Interleaved candidate groups in the port: ``fit_interleaved``
(mfvi_dip_mia_tpu_torch/tasks/trainer.py), ``run_group_interleaved``
(tasks/runners.py) and the fanout's ``interleave`` routing
(parallel/fanout.py).

Each interleaved fit must give the bits of its own sequential port ``fit``
at the same seed (the CPU runs the step eagerly, the very step the card
captures). Against the JAX package's ``fit_interleaved`` the fits run in
lockstep as tests/test_torch_trainer.py's MFVI locksteps do (the same
parameters, jitter off, one fixed eps table on both sides), at the
per-iteration gate of 2e-3*(1+i) dB. Nets: the 2-scale SMALL_NET at 32^2
(64^2 for the lockstep)."""

import os

import numpy as np
import pytest
import torch

import mfvi_dip_mia_tpu.tasks.trainer as JT
import mfvi_dip_mia_tpu_torch.tasks.problems as TP
import mfvi_dip_mia_tpu_torch.tasks.runners as TR
import mfvi_dip_mia_tpu_torch.tasks.trainer as TT
from mfvi_dip_mia_tpu_torch.parallel import fanout as TF

from test_torch_trainer import PRIORS, _lockstep, _patch_problems, _psnr_tol

torch.set_num_threads(1)

SIZE = 32
LR = 1e-2
# the first improves steadily at this lr; the KL of the other two holds
# their smoothed PSNR flat, so the early stop ends them first
CANDS = [(1e-6, 1e-2), (1e-1, 1e-4), (1e3, 1e-6)]
EARLY_STOP = {"patience": 20, "min_delta": 0.05}


def _assert_same_fit(got, ref):
    for f in ("mse_corrupted", "mse_gt", "psnrs", "ssims"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    assert got.params.keys() == ref.params.keys()
    for k, v in ref.params.items():
        np.testing.assert_array_equal(got.params[k], v)
    np.testing.assert_array_equal(got.net_input, ref.net_input)
    assert got.executed == ref.executed
    assert got.final_psnr == ref.final_psnr


@pytest.mark.parametrize("task,num_iter", [("den", 59), ("ct", 19)])
def test_fit_interleaved_equals_sequential_fits(monkeypatch, task, num_iter):
    _patch_problems(monkeypatch, SIZE)
    problem = TP.build_problem(task, "mfvi", 0, device="cpu",
                               rng=np.random.default_rng(1))
    methods = [TT.Method("mfvi", temp=t, sigma=s) for t, s in CANDS]
    kw = dict(num_iter=num_iter, lr=LR, seed=1, show_every=10, metrics_every=2,
              device="cpu", early_stop=EARLY_STOP)
    results = TT.fit_interleaved(problem, methods, **kw)
    assert len(results) == len(methods)
    for method, res in zip(methods, results):
        ref = TT.fit(problem, method, collect_snapshots=False, **kw)
        _assert_same_fit(res, ref)
        assert res.recons.shape == (0, 1, SIZE, SIZE)
        assert res.replays == 0 and res.warmup_steps == 0
    if task == "den":
        executed = [r.executed for r in results]
        assert executed[0] == 60 and max(executed[1:]) < 60, executed
        assert np.isnan(results[1].psnrs[-1]).all()


def test_fit_interleaved_rngs_and_method_check(monkeypatch):
    _patch_problems(monkeypatch, SIZE)
    problem = TP.build_problem("den", "mfvi", 0, device="cpu")
    methods = [TT.Method("mfvi", temp=t, sigma=s) for t, s in CANDS[:2]]
    kw = dict(num_iter=9, lr=LR, seed=3, show_every=5, device="cpu")
    rngs = [np.random.default_rng(7), np.random.default_rng(8)]
    results = TT.fit_interleaved(problem, methods, rngs=rngs, **kw)
    for j, (method, res) in enumerate(zip(methods, results)):
        ref = TT.fit(problem, method, collect_snapshots=False,
                     rng=np.random.default_rng(7 + j), **kw)
        _assert_same_fit(res, ref)
    with pytest.raises(ValueError, match="share a method"):
        TT.fit_interleaved(problem, [methods[0], TT.Method("dip")], **kw)


def test_fit_interleaved_lockstep_against_jax(monkeypatch):
    prob_j, prob_t = _lockstep(monkeypatch, 64, jax_fused=False)("den")
    temp, sigma = PRIORS["den"]
    pairs = [(temp, sigma), (100 * temp, 10 * sigma)]
    n_steps = 4
    kw = dict(num_iter=n_steps - 1, lr=1e-3, seed=1, show_every=2,
              metrics_every=1)
    res_t = TT.fit_interleaved(
        prob_t, [TT.Method("mfvi", temp=t, sigma=s) for t, s in pairs],
        device="cpu", **kw)
    res_j = JT.fit_interleaved(
        prob_j, [JT.Method("mfvi", temp=t, sigma=s) for t, s in pairs],
        layout="auto", **kw)
    for rt, rj in zip(res_t, res_j):
        assert rt.psnrs.shape == rj.psnrs.shape == (n_steps, 3)
        np.testing.assert_array_equal(rt.net_input, rj.net_input)
        for i in range(n_steps):
            assert np.all(np.abs(rt.psnrs[i] - rj.psnrs[i]) < _psnr_tol(i)), (
                i, rt.psnrs[i], rj.psnrs[i])
        assert abs(rt.final_psnr - rj.final_psnr) < _psnr_tol(n_steps)
        np.testing.assert_allclose(rt.ssims, rj.ssims, atol=1e-4)


@pytest.mark.parametrize("task", ["den", "ct"])
def test_run_group_interleaved_equals_run_task(monkeypatch, tmp_path, task):
    _patch_problems(monkeypatch, SIZE)
    rp = dict(img=0, num_iter=9, lr=LR, seed=1, show_every=5)
    cands = CANDS[:2]
    scores = TR.run_group_interleaved(task, "mfvi", cands, device="cpu",
                                      save=True, save_path=str(tmp_path),
                                      **rp)
    for cand, y in zip(cands, scores):
        ref = TR.run_task(task, "mfvi", device="cpu", plot=False, save=False,
                          **TF.candidate_kwargs("mfvi", cand), **rp)
        assert y == ref
    dirs = sorted(os.listdir(tmp_path))
    assert [d.rsplit("_", 1)[1] for d in dirs] == ["0", "1"]
    for d, cand in zip(dirs, cands):
        with open(tmp_path / d / "locals.txt") as f:
            lines = f.read().splitlines()
        assert "interleaved = True" in lines
        assert f"temp = {cand[0]}" in lines
        z = np.load(tmp_path / d / "save.npz", allow_pickle=True)
        assert "mc_mean_psnr" not in z.files and "psnrs" in z.files


def test_run_candidates_auto_equals_per_candidate(monkeypatch):
    _patch_problems(monkeypatch, SIZE)
    groups = []
    group = TR.run_group_interleaved

    def spy(task, bayes, cands, device=None, **kw):
        groups.append(len(cands))
        return group(task, bayes, cands, device=device, **kw)

    monkeypatch.setattr(TR, "run_group_interleaved", spy)
    rp = dict(img=0, num_iter=9, lr=LR, seed=1, show_every=5, plot=False,
              save=False)
    auto = TF.run_candidates("den", "mfvi", CANDS, rp, devices=["cpu"])
    assert groups == [3]
    plain = TF.run_candidates("den", "mfvi", CANDS, rp, devices=["cpu"],
                              interleave=False)
    assert groups == [3] and auto == plain


def test_interleave_routing(monkeypatch):
    """Groups by i % n over the devices; True forces grouping, False
    forbids it; dip is never grouped; a failed group gives NaN and a
    ``failures`` entry for each of its candidates."""
    calls = []

    def group(task, bayes, cands, device=None, **kw):
        calls.append(("group", [c[0] for c in cands], str(device)))
        if 2.0 in [c[0] for c in cands]:
            raise RuntimeError("group boom")
        return [10.0 * c[0] for c in cands]

    def task_run(task, bayes, index=0, device=None, **kw):
        calls.append(("task", index, str(device)))
        return float(index)

    monkeypatch.setattr(TR, "run_group_interleaved", group)
    monkeypatch.setattr(TR, "run_task", task_run)
    cands = [(float(i), 1.0) for i in range(5)]
    failures = []
    kept_c, kept_y = TF.run_candidates("den", "mfvi", cands, {},
                                       devices=["cpu", "cpu:0"],
                                       failures=failures)
    # the groups run on threads of their own, in no set order
    assert sorted(calls) == [("group", [0.0, 2.0, 4.0], "cpu"),
                             ("group", [1.0, 3.0], "cpu:0")]
    assert kept_y == [10.0, 30.0] and kept_c == [cands[1], cands[3]]
    assert [(f["index"], f["crashed"]) for f in failures] == [
        (0, True), (2, True), (4, True)]
    assert "group boom" in failures[0]["error"]

    calls.clear()
    TF.run_candidates("den", "mfvi", cands[1:2], {}, devices=["cpu"],
                      interleave=True)
    assert calls == [("group", [1.0], "cpu")]
    for kw in (dict(interleave=False), dict()):
        calls.clear()
        TF.run_candidates("den", "mfvi" if kw else "dip", cands[:3], {},
                          devices=["cpu"], **kw)
        assert [c[0] for c in calls] == ["task"] * 3
    calls.clear()
    TF.run_candidates("den", "dip", cands[:3], {}, devices=["cpu"],
                      interleave=True)
    assert [c[0] for c in calls] == ["task"] * 3
