"""The port's static step and chunk loop (mfvi_dip_mia_tpu_torch/tasks/
trainer.py: ``make_step``, ``prepare_fit``, the ``chunk_iters`` loop of
``fit``) on the CPU, where ``fit`` runs the step eagerly: the same step
function a fit on the card captures as a CUDA graph and replays. Held
against the JAX package's chunked ``fit`` in lockstep (64^2, 2-scale net,
jitter off, one fixed RT eps table: tests/test_torch_trainer.py's setup)."""

import numpy as np
import pytest
import torch

import mfvi_dip_mia_tpu.tasks.problems as JP
import mfvi_dip_mia_tpu.tasks.trainer as JT
import mfvi_dip_mia_tpu_torch.tasks.problems as TP
import mfvi_dip_mia_tpu_torch.tasks.runners as TR
import mfvi_dip_mia_tpu_torch.tasks.trainer as TT
from mfvi_dip_mia_tpu_torch.ops import kernels
from mfvi_dip_mia_tpu_torch.utils.device import device_cache

from test_torch_trainer import PRIORS, LR, SIZE, _lockstep, _patch_problems, \
    _psnr_tol

torch.set_num_threads(1)


def _logged(fn, *args, **kw):
    seen = []
    res = fn(*args, log_fn=lambda i, row: seen.append(i), **kw)
    return res, seen


def test_chunk_lockstep_against_jax(monkeypatch):
    """Five iterations in chunks of two (the last one short), metric rows
    every second iteration, snapshots at every chunk's start: rows (NaN
    where unset), snapshot stacks and the log_fn indices against JAX's."""
    prob_j, prob_t = _lockstep(monkeypatch, SIZE, jax_fused=False)("den")
    temp, sigma = PRIORS["den"]
    kw = dict(num_iter=4, lr=LR, seed=1, show_every=2, metrics_every=2)
    res_t, log_t = _logged(TT.fit, prob_t, TT.Method("mfvi", temp=temp,
                                                     sigma=sigma),
                           device="cpu", **kw)
    res_j, log_j = _logged(JT.fit, prob_j, JT.Method("mfvi", temp=temp,
                                                     sigma=sigma),
                           layout="auto", **kw)
    assert log_t == log_j == [1, 3, 4]
    for f in ("mse_corrupted", "mse_gt", "psnrs", "ssims"):
        got, ref = getattr(res_t, f), getattr(res_j, f)
        assert got.shape == ref.shape
        np.testing.assert_array_equal(np.isnan(got), np.isnan(ref), err_msg=f)
    set_rows = np.isfinite(res_t.psnrs[:, 0])
    np.testing.assert_array_equal(set_rows, [True, False, True, False, True])
    for i in np.where(set_rows)[0]:
        for col in range(3):
            assert abs(res_t.psnrs[i, col] - res_j.psnrs[i, col]) < \
                _psnr_tol(i), (i, col, res_t.psnrs[i], res_j.psnrs[i])
        # an MSE in dB, at the PSNR's tolerance
        for f in ("mse_corrupted", "mse_gt"):
            ratio = getattr(res_t, f)[i] / getattr(res_j, f)[i]
            assert abs(10 * np.log10(ratio)) < _psnr_tol(i), (f, i)
    np.testing.assert_allclose(res_t.ssims[set_rows], res_j.ssims[set_rows],
                               atol=1e-4)
    for f in ("recons", "uncerts_epi", "uncerts_ale"):
        got, ref = getattr(res_t, f), getattr(res_j, f)
        assert got.shape == ref.shape == (3, 1, SIZE, SIZE), f
        assert np.abs(got).max() > 0, f
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0, err_msg=f)
    assert res_t.replays == res_t.warmup_steps == 0


@pytest.fixture
def small(monkeypatch):
    _patch_problems(monkeypatch, SIZE)


def test_chunk_length_changes_only_when_the_host_reads(small):
    prob = TP.build_problem("ct", "mfvi", 0, device="cpu",
                            radon_mode="banded")
    kw = dict(num_iter=5, lr=LR, seed=2, show_every=2, metrics_every=1,
              device="cpu", collect_snapshots=False)
    method = TT.Method("mfvi", *PRIORS["ct"])
    a, log_a = _logged(TT.fit, prob, method, **kw)
    b, log_b = _logged(TT.fit, prob, method, chunk_iters=4, **kw)
    for f in ("mse_corrupted", "mse_gt", "psnrs", "ssims"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for k in a.params:
        np.testing.assert_array_equal(a.params[k], b.params[k])
    assert log_a == [1, 3, 5] and log_b == [3, 5]


def test_chunk_length_log_indices_and_error_match_jax(small):
    prob_j = JP.build_problem("den", "mfvi", 0, input_depth=16)
    prob_t = TP.build_problem("den", "mfvi", 0, device="cpu")
    method = dict(temp=PRIORS["den"][0], sigma=PRIORS["den"][1])
    kw = dict(num_iter=5, lr=LR, seed=2, show_every=2, metrics_every=3,
              chunk_iters=4)
    _, log_t = _logged(TT.fit, prob_t, TT.Method("mfvi", **method),
                       device="cpu", collect_snapshots=False, **kw)
    _, log_j = _logged(JT.fit, prob_j, JT.Method("mfvi", **method),
                       collect_snapshots=False, **kw)
    assert log_t == log_j == [3, 5]
    with pytest.raises(ValueError) as err_t:
        TT.fit(prob_t, TT.Method("mfvi", **method), device="cpu", **kw)
    with pytest.raises(ValueError) as err_j:
        JT.fit(prob_j, JT.Method("mfvi", **method), **kw)
    assert str(err_t.value) == str(err_j.value)


_HOST_READS = ("item", "cpu", "numpy", "tolist", "__bool__", "__int__",
               "__float__", "__index__")


@pytest.mark.parametrize("task,reparam,dtype", [
    ("den", "rt", "f32"), ("ct", "rt", "bf16"), ("den", "lrt", "f32")])
def test_the_step_reads_nothing_back_and_keeps_its_storage(
        small, monkeypatch, task, reparam, dtype):
    """A step makes none of the calls that bring a device tensor to the
    host (each would stall a CUDA graph's capture), and the state's tensors
    keep their storage from step to step (a replay writes the captured
    addresses)."""
    prob = TP.build_problem(task, "mfvi", 0, device="cpu",
                            radon_mode="banded")
    prep = TT.prepare_fit(prob, TT.Method("mfvi", *PRIORS[task]),
                          iterations=4, lr=LR, seed=3, device="cpu",
                          compute_dtype=dtype, reparam=reparam)
    ptrs = [t.data_ptr() for t in prep.state.tensors()]
    before = prep.state.clone()

    def refuse(name):
        def read(*args, **kw):
            raise AssertionError(f"the step called Tensor.{name}")
        return read

    with monkeypatch.context() as m:
        for name in _HOST_READS:
            m.setattr(torch.Tensor, name, refuse(name))
        for it in range(4):
            prep.step(prep.state, it % 2 == 0)
    s = prep.state
    assert [t.data_ptr() for t in s.tensors()] == ptrs
    assert s.it.tolist() == [4] and s.count.tolist() == 4
    assert not torch.equal(s.flat, before.flat)
    rows = s.rows.numpy()
    assert np.isfinite(rows[[0, 2]]).all() and np.isnan(rows[[1, 3]]).all()
    # the ring's first four slots hold the four iterations, the rest zero
    assert (s.ring_epi[:4].abs().sum(dim=1) > 0).all()
    assert not s.ring_epi[4:].any()


def test_the_step_seeds_the_ema_with_the_first_iterate(small):
    prob = TP.build_problem("den", "mfvi", 0, device="cpu")
    prep = TT.prepare_fit(prob, TT.Method("mfvi", *PRIORS["den"]),
                          iterations=2, lr=LR, seed=4, device="cpu")
    prep.state.out_avg.fill_(float("nan"))
    prep.step(prep.state, True)
    first = prep.state.out_avg.clone()
    assert torch.isfinite(first).all()
    np.testing.assert_array_equal(
        prep.state.ring_epi[0].reshape(SIZE, SIZE).numpy(),
        first[0, 0].clamp(0, 1).numpy())
    prep.step(prep.state, True)
    assert not torch.equal(prep.state.out_avg, first)


def test_fit_reports_no_replays_on_the_cpu(small):
    prob = TP.build_problem("den", "mfvi", 0, device="cpu")
    res = TT.fit(prob, TT.Method("mfvi", *PRIORS["den"]), num_iter=2, lr=LR,
                 seed=1, show_every=3, device="cpu", collect_snapshots=False)
    eager = TT.fit(prob, TT.Method("mfvi", *PRIORS["den"]), num_iter=2,
                   lr=LR, seed=1, show_every=3, device="cpu",
                   collect_snapshots=False, eager=True)
    assert res.replays == res.warmup_steps == 0 and res.executed == 3
    np.testing.assert_array_equal(res.psnrs, eager.psnrs)


@pytest.mark.parametrize("chunk_iters,save", [(4, False), (None, True)])
def test_run_task_passes_chunk_iters_to_fit(small, monkeypatch, tmp_path,
                                            chunk_iters, save):
    seen = {}
    fit = TR.fit

    def spy(problem, method, **kw):
        seen.update(kw)
        return fit(problem, method, **kw)

    monkeypatch.setattr(TR, "fit", spy)
    TR.run_den_mfvi(device="cpu", num_iter=2, lr=1e-3, seed=1, show_every=2,
                    plot=False, save=save, save_path=str(tmp_path),
                    chunk_iters=chunk_iters)
    assert seen["chunk_iters"] == chunk_iters
    assert seen["collect_snapshots"] == save


def test_run_task_refuses_a_chunk_other_than_the_snapshots(small, tmp_path):
    with pytest.raises(ValueError, match="chunk_iters must equal show_every"):
        TR.run_den_mfvi(device="cpu", num_iter=2, lr=1e-3, seed=1,
                        show_every=2, plot=False, save=True,
                        save_path=str(tmp_path), chunk_iters=4)


def test_a_capture_takes_its_counts_back_and_a_replay_adds_them(
        monkeypatch):
    # every launch on one capture stream (a CUDA tensor's current stream)
    monkeypatch.setattr(kernels.build, "stream_of", lambda t: 7)
    kernels.reset_launches()
    fwd, dw = kernels.cf_conv.FWD, kernels.cf_conv.DW
    fwd.launches = 3
    totals = kernels.counts()
    before = kernels.stream_counts(7)
    x = torch.zeros(1)
    fwd.count(x)
    fwd.count(x)
    dw.count(x)
    taken = kernels.take_counts_since(before, 7)
    assert kernels.counts() == totals
    assert dict(zip((k.name for k in kernels.KERNELS), taken)) == {
        k.name: {"cf_conv_fwd": 2, "cf_conv_dw": 1}.get(k.name, 0)
        for k in kernels.KERNELS}
    for _ in range(3):
        kernels.add_counts(taken)
    assert (fwd.launches, dw.launches) == (9, 3)
    kernels.reset_launches()


def test_device_cache_keeps_its_entries_readable():
    calls = []

    @device_cache
    def build(n, scale):
        calls.append(n)
        return torch.full((n,), scale)

    a = build(3, 2.0)
    assert build(3, 2.0) is a and calls == [3]
    build(4, 1.0)
    assert set(build.entries) == {(3, 2.0), (4, 1.0)}
    assert build.entries[(3, 2.0)] is a
    build.cache_clear()
    assert not build.entries
    build(3, 2.0)
    assert calls == [3, 4, 3]
