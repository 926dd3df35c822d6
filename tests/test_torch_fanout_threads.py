"""The port's thread fanout (mfvi_dip_mia_tpu_torch/parallel/fanout.py) and
the process-wide state its concurrent fits share, on the CPU.

* Each route starts a thread per candidate or group, as JAX's
  ``run_candidates`` does: a stub runner, group or split fit waits on a
  ``threading.Barrier`` of all of them, which would time out under one
  after another.
* With one stub runner the port's ``run_candidates`` returns JAX's (kept
  candidates, kept scores) in candidate order, NaN and crash drops alike.
* Real den fits (the 2-scale net at 64^2) on threads give the bits of the
  same runs one after another: scores, metric rows and parameters, on the
  per-candidate and the interleaved route. Every op of a CPU fit runs
  single-threaded here (``torch.set_num_threads(1)``), so no tolerance.
* The launch counters: a capture-style take-back returns exactly the
  launches on its stream (from any thread, as PyTorch's autograd thread
  launches a backward) and keeps the process totals exact while another
  thread counts on another stream. ``device_cache`` fills an entry once under a concurrent
  first use. The dw ticket buffers are one per stream, and a grown buffer
  is added beside the old one, which a graph may hold."""

import threading
import time

import numpy as np
import pytest
import torch

from mfvi_dip_mia_tpu.parallel import fanout as JF
import mfvi_dip_mia_tpu_torch.parallel.sharding as TS
import mfvi_dip_mia_tpu_torch.tasks.runners as TR
import mfvi_dip_mia_tpu_torch.tasks.trainer as TT
from mfvi_dip_mia_tpu_torch.ops import kernels
from mfvi_dip_mia_tpu_torch.ops.kernels import build, cf_conv
from mfvi_dip_mia_tpu_torch.parallel import fanout as TF
from mfvi_dip_mia_tpu_torch.utils.device import device_cache

from test_torch_trainer import _patch_problems

torch.set_num_threads(1)

BARRIER_S = 20              # a route that ran one after another times out
SIZE = 64
CANDS = [(1e-6, 1e-2), (1e-4, 1e-3), (1e-2, 1e-4), (1e-5, 1e-5)]
RUN_PARAMS = dict(img=0, num_iter=9, lr=1e-2, seed=1, show_every=5,
                  input_depth=8, plot=False, save=False)


def _meeting(n):
    """(a barrier of n parties, the set of thread ids that passed it)."""
    barrier, seen = threading.Barrier(n, timeout=BARRIER_S), set()

    def meet():
        barrier.wait()
        seen.add(threading.get_ident())
    return meet, seen


def _all_concurrent(seen, n):
    assert len(seen) == n and threading.get_ident() not in seen


def test_runner_route_runs_a_thread_per_candidate():
    meet, seen = _meeting(3)

    def runner(idx, dev, cand):
        meet()
        return 10.0 + idx

    failures = []
    kept_c, kept_y = TF.run_candidates("den", "mfvi", CANDS[:3], {},
                                       devices=["cpu"], runner=runner,
                                       failures=failures)
    assert failures == [] and kept_y == [10.0, 11.0, 12.0]
    assert kept_c == [tuple(c) for c in CANDS[:3]]
    _all_concurrent(seen, 3)


@pytest.mark.parametrize("bayes,interleave", [("mfvi", False),
                                              ("dip", "auto")])
def test_run_task_route_runs_a_thread_per_candidate(monkeypatch, bayes,
                                                    interleave):
    meet, seen = _meeting(3)

    def task_run(task, method, index=0, device=None, **kw):
        meet()
        return float(index)

    monkeypatch.setattr(TR, "run_task", task_run)
    cands = [()] * 3 if bayes == "dip" else CANDS[:3]
    _, kept_y = TF.run_candidates("den", bayes, cands, {}, devices=["cpu"],
                                  interleave=interleave)
    assert kept_y == [0.0, 1.0, 2.0]
    _all_concurrent(seen, 3)


def test_interleaved_route_runs_a_thread_per_group(monkeypatch):
    meet, seen = _meeting(2)
    groups = []

    def group(task, bayes, cands, device=None, **kw):
        groups.append((str(device), [c[0] for c in cands]))
        meet()
        return [c[1] for c in cands]

    monkeypatch.setattr(TR, "run_group_interleaved", group)
    kept_c, kept_y = TF.run_candidates("den", "mfvi", CANDS, {},
                                       devices=["cpu", "cpu:0"])
    assert sorted(groups) == [("cpu", [CANDS[0][0], CANDS[2][0]]),
                              ("cpu:0", [CANDS[1][0], CANDS[3][0]])]
    assert kept_y == [c[1] for c in CANDS]
    _all_concurrent(seen, 2)


def test_sp_route_runs_a_thread_per_candidate(monkeypatch):
    _patch_problems(monkeypatch, 32)
    meet, seen = _meeting(2)

    def split_fit(problem, method, *, mesh, **kw):
        meet()
        return TT.FitResult(*([None] * 11), final_psnr=method.temp)

    monkeypatch.setattr(TS, "fit_sp", split_fit)
    _, kept_y = TF.run_candidates("den", "mfvi", CANDS[:2],
                                  dict(RUN_PARAMS), devices=["cpu"] * 4,
                                  sp_split=2)
    assert kept_y == [CANDS[0][0], CANDS[1][0]]
    _all_concurrent(seen, 2)


def _stub(idx, dev, cand):
    """Deterministic in the candidate: index 1 crashes, 3 diverges."""
    if idx == 1:
        raise RuntimeError("stub crash")
    if idx == 3:
        return float("nan")
    time.sleep(0.01 * (len(CANDS) - idx))    # finish out of order
    return float(-np.log10(cand[0]) + cand[1])


@pytest.mark.parametrize("keep_nan", [False, True])
@pytest.mark.parametrize("n_dev", [1, 2])
def test_same_kept_lists_as_jax(keep_nan, n_dev):
    cands = CANDS + [(3e-3, 2e-2)]
    failures = []
    got = TF.run_candidates("den", "mfvi", cands, {}, devices=["cpu"] * n_dev,
                            runner=_stub, keep_nan=keep_nan,
                            failures=failures)
    want = JF.run_candidates("den", "mfvi", cands, {},
                             devices=["cpu"] * n_dev, runner=_stub,
                             keep_nan=keep_nan)
    np.testing.assert_array_equal(np.asarray(got[1]), np.asarray(want[1]))
    assert got[0] == want[0]
    assert [(f["index"], f["crashed"]) for f in failures] == [(1, True),
                                                              (3, False)]
    assert "stub crash" in failures[0]["error"]


def _recording(monkeypatch):
    """Record every FitResult the runners' fits return, by (temp, sigma)."""
    fits = {}
    fit, fit_interleaved = TR.fit, TR.fit_interleaved

    def one(problem, method, **kw):
        res = fit(problem, method, **kw)
        fits[(method.temp, method.sigma)] = res
        return res

    def several(problem, methods, **kw):
        results = fit_interleaved(problem, methods, **kw)
        for m, res in zip(methods, results):
            fits[(m.temp, m.sigma)] = res
        return results

    monkeypatch.setattr(TR, "fit", one)
    monkeypatch.setattr(TR, "fit_interleaved", several)
    return fits


def _same_fits(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for key, ref in want.items():
        res = got[key]
        for f in ("mse_corrupted", "mse_gt", "psnrs", "ssims"):
            np.testing.assert_array_equal(getattr(res, f), getattr(ref, f),
                                          err_msg=f"{key} {f}")
        for name, v in ref.params.items():
            np.testing.assert_array_equal(res.params[name], v, err_msg=name)
        assert res.final_psnr == ref.final_psnr


def test_real_fits_on_threads_equal_the_runs_alone(monkeypatch):
    """Two den/MFVI candidates through ``run_task``, and four in two
    interleaved groups, each route once one run after another in this
    thread and once through the fanout's threads."""
    _patch_problems(monkeypatch, SIZE)
    fits = _recording(monkeypatch)
    alone = [TR.run_task("den", "mfvi", index=i, device="cpu",
                         **TF.candidate_kwargs("mfvi", c), **RUN_PARAMS)
             for i, c in enumerate(CANDS[:2])]
    alone_fits = dict(fits)
    fits.clear()
    kept_c, kept_y = TF.run_candidates("den", "mfvi", CANDS[:2], RUN_PARAMS,
                                       devices=["cpu"], interleave=False)
    assert kept_y == alone and kept_c == [tuple(c) for c in CANDS[:2]]
    _same_fits(fits, alone_fits)

    fits.clear()
    groups = [TR.run_group_interleaved("den", "mfvi", CANDS[g::2],
                                       device="cpu", **RUN_PARAMS)
              for g in range(2)]
    alone_fits = dict(fits)
    fits.clear()
    _, kept_y = TF.run_candidates("den", "mfvi", CANDS, RUN_PARAMS,
                                  devices=["cpu", "cpu"])
    assert kept_y == [groups[i % 2][i // 2] for i in range(len(CANDS))]
    _same_fits(fits, alone_fits)


@pytest.mark.parametrize("other_on_capture_stream", [False, True])
def test_capture_take_back_keeps_totals_exact_beside_another_thread(
        monkeypatch, other_on_capture_stream):
    """A capture on stream 1 takes back exactly the launches on stream 1
    while another thread counts: on stream 2 (another fit's), which stay
    counted, or on stream 1 itself (PyTorch's autograd thread launching the
    capture's backward), which are the capture's."""
    main = threading.get_ident()
    other = 1 if other_on_capture_stream else 2
    monkeypatch.setattr(build, "stream_of", lambda t: (
        1 if threading.get_ident() == main else other))
    kernels.reset_launches()
    fwd, dw = cf_conv.FWD, cf_conv.DW
    x = torch.zeros(1)
    n_other, n_mine = 20000, 5000
    go = threading.Event()

    def launches():
        go.wait()
        for _ in range(n_other):
            fwd.count(x)

    t = threading.Thread(target=launches)
    t.start()
    before = kernels.stream_counts(1)
    go.set()
    for _ in range(n_mine):
        fwd.count(x)
        dw.count(x)
    t.join()
    taken = kernels.take_counts_since(before, 1)
    captured = n_mine + (n_other if other_on_capture_stream else 0)
    named = dict(zip((k.name for k in kernels.KERNELS), taken))
    assert named == {k.name: {fwd.name: captured, dw.name: n_mine}.get(
        k.name, 0) for k in kernels.KERNELS}
    assert (fwd.launches, dw.launches) == (n_other + n_mine - captured, 0)
    kernels.add_counts(taken)
    assert (fwd.launches, dw.launches) == (n_other + n_mine, n_mine)
    kernels.reset_launches()


def test_device_cache_fills_an_entry_once_under_concurrent_first_use():
    calls = []
    n = 8
    barrier = threading.Barrier(n, timeout=BARRIER_S)

    @device_cache
    def table(size):
        calls.append(size)
        time.sleep(0.05)
        return torch.arange(size)

    got = [None] * n

    def use(i):
        barrier.wait()
        got[i] = table(3 + i % 2)

    threads = [threading.Thread(target=use, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(calls) == [3, 4]
    assert all(got[i] is table.entries[(3 + i % 2,)] for i in range(n))


def test_ticket_buffers_are_per_stream_and_never_replaced(monkeypatch):
    """Two streams get two buffers; a larger request adds a buffer beside
    the one a graph may hold; a capture that finds none raises."""
    stream, capturing = [101], [False]
    monkeypatch.setattr(build, "stream_of_device", lambda device: stream[0])
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    monkeypatch.setattr(cf_conv, "_TICKETS", {})
    cpu = torch.device("cpu")
    a = cf_conv._tickets(cpu, 10)
    assert cf_conv._tickets(cpu, 4000) is a and not a.any()
    stream[0] = 202
    b = cf_conv._tickets(cpu, 10)
    assert b is not a
    c = cf_conv._tickets(cpu, 5000)
    assert c.numel() >= 5000 and cf_conv._TICKETS[(cpu, 202)] == [b, c]
    assert cf_conv._tickets(cpu, 10) is c
    stream[0], capturing[0] = 303, True
    with pytest.raises(RuntimeError, match="no warm-up made"):
        cf_conv._tickets(cpu, 10)
