"""The port's tracing: utils/profiling.py's ``TRACER`` and ``Marks``, the
spans of tasks/trainer.py's ``fit`` and ``fit_interleaved`` (with the
interleaved fits' per-chunk hook), the step's region marks, and the
benchmark's readers of those spans (portbench/program.py,
portbench/metrics/{capture_s,step_*_ms}.py).

CPU tests drive small fits (2-scale net, 32 x 32). The tests named
``test_card_*`` need a card: they decide in a fixture and skip without
one. This file imports nothing of JAX, so on the card it runs alone:

    python -m pytest --noconftest -p no:cacheprovider -q \\
        tests/test_torch_tracing.py
"""

import statistics
import time

import numpy as np
import pytest
import torch

import mfvi_dip_mia_tpu_torch.tasks.data as TD
import mfvi_dip_mia_tpu_torch.tasks.problems as TP
import mfvi_dip_mia_tpu_torch.tasks.trainer as TT
from mfvi_dip_mia_tpu_torch.nn import build_skip_net
from mfvi_dip_mia_tpu_torch.utils import profiling
from mfvi_dip_mia_tpu_torch.utils.profiling import TRACER
from portbench import fits as PF
from portbench import harness as PH
from portbench import spec as PS
from portbench.trace import Trace

SIZE = 32
SMALL_NET = dict(pad="reflection", skip_n33d=[16, 32], skip_n33u=[16, 32],
                 skip_n11=4, num_scales=2, upsample_mode="bilinear")
LR = 1e-2
METHOD = TT.Method("mfvi", temp=1e-6, sigma=1e-2)
READERS = ("capture_s", "step_replay_ms", "step_draw_ms", "step_forward_ms",
           "step_backward_ms", "step_update_ms", "step_tail_ms")


@pytest.fixture
def small(monkeypatch):
    """The den problem at SIZE^2 on the 2-scale net, on the CPU, with a
    fresh ring of spans."""
    monkeypatch.setattr(TD, "get_image_denoising", lambda i: (
        TD.synthetic_xray(i, SIZE), (SIZE, SIZE)))
    monkeypatch.setattr(TP, "_standard_net", lambda n, m, dp, input_depth=16:
                        build_skip_net(input_depth, n_channels=n,
                                       **SMALL_NET))
    TRACER.reset()
    yield TP.build_problem("den", "mfvi", 0, device="cpu",
                           rng=np.random.default_rng(1))
    TRACER.reset()


def _fit(problem, **kw):
    args = dict(num_iter=29, lr=LR, seed=1, show_every=10, device="cpu",
                collect_snapshots=False)
    args.update(kw)
    return TT.fit(problem, METHOD, **args)


def _same_bits(a, b):
    for f in ("mse_corrupted", "mse_gt", "psnrs", "ssims"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert a.params.keys() == b.params.keys()
    for k, v in a.params.items():
        np.testing.assert_array_equal(b.params[k], v)


def test_fit_span_tree(small):
    res = _fit(small)
    (fit,) = TRACER.spans("fit")
    assert fit.parent is None and fit.end_ns >= fit.start_ns
    assert fit.attrs == dict(task="den", method="mfvi", temp=METHOD.temp,
                             sigma=METHOD.sigma, compute_dtype="f32",
                             device="cpu", seed=1, executed=30, replays=0)
    (prepare,) = TRACER.spans("prepare")
    chunks = TRACER.spans("chunk")
    assert prepare.parent is fit and all(c.parent is fit for c in chunks)
    # no capture on the CPU: prepare, then the chunks, in order, inside fit
    assert not TRACER.spans("capture")
    assert fit.start_ns <= prepare.start_ns <= prepare.end_ns \
        <= chunks[0].start_ns
    assert chunks[-1].end_ns <= fit.end_ns
    assert [(c.attrs["first"], c.attrs["last"]) for c in chunks] == \
        [(0, 9), (10, 19), (20, 29)]
    for a, b in zip(chunks, chunks[1:]):
        assert a.end_ns <= b.start_ns
    for c in chunks:
        at = c.attrs
        assert at["replays"] == 0 and at["clock"] == "host"
        assert at["marked"] == at["last"]
        assert at["device_ms"] > 0
        # the regions, then the encoder's share of forward and backward
        assert list(at["regions_ms"]) == list(TT.STEP_REGIONS) + list(
            TT.STEP_SUBREGIONS)
        assert all(v >= 0 for v in at["regions_ms"].values())
        # the last step's regions lie inside the chunk's steps
        assert sum(at["regions_ms"][r] for r in TT.STEP_REGIONS) \
            <= at["device_ms"]
    # FitResult's clocks are the spans'
    assert res.compile_seconds == pytest.approx(chunks[0].seconds)
    assert res.wall_seconds == pytest.approx(
        (chunks[-1].end_ns - chunks[0].start_ns) / 1e9)
    assert res.iters_per_sec == pytest.approx(
        20 / ((chunks[-1].end_ns - chunks[0].end_ns) / 1e9))


def _watch_step_marks(monkeypatch) -> list:
    """The (boundary, host ns) of every step mark recorded from now on."""
    seen = []
    mark = profiling.Marks.mark

    def watched(self, k):
        mark(self, k)
        if self.regions == TT.STEP_REGIONS:
            seen.append((k, self._ns[k]))

    monkeypatch.setattr(profiling.Marks, "mark", watched)
    return seen


def test_regions_in_order_in_each_eager_step(small, monkeypatch):
    seen = _watch_step_marks(monkeypatch)
    prep = TT.prepare_fit(small, METHOD, iterations=8, lr=LR, seed=1,
                          device="cpu")
    assert prep.marks.regions == TT.STEP_REGIONS
    for it in range(4):
        seen.clear()
        # outside ``_marking`` a step records no mark
        prep.step(prep.state, it % 2 == 0)
        assert seen == []
        with TT._marking():
            prep.step(prep.state, it % 2 == 0)
        assert [k for k, _ in seen] == list(range(len(TT.STEP_REGIONS) + 1))
        times = [t for _, t in seen]
        assert times == sorted(times)
        regions = prep.marks.read()
        assert list(regions) == list(TT.STEP_REGIONS)
        assert sum(regions.values()) == pytest.approx(
            (times[-1] - times[0]) / 1e6)


def test_net_grad_fires_once_after_deep_grad_and_before_backwards_end(
        small, monkeypatch):
    """The RT draw's leaves are one node's outputs (bayes/vi.py::_Draw),
    whose hooks fire as that node starts: a marked step records
    ``net_grad`` once, after ``deep_grad`` and before boundary 3, and a
    fit's chunks read ``backward_flat`` from it."""
    log = []
    point, mark = profiling.Marks.point, profiling.Marks.mark

    def logged_point(self, name):
        log.append(name)
        point(self, name)

    def logged_mark(self, k):
        log.append(k)
        mark(self, k)

    monkeypatch.setattr(profiling.Marks, "point", logged_point)
    monkeypatch.setattr(profiling.Marks, "mark", logged_mark)
    prep = TT.prepare_fit(small, METHOD, iterations=4, lr=LR, seed=1,
                          device="cpu")
    prep.step(prep.state, True)
    assert log == []
    with TT._marking():
        prep.step(prep.state, True)
    assert log.count("net_grad") == 1 and log.count("deep_grad") == 1
    assert log.index("deep_grad") < log.index("net_grad") < log.index(3)
    assert 0 <= prep.marks.between("net_grad", 3) \
        <= prep.marks.read()["backward"]
    _fit(small, num_iter=9, show_every=5)
    chunks = TRACER.spans("chunk")
    assert len(chunks) == 2
    assert all(c.attrs["regions_ms"]["backward_flat"] >= 0 for c in chunks)


@pytest.mark.parametrize("metrics_every,marked", [
    (1, [9, 19, 29]), (4, [8, 16, 28]), (25, [0, None, 25])])
def test_a_fit_marks_one_step_a_chunk(small, monkeypatch, metrics_every,
                                      marked):
    """The chunk's last metric iteration, and no other step, records the
    marks."""
    seen = _watch_step_marks(monkeypatch)
    _fit(small, metrics_every=metrics_every)
    chunks = TRACER.spans("chunk")
    assert [c.attrs["marked"] for c in chunks] == marked
    assert [k for k, _ in seen] == list(range(
        len(TT.STEP_REGIONS) + 1)) * sum(m is not None for m in marked)
    for c in chunks:
        assert ("regions_ms" in c.attrs) == (c.attrs["marked"] is not None)


def test_a_span_holds_the_ops_it_encloses_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile
    TRACER.reset()
    a, b = torch.randn(64, 64), torch.randn(64, 64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with TRACER.span("probe") as sp:
            torch.mm(a, b)
    events = prof.profiler.kineto_results.events()
    mm = [e for e in events if e.name() == "aten::mm"]
    assert mm
    for e in mm:
        assert sp.start_ns <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= sp.end_ns
    # the span is a host range in the profiler's own timeline
    assert [e.name() for e in events].count("probe") == 1
    assert TRACER.spans("probe") == [sp]
    TRACER.reset()


def test_tracing_off_keeps_nothing_and_changes_no_bit(small, monkeypatch):
    traced = _fit(small)
    assert TRACER.spans("chunk")
    TRACER.reset()
    monkeypatch.setattr(TRACER, "enabled", False)
    prep = TT.prepare_fit(small, METHOD, iterations=4, lr=LR, seed=1,
                          device="cpu")
    assert prep.marks is None
    untraced = _fit(small)
    assert TRACER.spans() == []
    _same_bits(traced, untraced)
    # the fit still times itself
    assert untraced.wall_seconds > 0 and untraced.iters_per_sec > 0


def test_the_ring_keeps_the_last_spans():
    tracer = profiling.Tracer(capacity=5)
    for k in range(12):
        with tracer.span("s", k=k):
            pass
    assert [s.attrs["k"] for s in tracer.spans()] == list(range(7, 12))
    assert tracer.spans("other") == []
    tracer.reset()
    assert tracer.spans() == []
    # a 100,000-iteration fit's 1,001 chunk spans fit many times over
    assert profiling.SPAN_RING >= 50 * 1001


def test_spans_nest_per_thread():
    import threading
    tracer = profiling.Tracer()
    inner = {}

    def work(name):
        with tracer.span("outer", who=name) as o:
            time.sleep(0.01)
            with tracer.span("inner", who=name) as i:
                inner[name] = (o, i)

    threads = [threading.Thread(target=work, args=(n,)) for n in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    for name, (o, i) in inner.items():
        assert i.parent is o and o.parent is None
        assert i.thread == o.thread
    assert inner["a"][0].thread != inner["b"][0].thread


# -- fit_interleaved's per-chunk hook ---------------------------------------

CANDS = [TT.Method("mfvi", temp=1e-6, sigma=1e-2),
         TT.Method("mfvi", temp=1e-1, sigma=1e-4)]
IKW = dict(num_iter=29, lr=LR, seed=1, show_every=10, device="cpu")


def test_interleaved_hook_changes_no_bit(small):
    plain = TT.fit_interleaved(small, CANDS, **IKW)
    calls = []
    hooked = TT.fit_interleaved(
        small, CANDS, log_fn=lambda j, i, row: calls.append(
            (j, i, np.array(row))), **IKW)
    assert [(j, i) for j, i, _ in calls] == [
        (j, i) for i in (9, 19, 29) for j in (0, 1)]
    for j, i, row in calls:
        res = hooked[j]
        np.testing.assert_array_equal(row, np.concatenate(
            [[res.mse_corrupted[i], res.mse_gt[i]], res.psnrs[i],
             res.ssims[i]]))
    for a, b in zip(plain, hooked):
        _same_bits(a, b)
    fits = [s for s in TRACER.spans("fit")][-2:]
    assert sorted(s.attrs["index"] for s in fits) == [0, 1]
    for f in fits:
        mine = [c for c in TRACER.spans("chunk") if c.parent is f]
        assert [(c.attrs["first"], c.attrs["last"]) for c in mine] == \
            [(0, 9), (10, 19), (20, 29)]
        assert all(c.attrs["index"] == f.attrs["index"] for c in mine)
        assert [p.parent for p in TRACER.spans("prepare")
                if p.attrs["index"] == f.attrs["index"]][-1] is f


def test_a_raising_interleaved_hook_ends_every_fit_at_its_chunk(small):
    calls = []

    def hook(j, i, row):
        calls.append((j, i))
        if (j, i) == (0, 19):
            raise KeyboardInterrupt("stop")

    with pytest.raises(KeyboardInterrupt):
        TT.fit_interleaved(small, CANDS, log_fn=hook, **IKW)
    assert calls == [(0, 9), (1, 9), (0, 19)]
    fits = TRACER.spans("fit")
    assert len(fits) == 2
    for f in fits:
        assert f.attrs["executed"] == 20 and f.end_ns is not None
    assert max(c.attrs["last"] for c in TRACER.spans("chunk")) == 19


# -- the benchmark's readers of the spans -----------------------------------

def _synthetic_run(monkeypatch, device="cuda", clock="device"):
    """A run of one candidate whose fit kept eight 100-iteration chunk
    spans (k = 0..7, each's device ms 600 + k, its draw region k); the
    candidate's chunk ends at perf_counter seconds 0..7, the window
    [1.5, 6.5]: its whole chunks end iterations 400-700 (k = 3..6)."""
    tracer = profiling.Tracer()
    monkeypatch.setattr(profiling, "TRACER", tracer)
    chunks = []
    with tracer.span("fit", temp=1e-6, sigma=1e-2):
        with tracer.span("capture"):
            time.sleep(0.002)
        for k in range(8):
            with tracer.span("chunk", first=100 * k, last=100 * k + 99,
                             replays=100, clock=clock,
                             device_ms=600.0 + k,
                             regions_ms=dict(zip(TT.STEP_REGIONS,
                                                 (k, 2, 2, 1, 0.5)))) as c:
                time.sleep(0.002)
            chunks.append(c)
    cand = PF.Candidate(0, 1e-6, 1e-2)
    cand.chunks = [(float(k), 100 * k + 100, 0.0) for k in range(8)]
    window = PF.Window(1, 5.0)
    window.w0 = 1.5
    run = PH.Run(None, 1, 5.0, 0.0, window, [cand], device)
    return run, chunks


def _read(run):
    return {name: PS.reader(name)(run) for name in READERS}


def test_readers_take_the_windows_chunks(monkeypatch):
    run, chunks = _synthetic_run(monkeypatch)
    got = _read(run)
    # k = 3..6: replays of 6.03-6.06 ms, draw 3-6 ms
    assert got["step_replay_ms"] == pytest.approx(6.045)
    assert got["step_draw_ms"] == pytest.approx(4.5)
    assert got["step_forward_ms"] == got["step_backward_ms"] == 2
    assert got["step_update_ms"] == 1 and got["step_tail_ms"] == 0.5
    (capture,) = profiling.TRACER.spans("capture")
    assert got["capture_s"] == capture.seconds > 0


def test_readers_leave_out_the_profilers_chunks(monkeypatch):
    run, chunks = _synthetic_run(monkeypatch)
    # the profiler ran inside chunk 4; its start reached back into chunk 3
    t0, t1 = chunks[4].start_ns + 1, chunks[4].end_ns - 1
    run.trace = Trace(t0, t1, [], [], 0)
    run.stretch = dict(counts0=[], start_s=(t0 - chunks[3].end_ns + 10) / 1e9,
                       stop_s=0.0)
    got = _read(run)
    assert got["step_replay_ms"] == pytest.approx(statistics.median(
        [6.05, 6.06]))
    assert got["step_draw_ms"] == pytest.approx(5.5)
    # a stretch whose end the run does not know: nothing to read
    run.trace = None
    assert _read(run)["step_replay_ms"] is None


def test_readers_give_none_on_the_cpu_and_without_spans(monkeypatch):
    run, _ = _synthetic_run(monkeypatch, device="cpu")
    assert set(_read(run).values()) == {None}
    run, _ = _synthetic_run(monkeypatch, clock="host")
    got = _read(run)
    assert got.pop("capture_s") > 0
    assert set(got.values()) == {None}
    run, _ = _synthetic_run(monkeypatch)
    monkeypatch.delattr(profiling, "TRACER")
    assert set(_read(run).values()) == {None}


def test_readers_are_declared_for_both_cells():
    import json
    import os
    root = os.path.dirname(PS.HERE)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = [w["name"] for w in bench["workloads"]]
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in READERS:
        assert entries[name]["source"] == "program_span"
        assert entries[name]["workloads"] == cells
        assert callable(PS.reader(name))


# -- on the card --------------------------------------------------------------

CARD_ITERS = 299


@pytest.fixture(scope="module")
def card_fits():
    """A 300-iteration den/MFVI f32 graph fit at 256^2, traced and not,
    with each capture's launches a replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    problem = TP.build_problem("den", "mfvi", 0, device="cuda",
                               rng=np.random.default_rng(1))
    capture_step = TT.capture_step
    launches = []

    def watched(*a, **k):
        graphs = capture_step(*a, **k)
        launches.append({wm: n for wm, (_, n) in graphs.items()})
        return graphs

    TT.capture_step = watched
    out = {}
    try:
        for enabled in (True, False):
            TRACER.enabled = enabled
            TRACER.reset()
            res = TT.fit(problem, METHOD, num_iter=CARD_ITERS, lr=1e-3,
                         seed=1, show_every=100, device="cuda",
                         collect_snapshots=False)
            out[enabled] = (res, TRACER.spans())
    finally:
        TRACER.enabled = True
        TT.capture_step = capture_step
        TRACER.reset()
    out["launches"] = launches
    return out


def test_card_graph_fit_changes_no_bit(card_fits):
    traced, untraced = card_fits[True][0], card_fits[False][0]
    assert traced.replays == untraced.replays == CARD_ITERS + 1
    _same_bits(traced, untraced)
    assert card_fits[False][1] == []


def test_card_captured_events_time_every_replay(card_fits):
    chunks = [s for s in card_fits[True][1] if s.name == "chunk"]
    assert len(chunks) == 3
    for c in chunks:
        assert c.attrs["clock"] == "device" and c.attrs["replays"] == 100
        assert c.attrs["marked"] == c.attrs["last"]
        assert c.attrs["device_ms"] > 0
        assert all(np.isfinite(v) and v > 0
                   for v in c.attrs["regions_ms"].values())
    names = {s.name for s in card_fits[True][1]}
    assert {"fit", "prepare", "capture", "lock_wait", "warmup",
            "graph", "chunk"} <= names


def test_card_regions_sum_to_the_replay(card_fits):
    c = [s for s in card_fits[True][1] if s.name == "chunk"][-1]
    per_replay = c.attrs["device_ms"] / c.attrs["replays"]
    assert sum(c.attrs["regions_ms"][r] for r in TT.STEP_REGIONS) == \
        pytest.approx(per_replay, rel=0.03)


def test_card_launches_a_replay_unchanged(card_fits):
    on, off = card_fits["launches"]
    # the marked graph launches what the metric variant does, and the
    # variants every other replay uses are the untraced fit's
    assert on.pop(TT.MARKED) == on[True]
    assert on == off and sum(on[True]) > 0
