"""The traced stretch's reduction and the window's rates, on made-up
timelines."""

import pytest

from portbench import fits
from portbench.trace import Op, Trace


def test_busy_idle_replays_and_gaps():
    # two replays (corr 7, 9) of 3 kernels, a copy, one cut replay (corr 11)
    ops = [Op("k", 100, 10, 7), Op("k", 110, 10, 7), Op("k", 130, 10, 7),
           Op("Memcpy DtoH", 150, 20, 8), Op("k", 200, 10, 9),
           Op("k", 205, 10, 9), Op("k", 220, 10, 9), Op("k", 280, 10, 11),
           Op("k", 290, 20, 11)]
    host = [("cudaGraphLaunch", 95, 3), ("cudaMemcpyAsync", 145, 60),
            ("cudaStreamSynchronize", 240, 80)]
    tr = Trace(100, 300, ops, host, 2)
    assert tr.window_s == pytest.approx(200e-9)
    # busy: [100,120] [130,140] [150,170] [200,215] [220,230] [280,300]
    assert tr.busy_s == pytest.approx((20 + 10 + 20 + 15 + 10 + 20) * 1e-9)
    assert tr.kernels_per_replay() == 3
    assert tr.replays() == pytest.approx(2 + 2 / 3)
    gaps = dict(tr.idle_gaps())
    # [120,130]: no call in flight; [140,150] and [170,200]: the copy's
    # call; [215,220]: none; [230,280]: the sync
    assert gaps["cudaMemcpyAsync"] == pytest.approx(40e-9)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(50e-9)
    assert gaps["host outside any CUDA call"] == pytest.approx(15e-9)
    top = tr.device_ops()
    assert top[0][0] == "k"
    # whole replays 7 ([100,140], idle [120,130]) and 9 ([200,230], idle
    # [215,220]); 11 is cut by the stretch's end
    assert tr.replay_idle() == (10 + 5, 40 + 30)


def test_candidate_rate_counts_whole_chunks_in_the_window():
    c = fits.Candidate(0, 1.0, 1.0)
    c.chunks = [(1.0, 101, 0.0), (2.0, 201, 0.5), (3.0, 301, 0.9),
                (4.5, 401, 1.2), (6.0, 501, 1.3)]
    # window [2, 5]: chunk ends 2.0, 3.0, 4.5 -> 200 iterations in 2.5 s
    assert c.rate(2.0, 5.0) == pytest.approx(200 / 2.5)
    assert c.rate(5.5, 9.0) is None
    assert c.chunks_in(2.0, 5.0) == [(1.0, pytest.approx(0.4)),
                                     (1.5, pytest.approx(0.3))]


def test_window_opens_when_every_candidate_is_ready():
    w = fits.Window(2, 0.0)
    a, b = fits.Candidate(0, 1, 1), fits.Candidate(1, 1, 1)
    la, lb = w.log_fn(a), w.log_fn(b)
    la(99, [0.0] * 8)
    assert w.w0 is None
    la(199, [0.0] * 8)          # before the window: runs on
    lb(99, [float("nan")] * 8)
    assert w.w0 is not None and b.nonfinite_chunks == 1
    with pytest.raises(fits.WindowClosed):
        la(299, [0.0] * 8)


@pytest.mark.parametrize("after, started_at", [(0.0, 1.5), (3.0, 4.5)])
def test_stretch_starts_after_its_delay(after, started_at):
    """The profiler starts at candidate 0's first chunk end more than
    ``trace_after_s`` after the window opens, and stops ``chunks`` chunk
    ends later; other candidates' chunk ends move nothing."""
    from portbench import harness

    class Prof:
        start_s = stop_s = 0.0
        started = stopped = None

        def start(self):
            Prof.started = t

        def stop(self):
            Prof.stopped = t

    window = fits.Window(2, 10.0)
    window.w0 = 1.0
    run = harness.Run(None, 1, 10.0, 0.0, window, [], "cpu")
    kernels = type("K", (), {"counts": staticmethod(lambda: [0])})
    st = harness.Stretch(run, 2, kernels, after)
    st.prof = Prof()
    c0, c1 = fits.Candidate(0, 1.0, 1.0), fits.Candidate(1, 1.0, 1.0)
    for t in (1.5, 3.0, 4.5, 6.0, 7.5, 9.0):
        c0.chunks.append((t, int(t * 100), 0.0))
        st.on_chunk(c1, t)
        st.on_chunk(c0, t)
    assert Prof.started == started_at
    assert Prof.stopped == started_at + 3.0 and st.done
