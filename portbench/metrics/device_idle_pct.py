"""device_idle_pct (%, device trace; layer: Device): the share of the traced
stretch's step replays, each from its first kernel's start to its last
kernel's end, in which none of the replay's kernels ran on the card. The
gaps between replays are left out: the profiler stretches the host's
``cudaGraphLaunch`` into them, where an untraced run is ahead of the card."""


def read(run):
    tr = run.trace
    got = tr.replay_idle() if tr is not None else None
    if got is None:
        return None
    idle, span = got
    return 100.0 * idle / span
