"""step_mfu_pct (%, device trace; layer: Trainer): the step's model
operations per iteration (every conv site's forward, dx where needed and
dw, plus the CT operator's forward and adjoint; portbench/work/) times the
step replays of the traced stretch over its seconds, over the
configuration's tensor-core peak (portbench/work/peaks.py). The stretch is
the traced run's only time the profiler's stop (seconds of flushing) leaves
alone; it carries the profiler's own slowdown, which the stretch line
prints beside the untraced rate."""

from portbench.work import conv, peaks, radon


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    replays = tr.replays()
    if not replays:
        return None
    cfg = run.config
    flops = conv.flops_per_iteration(cfg, run.cell.reference())
    if cfg.get("task") == "ct":
        flops += radon.flops_per_iteration(cfg)
    rate = replays / tr.window_s
    return 100.0 * flops * rate / peaks.FLOPS[cfg["compute_dtype"]]
